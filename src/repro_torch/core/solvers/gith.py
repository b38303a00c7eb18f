"""GitH — the Git `repack` heuristic (paper §4.4 and Appendix A).

* versions considered in non-increasing size (Δ_ii) order;
* sliding window of at most ``w`` candidate bases;
* depth bias: candidate base V_l is scored  Δ_{l,i} / (d_max − depth(V_l)),
  so shallow chains are preferred over slightly smaller deltas deep in a
  chain; bases at depth ≥ d_max are ineligible;
* a version with no eligible base in the window (or whose best delta is not
  smaller than materializing) is materialized at depth 0;
* window reshuffle (Appendix A step 3): the chosen base moves to the *end*
  of the window, the new version is appended, and the front is dropped to
  keep the window at ``w``.

The per-version window scan is one batched ``lookup_many`` + masked argmin
over the window's candidate edges (ineligible slots scored ``inf``; argmin's
first-minimum tie-break matches the sequential strict-`<` scan); sizes and
depths live in flat arrays.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..version_graph import StorageSolution, VersionGraph


def git_heuristic(
    g: VersionGraph,
    *,
    window: int = 10,
    max_depth: int = 50,
) -> StorageSolution:
    ea = g.arrays()
    n = g.n
    vs = np.arange(1, n + 1, dtype=np.int64)
    mat = ea.lookup_many(np.zeros(n + 1, dtype=np.int64)[1:], vs)
    if (mat < 0).any():
        missing = int(vs[mat < 0][0])
        raise ValueError(f"GitH needs Δ_ii for every version (missing {missing})")
    sizes = np.zeros(n + 1, dtype=np.float64)
    sizes[1:] = ea.delta[mat]
    # non-increasing size, ties by ascending id (lexsort: last key primary)
    order = np.lexsort((vs, -sizes[1:]))
    order = vs[order]

    parent: Dict[int, int] = {}
    depth = np.zeros(n + 1, dtype=np.int64)
    win: List[int] = []

    for vi in order.tolist():
        best_base = None
        if win:
            warr = np.asarray(win, dtype=np.int64)
            eid = ea.lookup_many(warr, np.full(warr.shape, vi, dtype=np.int64))
            elig = (
                (eid >= 0)
                & (depth[warr] < max_depth)
                & (np.where(eid >= 0, ea.delta[np.maximum(eid, 0)], np.inf)
                   < sizes[vi])
            )
            if elig.any():
                score = np.full(warr.shape, np.inf, dtype=np.float64)
                score[elig] = (
                    ea.delta[eid[elig]]
                    / (max_depth - depth[warr[elig]]).astype(np.float64)
                )
                best_base = int(warr[int(np.argmin(score))])
        if best_base is None:
            parent[vi] = 0
            depth[vi] = 0
            win.append(vi)
        else:
            parent[vi] = best_base
            depth[vi] = depth[best_base] + 1
            # move the chosen base to the end of the window
            win.remove(best_base)
            win.append(vi)
            win.append(best_base)
        while len(win) > window:
            win.pop(0)

    return StorageSolution(parent=parent, graph=g)
