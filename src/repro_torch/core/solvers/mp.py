"""MP — Modified Prim's algorithm (paper §4.2, Algorithm 2).

Targets the *max* recreation objective: Problem 6 (min C s.t. max_i R_i ≤ θ)
directly, Problem 4 (min max R_i s.t. C ≤ β) by bisecting θ.

Faithful details:
* priority queue keyed by the marginal storage cost l(V_i);
* when a dequeued vertex's edges are scanned, neighbours *already in the
  tree* may be re-parented if that lowers their storage cost without raising
  their recreation cost (the non-standard relaxation of Algorithm 2,
  lines 10–17);
* neighbours outside the tree are relaxed only if the recreation cost through
  V_i stays within θ (lines 19–24).

The frontier relaxation (the hot path) runs as one masked array op over the
dequeued vertex's CSR out-row; the rare in-tree re-parenting keeps its
sequential scan because each acceptance must consult the ancestor chain
built so far.  State lives in flat ``l`` / ``d`` / ``p`` arrays.
"""

from __future__ import annotations

import heapq
from typing import Dict, Optional

import numpy as np

from ..version_graph import StorageSolution, VersionGraph
from . import CONSTRAINT_TOL, EPS, check_backend
from .mst import minimum_storage_tree
from .spt import dijkstra


class InfeasibleError(ValueError):
    pass


def _is_ancestor(p: np.ndarray, anc: int, node: int) -> bool:
    """True if ``anc`` lies on ``node``'s current parent chain."""
    x = node
    while x != 0:
        if x == anc:
            return True
        px = int(p[x])
        if px < 0:  # unset parent — chain ends
            return False
        x = px
    return False


def modified_prim(
    g: VersionGraph, theta: float, *, backend: str = "torch",
    device: str = "cuda",
) -> StorageSolution:
    """Problem 6: min total storage subject to max_i R_i ≤ theta.

    ``backend="torch"`` runs the main loop on ``device``
    (:func:`repro_torch.core.solvers.torch_backend.modified_prim_core`) whose f32
    state selects the structure; the exact f64 ``l``/``d`` are rebuilt from
    that structure below, and any vertex whose exact recreation cost lands
    above θ (a borderline f32 acceptance) is repaired through the same SPT
    splice that serves unreached versions — shared by both backends.
    """
    check_backend(backend)
    if backend == "torch":
        from . import torch_backend

        p, in_tree = torch_backend.modified_prim_core(
            g.arrays(), theta, device=device
        )
        l, d = _tree_costs_f64(g, p, in_tree)
        over = np.asarray(
            [i for i in g.versions()
             if in_tree[i] and d[i] > theta + CONSTRAINT_TOL],
            dtype=np.int64,
        )
        if over.shape[0]:
            in_tree[over] = False  # re-routed by the SPT splice below
    else:
        l, d, p, in_tree = _mp_core_numpy(g, theta)
    missing = [i for i in g.versions() if not in_tree[i]]
    if missing:
        _splice_spt_paths(g, theta, missing, d, l, p, in_tree)
    sol = StorageSolution(
        parent={i: int(p[i]) for i in g.versions()}, graph=g
    )
    return sol


def _tree_costs_f64(g: VersionGraph, p, in_tree):
    """Exact ``(l, d)`` state for the parent structure ``p``.

    The device MP loop keeps its state in f32; everything downstream (the
    SPT splice comparisons, the θ re-check) must run on exact f64 costs, so
    they are rebuilt here from the selected tree and the f64 edge arrays.
    """
    nv = g.n + 1
    l = np.full(nv, np.inf, dtype=np.float64)
    d = np.full(nv, np.inf, dtype=np.float64)
    l[0] = d[0] = 0.0
    kids = [[] for _ in range(nv)]
    for v in range(1, nv):
        if in_tree[v] and p[v] >= 0:
            kids[int(p[v])].append(v)
    stack = [0]
    while stack:
        u = stack.pop()
        du = float(d[u])
        for v in kids[u]:
            c = g.materialization_cost(v) if u == 0 else g.cost(u, v)
            d[v] = du + c.phi
            l[v] = c.delta
            stack.append(v)
    return l, d


def _mp_core_numpy(g: VersionGraph, theta: float):
    """The heap-driven MP main loop; returns ``(l, d, p, in_tree)``."""
    ea = g.arrays()
    nv = g.n + 1
    l = np.full(nv, np.inf, dtype=np.float64)
    d = np.full(nv, np.inf, dtype=np.float64)
    p = np.full(nv, -1, dtype=np.int64)
    l[0] = d[0] = 0.0
    in_tree = np.zeros(nv, dtype=bool)
    pq = [(0.0, 0)]
    while pq:
        li, vi = heapq.heappop(pq)
        if in_tree[vi] or li > l[vi] + EPS:
            continue  # stale entry
        in_tree[vi] = True
        s, e = ea.out_range(vi)
        if s == e:
            continue
        vs = ea.dst[s:e]
        dts = ea.delta[s:e]
        phs = ea.phi[s:e]
        it = in_tree[vs]
        if it.any():
            # relaxation of in-tree nodes (lines 10-17): sequential, because
            # each acceptance rewires the ancestor chain consulted next
            dvi = float(d[vi])
            for k in np.nonzero(it)[0].tolist():
                vj = int(vs[k])
                cphi = float(phs[k])
                cdel = float(dts[k])
                if cphi + dvi <= d[vj] + EPS and cdel <= l[vj] - EPS:
                    if _is_ancestor(p, vj, vi):
                        continue  # re-parenting under a descendant would cycle
                    p[vj] = vi
                    d[vj] = cphi + dvi
                    l[vj] = cdel
        # standard frontier relaxation under the θ constraint — one masked op
        imp = ~it & (phs + d[vi] <= theta + CONSTRAINT_TOL) & (dts < l[vs] - EPS)
        if imp.any():
            vj = vs[imp]
            d[vj] = phs[imp] + d[vi]
            l[vj] = dts[imp]
            p[vj] = vi
            for lv, vv in zip(l[vj].tolist(), vj.tolist()):
                heapq.heappush(pq, (lv, vv))
    return l, d, p, in_tree


def _splice_spt_paths(g, theta, missing, d, l, p, in_tree) -> None:
    # The greedy dequeue order (by storage) can strand a version even at a
    # feasible θ, because d() along the partially-built tree may overshoot
    # where the SPT path would not.  Problem 6 is feasible iff
    # θ ≥ max_i SPT(i) (the SPT minimizes every R_i), so splice SPT paths:
    # each splice sets d to the SPT distance — never an increase for any
    # already-reached node — hence the θ invariant is preserved.
    dist, sp_parent = dijkstra(g, weight="phi")
    bad = [i for i in missing if dist.get(i, float("inf")) > theta + CONSTRAINT_TOL]
    if bad:
        raise InfeasibleError(
            f"theta={theta} infeasible: versions {bad[:5]} have SPT "
            f"recreation above the bound"
        )
    for v in missing:
        # full SPT path root→v, relaxed front to back: the running cost is
        # ≤ the SPT distance at every node (induction on path prefixes).
        path = [v]
        while path[-1] != 0:
            path.append(sp_parent[path[-1]])
        path.reverse()
        for u, x in zip(path, path[1:]):
            c = g.materialization_cost(x) if u == 0 else g.cost(u, x)
            cand = float(d[u]) + c.phi
            if not in_tree[x] or cand < d[x] - EPS:
                p[x] = u
                d[x] = cand
                l[x] = c.delta
                in_tree[x] = True


def min_max_recreation_under_budget(
    g: VersionGraph,
    budget: float,
    *,
    tol: float = 1e-3,
    max_iters: int = 48,
    backend: str = "torch",
    device: str = "cuda",
) -> StorageSolution:
    """Problem 4: min max_i R_i subject to C ≤ budget — bisection on θ fed to
    `modified_prim` (the paper notes "the solution for Problem 4 is similar").
    """
    dist, _ = dijkstra(g, weight="phi")
    lo = max(dist[i] for i in g.versions())  # SPT bound: best achievable max R
    base = minimum_storage_tree(g, backend=backend, device=device)
    if base.storage_cost() > budget + 1e-9:
        raise InfeasibleError("budget below minimum storage cost")
    hi = base.max_recreation()
    best: Optional[StorageSolution] = None
    # check the ideal point first
    try:
        sol = modified_prim(g, lo * (1 + 1e-12), backend=backend,
                            device=device)
        if sol.storage_cost() <= budget + 1e-9:
            return sol
    except InfeasibleError:
        pass
    for _ in range(max_iters):
        mid = 0.5 * (lo + hi)
        try:
            sol = modified_prim(g, mid, backend=backend, device=device)
            feasible = sol.storage_cost() <= budget + 1e-9
        except InfeasibleError:
            feasible = False
        if feasible:
            best, hi = sol, mid
        else:
            lo = mid
        if hi - lo <= tol * max(1.0, lo):
            break
    if best is None:
        best = base  # MST/MCA always fits the budget
    return best
