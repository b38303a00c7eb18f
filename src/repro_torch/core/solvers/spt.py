"""Shortest-path tree (paper Problem 2, Lemma 3) — Dijkstra from the dummy root.

The SPT minimizes every ``R_i`` simultaneously: path lengths are measured in
``Φ`` (recreation cost).  Works for directed and undirected instances alike
(undirected instances simply have both edge directions revealed).

The relaxation runs on the flat :class:`~repro_torch.core.edge_arrays.EdgeArrays`
view: popping a vertex relaxes its whole CSR out-row with one masked array
op, pushing only the improved frontier entries onto the binary heap — the
per-edge Python loop of the dict-based implementation is gone.

``backend="torch"`` replaces the Python-heap loop with the whole-graph
Bellman-Ford relaxation of :mod:`.torch_backend` on ``device`` (same tree;
see that module for the equivalence argument).
"""

from __future__ import annotations

import heapq
from typing import Dict, Optional, Tuple

import numpy as np

from ..edge_arrays import EdgeArrays
from ..version_graph import StorageSolution, VersionGraph
from . import EPS, check_backend


def shortest_path_tree(
    g: VersionGraph, *, weight: str = "phi", backend: str = "torch",
    device: str = "cuda",
) -> StorageSolution:
    check_backend(backend)
    if backend == "torch":
        from . import torch_backend

        dist, parent = torch_backend.sssp(g.arrays(), weight=weight,
                                          device=device)
    else:
        dist, parent = dijkstra_arrays(g.arrays(), weight=weight)
    missing = [i for i in g.versions() if parent[i] < 0]
    if missing:
        raise ValueError(f"versions unreachable from root: {missing[:8]}")
    return StorageSolution(
        parent={i: int(parent[i]) for i in g.versions()}, graph=g
    )


def dijkstra_arrays(
    ea: EdgeArrays, *, weight: str = "phi", source: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Single-source shortest paths over the chosen cost component.

    Returns ``(dist, parent)`` arrays indexed by vertex id; unreachable
    vertices have ``dist == inf`` and ``parent == -1`` (the source keeps
    ``parent == -1`` too).
    """
    w = ea.phi if weight == "phi" else ea.delta
    nv = ea.n + 1
    dist = np.full(nv, np.inf, dtype=np.float64)
    parent = np.full(nv, -1, dtype=np.int64)
    done = np.zeros(nv, dtype=bool)
    dist[source] = 0.0
    pq: list = [(0.0, source)]
    while pq:
        d, u = heapq.heappop(pq)
        if done[u]:
            continue
        done[u] = True
        s, e = ea.out_range(u)
        if s == e:
            continue
        vs = ea.dst[s:e]
        nd = d + w[s:e]
        imp = ~done[vs] & (nd < dist[vs] - EPS)
        if imp.any():
            vi = vs[imp]
            ndi = nd[imp]
            dist[vi] = ndi
            parent[vi] = u
            for dv, vv in zip(ndi.tolist(), vi.tolist()):
                heapq.heappush(pq, (dv, vv))
    return dist, parent


def dijkstra(
    g: VersionGraph, *, weight: str = "phi", source: int = 0
) -> Tuple[Dict[int, float], Dict[int, int]]:
    """Dict-shaped compatibility wrapper around :func:`dijkstra_arrays`.

    Returns ``(dist, parent)``; ``parent`` excludes the source itself and
    ``dist`` omits unreachable vertices, exactly like the old implementation.
    """
    dist_a, parent_a = dijkstra_arrays(g.arrays(), weight=weight, source=source)
    dist = {
        v: float(dist_a[v]) for v in range(g.n + 1) if np.isfinite(dist_a[v])
    }
    parent = {v: int(parent_a[v]) for v in range(g.n + 1) if parent_a[v] >= 0}
    return dist, parent
