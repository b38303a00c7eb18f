"""LAST — balancing the MST and the SPT (paper §4.3, Algorithm 3).

Adapted from Khuller, Raghavachari & Young, "Balancing minimum spanning trees
and shortest-path trees" (Algorithmica '95).  Guarantees for undirected
Δ = Φ instances with parameter α > 1:

* every vertex: d_T(v) ≤ α · SP(v);
* total weight: W(T) ≤ (1 + 2/(α-1)) · W(MST).

As in the paper we also run it unchanged on directed instances, without the
guarantees.  The DFS relaxes along tree edges in both traversal directions
(the "back-edge" relaxation of the paper's Example 6); when a vertex exceeds
its α·SP budget the entire shortest path from the root is spliced in.

State (tentative distances, parents, SPT distances) lives in flat NumPy
arrays indexed by vertex id; edge costs come from the graph's
:class:`~repro_torch.core.edge_arrays.EdgeArrays` via point lookups.  The tour is
iterative, so deep MST chains never touch the recursion limit.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..version_graph import StorageSolution, VersionGraph
from .mst import minimum_storage_tree
from .spt import dijkstra_arrays


def last_tree(
    g: VersionGraph,
    alpha: float = 2.0,
    *,
    base: Optional[StorageSolution] = None,
) -> StorageSolution:
    if alpha <= 1.0:
        raise ValueError("alpha must exceed 1")
    base = base or minimum_storage_tree(g, backend="numpy")
    ea = g.arrays()
    sp_dist, sp_parent = dijkstra_arrays(ea, weight="phi")

    mst_children: List[List[int]] = [[] for _ in range(g.n + 1)]
    for i, p in base.parent.items():
        mst_children[p].append(i)

    parent = np.zeros(g.n + 1, dtype=np.int64)
    for i, p in base.parent.items():
        parent[i] = p
    d = np.full(g.n + 1, np.inf, dtype=np.float64)
    d[0] = 0.0

    def edge_phi(u: int, v: int) -> float:
        e = ea.lookup(u, v)
        assert e >= 0, (u, v)
        return float(ea.phi[e])

    def relax(u: int, v: int) -> None:
        w = edge_phi(u, v)
        if d[u] + w < d[v] - 1e-15:
            d[v] = d[u] + w
            parent[v] = u

    def splice_shortest_path(v: int) -> None:
        # walk the SPT path root→v and relax every edge along it
        path = [v]
        while path[-1] != 0:
            path.append(int(sp_parent[path[-1]]))
        for u, x in zip(path[::-1], path[::-1][1:]):
            relax(u, x)
        # after splicing, d[v] == sp_dist[v]

    # iterative DFS (Euler tour) over the MST with both-direction relaxation
    stack: List[tuple] = [(0, iter(mst_children[0]))]
    while stack:
        u, it = stack[-1]
        child = next(it, None)
        if child is None:
            stack.pop()
            if stack:
                pu = stack[-1][0]
                # returning edge child->parent: relax parent via child when
                # the reverse edge exists (undirected instances)
                if pu != 0 and ea.lookup(u, pu) >= 0:
                    relax(u, pu)
            continue
        v = child
        relax(u, v)
        if d[v] > alpha * sp_dist[v] + 1e-12:
            splice_shortest_path(v)
        stack.append((v, iter(mst_children[v])))

    sol = StorageSolution(
        parent={i: int(parent[i]) for i in g.versions()}, graph=g
    )
    return sol
