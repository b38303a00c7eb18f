"""Minimum spanning structures (paper Problem 1, Lemma 2).

* Undirected instances: Prim's algorithm — binary heap over vertices, with
  each dequeued vertex's whole CSR out-row relaxed in one masked array op.
* Directed instances: Edmonds' optimum branching / minimum-cost arborescence
  (MCA), iterative cycle-contraction with a **mergeable-heap** in-edge
  structure (:class:`repro_torch.core.solvers.meldable_heap.RunHeap`): each
  vertex's in-edges live in a heap of sorted runs, cycle contraction is
  "meld the members' heaps + one vectorized additive offset over the live
  items" instead of concatenating and rescanning arrays, and supernode
  self-loops are purged with a vectorized union-find gather on an amortized
  doubling schedule.  Total work is O(E log V) with near-linear constants
  on chain-like instances.

Weights are the ``Δ`` components (storage bytes).  Cheapest-in-edge ties
break to the lowest edge id, matching the dict-based seed implementation
bit-for-bit; tests cross-check the MCA against the seed oracle on the
56-instance property suite plus dense two-cycle adversarial instances.

``backend="torch"`` runs the undirected case as one device Prim loop
(:func:`repro_torch.core.solvers.torch_backend.prim`, same tree).  Directed
instances always use the host mergeable-heap Edmonds — cycle contraction is
pointer-chasing with data-dependent shapes, unsuited to a device loop.
"""

from __future__ import annotations

import heapq
from bisect import bisect_right
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..edge_arrays import EdgeArrays
from ..version_graph import StorageSolution, VersionGraph
from . import check_backend
from .meldable_heap import RunHeap


def minimum_storage_tree(
    g: VersionGraph, *, backend: str = "torch", device: str = "cuda"
) -> StorageSolution:
    """Solve Problem 1: min total storage, any finite recreation."""
    check_backend(backend)
    if g.directed:
        parent = _edmonds_mca(g)
    elif backend == "torch":
        parent = _prim_torch(g, device=device)
    else:
        parent = _prim(g)
    return StorageSolution(parent=parent, graph=g)


# ------------------------------------------------------------------- Prim MST
def _prim_torch(g: VersionGraph, *, device: str) -> Dict[int, int]:
    from . import torch_backend

    bp = torch_backend.prim(g.arrays(), device=device)
    missing = [i for i in g.versions() if bp[i] < 0]
    if missing:
        raise ValueError(f"graph disconnected; unreachable: {missing[:8]}")
    return {i: int(bp[i]) for i in g.versions()}


def _prim(g: VersionGraph) -> Dict[int, int]:
    ea = g.arrays()
    nv = ea.n + 1
    parent = np.full(nv, -1, dtype=np.int64)
    best = np.full(nv, np.inf, dtype=np.float64)
    in_tree = np.zeros(nv, dtype=bool)
    best[0] = 0.0
    pq: List[Tuple[float, int, int]] = [(0.0, 0, 0)]  # (w, vertex, parent)
    while pq:
        w, u, p = heapq.heappop(pq)
        if in_tree[u]:
            continue
        in_tree[u] = True
        if u != 0:
            parent[u] = p
        s, e = ea.out_range(u)
        if s == e:
            continue
        vs = ea.dst[s:e]
        ws = ea.delta[s:e]
        imp = ~in_tree[vs] & (ws < best[vs])
        if imp.any():
            vi = vs[imp]
            wi = ws[imp]
            best[vi] = wi
            for wv, vv in zip(wi.tolist(), vi.tolist()):
                heapq.heappush(pq, (wv, vv, u))
    missing = [i for i in g.versions() if parent[i] < 0]
    if missing:
        raise ValueError(f"graph disconnected; unreachable: {missing[:8]}")
    return {i: int(parent[i]) for i in g.versions()}


# ------------------------------------- Edmonds (mergeable-heap contraction)
def _edmonds_mca(g: VersionGraph) -> Dict[int, int]:
    eids = _edmonds_arrays(g.arrays(), root=0)
    ea = g.arrays()
    parent = dict(zip(ea.dst[eids].tolist(), ea.src[eids].tolist()))
    if len(parent) != ea.n:
        missing = [i for i in g.versions() if i not in parent]
        raise ValueError(f"no arborescence: unreachable {missing[:8]}")
    return parent


def _edmonds_arrays(ea: EdgeArrays, root: int = 0) -> np.ndarray:
    """Edge ids (into ``ea``) of the min-cost arborescence rooted at ``root``.

    Gabow-style cycle contraction over mergeable heaps: each group's
    in-edges live in a :class:`RunHeap` (a binary-counter list of sorted
    runs).  Contracting a cycle is, per member, one ``add_offset(-cost)``
    for the reduced-cost update (eager, vectorized over the member's live
    items — eagerness keeps the float-op order identical to the seed's
    sequential subtractions) plus one amortized-O(1) ``meld`` — no
    concatenation or rescan of edge arrays.  Components are tracked in a
    union-find; supernode self-loops are trimmed from the heap top with a
    vectorized representative gather (``drop_while``) and bulk-purged on a
    doubling schedule (``maybe_compact``) so offsets never pay for a long
    dead tail; a discarded edge never has to be looked at again because
    components only ever coarsen.

    Cheapest-in-edge ties break to the lowest edge id — runs are built from
    one stable ``(dst, weight)`` lexsort, so equal-weight edges surface in
    ascending id order — matching a sequential strict-`<` scan; results are
    bit-identical to the recursive seed formulation on the property suite.

    The expansion phase walks the contraction forest: each frame re-routes
    its supernode's chosen entering edge to the member it actually points
    at, then adopts the remaining members' cycle edges.
    """
    keep = (ea.dst != root) & (ea.src != ea.dst)
    eids = np.nonzero(keep)[0].astype(np.int64)
    u = ea.src[eids]
    v = ea.dst[eids]
    w0 = ea.delta[eids].astype(np.float64)

    n_base = ea.n + 1                       # vertex ids 0..n
    cap = 2 * n_base + 2                    # ≤ one supernode per contraction
    dsu = np.arange(cap, dtype=np.int64)

    def find(x: int) -> int:
        while dsu[x] != x:
            dsu[x] = dsu[dsu[x]]
            x = int(dsu[x])
        return x

    def reps_of(nodes: np.ndarray) -> np.ndarray:
        """Representative lookup; vectorized gather-to-fixpoint when wide."""
        if nodes.shape[0] <= 16:
            # the gather loop's fixpoint test costs several ufunc dispatches;
            # for the short batches drop_while probes with, scalar path-halving
            # finds win by ~3x
            return np.array([find(x) for x in nodes.tolist()], dtype=np.int64)
        t = dsu[nodes]
        while True:
            t2 = dsu[t]
            if (t2 == t).all():
                break
            t = t2
        dsu[nodes] = t  # path compression for later gathers
        return t

    # one global stable (dst, weight) sort: per-vertex runs are ascending by
    # (w, local id) — and ascending local id is ascending global edge id
    order = np.lexsort((w0, v))
    ptr = np.searchsorted(v[order], np.arange(n_base + 1, dtype=np.int64))

    empty = np.nonzero((ptr[1:] == ptr[:-1]) & (np.arange(n_base) != root))[0]
    if empty.shape[0]:
        raise ValueError(f"vertex {int(empty[0])} unreachable from root")
    # no self-loops exist before the first contraction, so each vertex's run
    # head is already its min-(w, id) in-edge; bulk-convert heads to Python
    # scalars once instead of per-vertex int()/float() round-trips
    head_sl = order[ptr[:-1] % order.shape[0]]
    head_eid = head_sl.tolist()
    head_w = w0[head_sl].tolist()
    ptr_l = ptr.tolist()
    heaps: Dict[int, RunHeap] = {}
    min_edge: Dict[int, int] = {}
    min_cost: Dict[int, float] = {}
    for x in range(n_base):
        if x == root:
            continue
        sl = order[ptr_l[x]:ptr_l[x + 1]]
        heaps[x] = RunHeap.from_sorted(w0[sl], sl)
        min_edge[x] = head_eid[x]
        min_cost[x] = head_w[x]

    one_true = np.ones(1, dtype=bool)
    one_false = np.zeros(1, dtype=bool)

    def choose_min(gr: int) -> None:
        """Min-(w, id) in-edge of supernode ``gr``; drops self-loops lazily."""
        h = heaps[gr]

        def dead(ids: np.ndarray) -> np.ndarray:
            # head probes are single-edge: scalar find beats the vectorized
            # gather-to-fixpoint by ~10x there
            if ids.shape[0] == 1:
                return one_true if find(int(u[ids[0]])) == gr else one_false
            return reps_of(u[ids]) == gr

        # amortized purge keeps offsets touching live in-edges only (the
        # seed compacts on every choose; doubling keeps dense heaps cheap)
        h.maybe_compact(dead)
        h.drop_while(dead)
        if not h:
            raise ValueError(f"vertex {gr} unreachable from root")
        wt, cands = h.min_tied_ids()
        if cands.shape[0] > 1:
            # lowest edge id among the live tied candidates (the tie block
            # can hide dead self-loops and, after rounding collapses two
            # distinct reduced weights, ids out of order — filter + min
            # reproduces the seed's full rescan semantics)
            cands = cands[reps_of(u[cands]) != gr]
        min_edge[gr] = int(cands.min())
        min_cost[gr] = wt

    frames: List[Tuple[int, List[int], Dict[int, int]]] = []
    next_node = n_base
    u_l = u.tolist()  # walk steps index one tail at a time; lists beat ndarray

    # cycle hunt over the min-in functional graph, ascending starts; each
    # contraction resumes the walk from the fresh supernode
    color = np.zeros(cap, dtype=np.int8)  # 0=white 1=on path 2=done
    on_path: Dict[int, int] = {}          # node -> index in `path`
    starts: List[int] = [x for x in range(n_base) if x != root]
    si = 0
    while si < len(starts):
        start = starts[si]
        si += 1
        if find(start) != start or color[start] == 2:
            continue
        path: List[int] = []
        on_path.clear()
        x = start
        while True:
            if x == root or color[x] == 2:
                for p in path:
                    color[p] = 2
                break
            if color[x] == 1:
                ci = on_path[x]
                members = path[ci:]
                del path[ci:]
                s = next_node
                next_node += 1
                frames.append((s, members, {m: min_edge[m] for m in members}))
                acc: Optional[RunHeap] = None
                for m in members:
                    h = heaps.pop(m)
                    h.add_offset(-min_cost[m])  # reduced costs, O(1)
                    acc = h if acc is None else acc.meld(h)
                    del min_edge[m]
                    del min_cost[m]
                    del on_path[m]
                    dsu[m] = s
                heaps[s] = acc  # type: ignore[assignment]
                choose_min(s)
                x = s  # resume the walk from the contracted node
                continue
            color[x] = 1
            on_path[x] = len(path)
            path.append(x)
            x = find(u_l[min_edge[x]])

    # -------------------------------------------------------------- expansion
    # Preorder leaf numbering of the contraction forest: each frame's entry
    # edge points at a *base* vertex, and the member whose subtree contains
    # it is one bisect over the members' (preorder-ascending) tins — an
    # ancestor walk instead goes quadratic under deep contraction nesting.
    children: Dict[int, List[int]] = {s: members for s, members, _ in frames}
    has_parent = bytearray(next_node)
    for _, members, _ in frames:
        for m in members:
            has_parent[m] = 1
    tin = [0] * next_node
    timer = 0
    stack: List[int] = []
    for nd in range(next_node):
        if has_parent[nd]:
            continue
        stack.append(nd)
        while stack:
            cur = stack.pop()
            tin[cur] = timer
            kids = children.get(cur)
            if kids is None:
                timer += 1  # base vertices are the leaves
            else:
                stack.extend(reversed(kids))

    # entry_edge: group -> chosen in-edge; start from the surviving groups
    entry_edge: Dict[int, int] = dict(min_edge)
    for s, members, min_map in reversed(frames):
        e = entry_edge.pop(s)
        # the member the entering edge actually points at
        x = members[bisect_right([tin[m] for m in members], tin[int(v[e])]) - 1]
        entry_edge[x] = e
        for m in members:
            if m != x:
                entry_edge[m] = min_map[m]
    return eids[np.asarray(sorted(entry_edge.values()), dtype=np.int64)]
