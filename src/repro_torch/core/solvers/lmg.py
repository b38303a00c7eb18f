"""LMG — Local Move Greedy (paper §4.1, Algorithm 1).

Targets the *average/sum* recreation objective under a storage budget
(Problem 3); Problem 5 is solved by binary search over the budget
(`minimize_storage_sum_recreation`).

Starts from the minimum-storage tree (MST undirected / MCA directed) and
greedily swaps in shortest-path-tree edges maximizing

    ρ = (reduction in Σ recreation cost) / (increase in storage cost)

Vectorized implementation
-------------------------
Every round scores the whole candidate set ξ with masked array ops instead
of a per-edge Python loop:

* candidate edges live in flat ``(u, v, Δ, Φ)`` arrays sorted by ``(u, v)``;
* the cycle test ("is ``u`` inside ``v``'s subtree?") is an Euler-tour
  interval containment check — the current tree's preorder is kept as an
  ``order`` array with per-vertex ``tin`` positions and subtree ``size``s,
  so the whole candidate set is filtered with two compares;
* applying a swap splices the moved subtree's contiguous preorder block to
  just after its new parent (one ``concatenate`` + one scatter), shifts the
  subtree's recreation costs with one fancy-indexed add, and walks only the
  two ancestor chains to fix subtree masses/sizes.

Ties in ρ resolve to the smallest ``(u, v)`` candidate (argmax returns the
first maximum over the sorted candidate arrays), which matches a sequential
strict-`>` scan in sorted order.  All traversals are iterative — no
``sys.setrecursionlimit`` games on deep chains.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..version_graph import StorageSolution, VersionGraph
from . import CONSTRAINT_TOL, check_backend
from .mst import minimum_storage_tree
from .spt import shortest_path_tree


def _preorder(children: List[List[int]], n: int) -> np.ndarray:
    """Iterative preorder over vertices 0..n visiting children ascending."""
    order = np.empty(n + 1, dtype=np.int64)
    stack = [0]
    k = 0
    while stack:
        x = stack.pop()
        order[k] = x
        k += 1
        stack.extend(reversed(children[x]))
    assert k == n + 1, "storage tree does not span all versions"
    return order


def local_move_greedy(
    g: VersionGraph,
    budget: float,
    *,
    weights: Optional[Dict[int, float]] = None,
    base: Optional[StorageSolution] = None,
    spt: Optional[StorageSolution] = None,
    backend: str = "torch",
    device: str = "cuda",
) -> StorageSolution:
    """Problem 3: min Σ_i R_i subject to C ≤ budget.

    ``weights`` enables the workload-aware variant: the objective becomes
    Σ_i w_i · R_i (Fig. 16 experiment).  ``base``/``spt`` may be passed to
    reuse precomputed trees (the benchmark sweeps budgets over one instance).
    ``backend="torch"`` scores every round's candidate set ξ on ``device``
    in f32 (:class:`repro_torch.core.solvers.torch_backend.LmgScorer`); the
    device argmax is a *selection* — the chosen move's Δw/Δd are recomputed
    in f64 and feasibility re-checked before committing, so the tree
    bookkeeping below (shared by both backends) only ever sees exact
    arithmetic.
    """
    check_backend(backend)
    base = base or minimum_storage_tree(g, backend=backend, device=device)
    spt = spt or shortest_path_tree(g, backend=backend, device=device)
    ea = g.arrays()
    n = g.n

    parent = np.zeros(n + 1, dtype=np.int64)
    for i, p in base.parent.items():
        parent[i] = p
    vs = np.arange(1, n + 1, dtype=np.int64)
    eid = ea.lookup_many(parent[vs], vs)
    assert (eid >= 0).all(), "base tree uses an unrevealed edge"
    cur_delta = np.zeros(n + 1, dtype=np.float64)
    cur_phi = np.zeros(n + 1, dtype=np.float64)
    cur_delta[1:] = ea.delta[eid]
    cur_phi[1:] = ea.phi[eid]

    # sequential left-fold to match StorageSolution.storage_cost() exactly
    w_total = 0.0
    for x in cur_delta[1:].tolist():
        w_total += x
    if w_total > budget + CONSTRAINT_TOL:
        raise ValueError(
            f"budget {budget} below minimum storage {w_total}: infeasible"
        )

    # --- incremental state -------------------------------------------------
    children: List[List[int]] = [[] for _ in range(n + 1)]
    for i in range(1, n + 1):
        children[parent[i]].append(i)
    order = _preorder(children, n)
    tin = np.empty(n + 1, dtype=np.int64)
    tin[order] = np.arange(n + 1, dtype=np.int64)

    # recreation cost d: preorder guarantees parents before children
    d = np.zeros(n + 1, dtype=np.float64)
    for x in order[1:].tolist():
        d[x] = d[parent[x]] + cur_phi[x]

    # subtree mass (count, or Σ weights workload-aware) and subtree size
    own = np.ones(n + 1, dtype=np.float64)
    own[0] = 0.0
    if weights is not None:
        for i in range(1, n + 1):
            own[i] = weights.get(i, 0.0)
    mass = own.copy()
    size = np.ones(n + 1, dtype=np.int64)
    for x in order[:0:-1].tolist():  # reverse preorder, root excluded
        p = int(parent[x])
        mass[p] += mass[x]
        size[p] += size[x]

    # candidate pool ξ: SPT edges absent from the current tree, (u, v)-sorted
    cu_l, cv_l = [], []
    for v in range(1, n + 1):
        if spt.parent[v] != parent[v]:
            cu_l.append(spt.parent[v])
            cv_l.append(v)
    cu = np.asarray(cu_l, dtype=np.int64)
    cv = np.asarray(cv_l, dtype=np.int64)
    if cu.shape[0]:
        perm = np.lexsort((cv, cu))
        cu, cv = cu[perm], cv[perm]
    ceid = ea.lookup_many(cu, cv)
    assert (ceid >= 0).all() or ceid.shape[0] == 0
    cand_delta = ea.delta[ceid] if ceid.shape[0] else np.empty(0)
    cand_phi = ea.phi[ceid] if ceid.shape[0] else np.empty(0)
    active = np.ones(cu.shape[0], dtype=bool)

    scorer = None
    if backend == "torch" and cu.shape[0]:
        from .torch_backend import LmgScorer

        scorer = LmgScorer(cu, cv, cand_delta, cand_phi, device=device)

    while active.any():
        if scorer is not None:
            i, rho_i, _, _, any_ok = scorer.score(
                active, cur_delta, d, mass, tin, size, w_total, budget
            )
            if not any_ok or rho_i <= 0.0:
                break
            # the f32 device scores only *select* i: recompute the move in
            # f64 and re-check feasibility; a borderline candidate that flips
            # under exact arithmetic is retired and the round re-scored
            ui, vi = int(cu[i]), int(cv[i])
            dwi = float(cand_delta[i] - cur_delta[vi])
            ddi = float((d[ui] + cand_phi[i]) - d[vi])
            reduction = -ddi * mass[vi]
            if (
                w_total + dwi > budget + CONSTRAINT_TOL
                or reduction <= 0
                or (tin[vi] <= tin[ui] < tin[vi] + size[vi])
            ):
                active[i] = False
                continue
        else:
            dw = cand_delta - cur_delta[cv]
            ok = active & (w_total + dw <= budget + CONSTRAINT_TOL)
            dd = (d[cu] + cand_phi) - d[cv]
            reduction = -dd * mass[cv]
            ok &= reduction > 0
            # cycle test: u inside subtree(v) ⇔ tin[v] ≤ tin[u] < tin[v]+size[v];
            # the root is never excluded (tin[0] == 0 < tin[v] for any v ≥ 1)
            ok &= ~((tin[cv] <= tin[cu]) & (tin[cu] < tin[cv] + size[cv]))
            if not ok.any():
                break
            rho = np.full(cu.shape[0], -1.0, dtype=np.float64)
            pos = ok & (dw > 0)
            rho[pos] = reduction[pos] / dw[pos]
            rho[ok & (dw <= 0)] = np.inf
            i = int(np.argmax(rho))
            if rho[i] <= 0.0:
                break
            dwi, ddi = float(dw[i]), float(dd[i])
        u, v = int(cu[i]), int(cv[i])
        old_u = int(parent[v])
        # rewire
        parent[v] = u
        w_total += dwi
        cur_delta[v] = cand_delta[i]
        cur_phi[v] = cand_phi[i]
        # subtree mass moves from old ancestors to new ancestors
        mv = float(mass[v])
        a = old_u
        while a != 0:
            mass[a] -= mv
            a = int(parent[a])
        a = u
        while a != 0:
            mass[a] += mv
            a = int(parent[a])
        # recreation costs of v's subtree shift by dd (contiguous in preorder)
        pv = int(tin[v])
        sz = int(size[v])
        block = order[pv:pv + sz]
        d[block] += ddi
        # splice the subtree block to immediately after its new parent
        tu = int(tin[u])
        if tu < pv:
            order = np.concatenate(
                (order[:tu + 1], block, order[tu + 1:pv], order[pv + sz:])
            )
        else:  # u sits after the block (it cannot be inside it)
            order = np.concatenate(
                (order[:pv], order[pv + sz:tu + 1], block, order[tu + 1:])
            )
        tin[order] = np.arange(n + 1, dtype=np.int64)
        a = old_u
        while a != 0:
            size[a] -= sz
            a = int(parent[a])
        a = u
        while a != 0:
            size[a] += sz
            a = int(parent[a])
        active[i] = False

    return StorageSolution(
        parent={i: int(parent[i]) for i in range(1, n + 1)}, graph=g
    )


def minimize_storage_sum_recreation(
    g: VersionGraph,
    theta: float,
    *,
    weights: Optional[Dict[int, float]] = None,
    tol: float = 1e-3,
    max_iters: int = 48,
    backend: str = "torch",
    device: str = "cuda",
) -> StorageSolution:
    """Problem 5: min C subject to Σ_i R_i ≤ theta, by binary search on the
    budget passed to LMG (paper §4.1: "repeated iterations and binary search").
    """
    base = minimum_storage_tree(g, backend=backend, device=device)
    spt = shortest_path_tree(g, backend=backend, device=device)
    lo = base.storage_cost()
    hi = spt.storage_cost()
    if spt.sum_recreation(weights) > theta + 1e-9:
        raise ValueError("theta below SPT sum-recreation: infeasible")
    if base.sum_recreation(weights) <= theta:
        return base
    best = None
    for _ in range(max_iters):
        mid = 0.5 * (lo + hi)
        sol = local_move_greedy(g, mid, weights=weights, base=base, spt=spt,
                                backend=backend, device=device)
        if sol.sum_recreation(weights) <= theta:
            best, hi = sol, mid
        else:
            lo = mid
        if hi - lo <= tol * max(1.0, lo):
            break
    if best is None:
        # fall back to the SPT (always feasible given the check above)
        best = spt
    return best
