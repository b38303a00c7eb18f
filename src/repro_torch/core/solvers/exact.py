"""Exact solver — branch-and-bound over parent assignments.

Stands in for the paper's Gurobi ILP (§2.3, Table 2): this container ships no
ILP solver, so we solve the same optimization exactly by DFS over parent
choices with

* incremental cycle detection (parent pointers form a functional graph);
* admissible storage lower bound: current cost + Σ over unassigned versions
  of their cheapest revealed in-edge;
* recreation-feasibility pruning: a parent p is inadmissible for v when even
  the *best possible* recreation of p (its Φ-shortest-path distance) plus
  Φ_{p,v} already exceeds θ;
* exact constraint check on completed chains;
* optional wall-clock budget — like the paper's Gurobi runs, the solver then
  reports the incumbent and whether optimality was proven.

Supports Problem 6 (min C s.t. max R ≤ θ) and Problem 5 (min C s.t. Σ R ≤ θ).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..version_graph import StorageSolution, VersionGraph
from .spt import dijkstra_arrays


@dataclasses.dataclass
class ExactResult:
    solution: Optional[StorageSolution]
    optimal: bool
    nodes_explored: int
    wall_seconds: float


def exact_min_storage(
    g: VersionGraph,
    *,
    theta_max: Optional[float] = None,
    theta_sum: Optional[float] = None,
    time_budget_s: float = 60.0,
    incumbent: Optional[StorageSolution] = None,
) -> ExactResult:
    if (theta_max is None) == (theta_sum is None):
        raise ValueError("set exactly one of theta_max / theta_sum")

    versions = list(g.versions())
    n = len(versions)
    ea = g.arrays()
    sp_phi, _ = dijkstra_arrays(ea, weight="phi")

    # candidate parents per version, cheapest-Δ first — one reverse-CSR slice
    # per version instead of a per-edge Python scan
    cand: Dict[int, List[Tuple[float, float, int]]] = {}
    for v in versions:
        eids = ea.in_edge_ids(v)
        us = ea.src[eids]
        ds = ea.delta[eids]
        ps = ea.phi[eids]
        keep = np.ones(us.shape[0], dtype=bool)
        if theta_max is not None:
            # feasibility pre-prune for the max-recreation variant: best-case
            # recreation of the parent plus this edge must stay within θ
            keep &= (us == 0) | (sp_phi[us] + ps <= theta_max + 1e-9)
        opts = [
            (float(ds[k]), float(ps[k]), int(us[k]))
            for k in np.nonzero(keep)[0].tolist()
        ]
        opts.sort()
        cand[v] = opts
    min_in = {v: (cand[v][0][0] if cand[v] else float("inf")) for v in versions}

    # order versions by descending cheapest-in-edge cost: decide the expensive,
    # most-constrained versions first for tighter early bounds.
    order = sorted(versions, key=lambda v: -min_in[v])
    suffix_lb = [0.0] * (n + 1)
    for k in range(n - 1, -1, -1):
        suffix_lb[k] = suffix_lb[k + 1] + min_in[order[k]]

    best_cost = float("inf")
    best_parent: Optional[Dict[int, int]] = None
    if incumbent is not None:
        best_cost = incumbent.storage_cost() + 1e-12
        best_parent = dict(incumbent.parent)

    parent: Dict[int, int] = {}
    t0 = time.monotonic()
    nodes = 0
    timed_out = False

    def creates_cycle(v: int, p: int) -> bool:
        x = p
        while x != 0:
            if x == v:
                return True
            nx = parent.get(x)
            if nx is None:
                return False
            x = nx
        return False

    def recreation_exact(v: int) -> Optional[float]:
        """Exact R_v if the whole chain to root is assigned, else None."""
        total = 0.0
        x = v
        while x != 0:
            p = parent.get(x)
            if p is None:
                return None
            c = g.materialization_cost(x) if p == 0 else g.cost(p, x)
            total += c.phi
            x = p
        return total

    def dfs(k: int, cost: float) -> None:
        nonlocal best_cost, best_parent, nodes, timed_out
        if timed_out or time.monotonic() - t0 > time_budget_s:
            timed_out = True
            return
        nodes += 1
        if cost + suffix_lb[k] >= best_cost - 1e-12:
            return
        if k == n:
            # all parents set: verify the recreation constraint exactly
            sol = StorageSolution(parent=dict(parent), graph=g)
            rc = sol.recreation_costs()
            if theta_max is not None and max(rc.values()) > theta_max + 1e-9:
                return
            if theta_sum is not None and sum(rc.values()) > theta_sum + 1e-9:
                return
            best_cost = cost
            best_parent = dict(parent)
            return
        v = order[k]
        for (dlt, phi, p) in cand[v]:
            if cost + dlt + suffix_lb[k + 1] >= best_cost - 1e-12:
                break  # candidates are Δ-sorted: nothing better follows
            if p != 0 and creates_cycle(v, p):
                continue
            parent[v] = p
            if theta_max is not None:
                r = recreation_exact(v)
                if r is not None and r > theta_max + 1e-9:
                    del parent[v]
                    continue
            dfs(k + 1, cost + dlt)
            del parent[v]

    dfs(0, 0.0)
    wall = time.monotonic() - t0
    sol = None
    if best_parent is not None:
        sol = StorageSolution(parent=best_parent, graph=g)
        sol.validate()
    return ExactResult(
        solution=sol,
        optimal=not timed_out and sol is not None,
        nodes_explored=nodes,
        wall_seconds=wall,
    )
