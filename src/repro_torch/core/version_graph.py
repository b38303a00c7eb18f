"""Version graphs and storage/recreation cost matrices (paper §2.1).

A :class:`VersionGraph` holds ``n`` versions ``V_1..V_n`` plus the dummy
source ``V_0`` (index 0).  Edges carry ``(delta, phi)`` pairs:

* edge ``(0, i)``  — materialization:  ``delta = Δ_ii`` (full storage bytes),
  ``phi = Φ_ii`` (full retrieval cost);
* edge ``(i, j)``, ``i != 0`` — delta storage: ``delta = Δ_ij`` bytes of the
  diff recreating ``V_j`` from ``V_i``, ``phi = Φ_ij`` cost of applying it.

The matrices are *sparse*: entries never revealed (paper's "—") are simply
absent.  ``directed=False`` means every revealed off-diagonal entry is usable
in both directions (symmetric deltas, paper Scenario 1).

Representation
--------------
``VersionGraph`` is a thin facade over :class:`~repro_torch.core.edge_arrays.EdgeArrays`:
mutations (``set_delta`` / ``set_materialization`` / ``add_edges_bulk``)
append to staging buffers; the first query finalizes them into flat
``src``/``dst``/``delta``/``phi`` arrays with CSR offsets (cached until the
next mutation).  Per-edge accessors (``cost``, ``out_edges``...) are kept for
compatibility and small-graph code; the vectorized solvers work on
``arrays()`` directly.  Re-setting an existing ``(i, j)`` pair overwrites it,
exactly like the old dict-of-dicts adjacency.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from .edge_arrays import EdgeArrays

Edge = Tuple[int, int]


@dataclasses.dataclass(frozen=True)
class EdgeCost:
    """Storage bytes and recreation cost of one edge of ``G``."""

    delta: float
    phi: float


class VersionGraph:
    """The augmented graph ``G`` of paper §2.2 (versions + dummy root)."""

    def __init__(self, n_versions: int, *, directed: bool = True) -> None:
        if n_versions <= 0:
            raise ValueError("need at least one version")
        self.n = n_versions
        self.directed = directed
        # staging buffers: scalar appends + bulk numpy chunks
        self._pend: List[Tuple[int, int, float, float]] = []
        self._chunks: List[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]] = []
        self._ea: Optional[EdgeArrays] = None

    # ------------------------------------------------------------------ build
    def set_materialization(self, i: int, delta: float, phi: float) -> None:
        """Record ``Δ_ii``/``Φ_ii`` (edge from the dummy root)."""
        self._check_version(i)
        self._put(0, i, float(delta), float(phi))

    def set_delta(self, i: int, j: int, delta: float, phi: float) -> None:
        """Record ``Δ_ij``/``Φ_ij`` — recreate ``V_j`` from ``V_i``."""
        self._check_version(i)
        self._check_version(j)
        if i == j:
            raise ValueError("use set_materialization for the diagonal")
        self._put(i, j, float(delta), float(phi))
        if not self.directed:
            self._put(j, i, float(delta), float(phi))

    def add_edges_bulk(
        self,
        src: np.ndarray,
        dst: np.ndarray,
        delta: np.ndarray,
        phi: np.ndarray,
        *,
        mirror: bool = False,
    ) -> None:
        """Append a whole batch of edges without per-edge Python overhead.

        ``src == 0`` rows are materializations.  With ``mirror=True`` every
        off-root edge is also added reversed (undirected instances).  Ids are
        range-checked vectorized; the ``i == j`` diagonal is rejected like
        ``set_delta``.
        """
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        delta = np.asarray(delta, dtype=np.float64)
        phi = np.asarray(phi, dtype=np.float64)
        if not (src.shape == dst.shape == delta.shape == phi.shape):
            raise ValueError("bulk edge arrays must share one shape")
        if src.size == 0:
            return
        if (src < 0).any() or (src > self.n).any():
            raise ValueError("bulk src ids out of range")
        if (dst < 1).any() or (dst > self.n).any():
            raise ValueError(f"bulk dst ids out of range 1..{self.n}")
        if (src == dst).any():
            raise ValueError("use set_materialization for the diagonal")
        self._chunks.append((src, dst, delta, phi))
        if mirror:
            off = src != 0
            if off.any():
                self._chunks.append(
                    (dst[off], src[off], delta[off], phi[off])
                )
        self._ea = None

    def _put(self, i: int, j: int, delta: float, phi: float) -> None:
        self._pend.append((i, j, delta, phi))
        self._ea = None

    def _check_version(self, i: int) -> None:
        if not 1 <= i <= self.n:
            raise ValueError(f"version id {i} out of range 1..{self.n}")

    # ----------------------------------------------------------------- arrays
    def arrays(self) -> EdgeArrays:
        """The flat array-native view; built lazily, cached until mutation."""
        if self._ea is None:
            parts = list(self._chunks)
            if self._pend:
                p = np.asarray(self._pend, dtype=np.float64).reshape(-1, 4)
                parts.append(
                    (
                        p[:, 0].astype(np.int64),
                        p[:, 1].astype(np.int64),
                        p[:, 2],
                        p[:, 3],
                    )
                )
            if parts:
                src = np.concatenate([c[0] for c in parts])
                dst = np.concatenate([c[1] for c in parts])
                delta = np.concatenate([c[2] for c in parts])
                phi = np.concatenate([c[3] for c in parts])
            else:
                src = np.empty(0, dtype=np.int64)
                dst = np.empty(0, dtype=np.int64)
                delta = np.empty(0, dtype=np.float64)
                phi = np.empty(0, dtype=np.float64)
            self._ea = EdgeArrays.from_edges(self.n, src, dst, delta, phi)
        return self._ea

    # ------------------------------------------------------------------ query
    def cost(self, i: int, j: int) -> Optional[EdgeCost]:
        ea = self.arrays()
        e = ea.lookup(i, j)
        if e < 0:
            return None
        return EdgeCost(float(ea.delta[e]), float(ea.phi[e]))

    def materialization_cost(self, i: int) -> Optional[EdgeCost]:
        return self.cost(0, i)

    def out_edges(self, i: int) -> Iterator[Tuple[int, EdgeCost]]:
        ea = self.arrays()
        s, e = ea.out_range(i)
        for k in range(s, e):
            yield int(ea.dst[k]), EdgeCost(float(ea.delta[k]), float(ea.phi[k]))

    def in_edges(self, j: int) -> Iterator[Tuple[int, EdgeCost]]:
        ea = self.arrays()
        for k in ea.in_edge_ids(j):
            yield int(ea.src[k]), EdgeCost(float(ea.delta[k]), float(ea.phi[k]))

    def edges(self) -> Iterator[Tuple[int, int, EdgeCost]]:
        ea = self.arrays()
        for k in range(ea.m):
            yield (
                int(ea.src[k]),
                int(ea.dst[k]),
                EdgeCost(float(ea.delta[k]), float(ea.phi[k])),
            )

    @property
    def n_edges(self) -> int:
        return self.arrays().m

    def vertices(self) -> range:
        """All vertex ids including the dummy root 0."""
        return range(self.n + 1)

    def versions(self) -> range:
        return range(1, self.n + 1)

    def has_all_materializations(self) -> bool:
        ea = self.arrays()
        s, e = ea.out_range(0)
        return e - s == self.n  # root row is deduped and dst-unique

    # -------------------------------------------------------------- validation
    def check_triangle_inequality(self, *, tol: float = 1e-9) -> List[str]:
        """Best-effort check of the paper §3 triangle inequalities on revealed
        entries (only meaningful for symmetric Δ=Φ instances).  Returns a list
        of human-readable violations (empty = consistent)."""
        bad: List[str] = []
        ea = self.arrays()
        s0, e0 = ea.out_range(0)
        diag = {int(ea.dst[k]): float(ea.delta[k]) for k in range(s0, e0)}
        for p, q, cpq in self.edges():
            if p == 0:
                continue
            # |Δpp - Δpq| <= Δqq <= Δpp + Δpq
            dp, dq = diag.get(p), diag.get(q)
            if dp is not None and dq is not None:
                if not (abs(dp - cpq.delta) - tol <= dq <= dp + cpq.delta + tol):
                    bad.append(f"diag triangle violated at ({p},{q})")
            for w, cqw in self.out_edges(q):
                if w in (0, p):
                    continue
                cpw = self.cost(p, w)
                if cpw is None:
                    continue
                if cpw.delta > cpq.delta + cqw.delta + tol:
                    bad.append(f"edge triangle violated at ({p},{q},{w})")
        return bad


# ---------------------------------------------------------------------- trees
@dataclasses.dataclass
class StorageSolution:
    """A storage graph: ``parent[i]`` for every version ``i`` (paper's P).

    ``parent[i] == 0`` means ``V_i`` is materialized; otherwise ``V_i`` is
    stored as a delta from ``V_{parent[i]}``.  Lemma 1: any valid solution is a
    spanning tree of ``G`` rooted at the dummy vertex 0.
    """

    parent: Dict[int, int]
    graph: VersionGraph

    # -- structure ---------------------------------------------------------
    def validate(self) -> None:
        g = self.graph
        if set(self.parent) != set(g.versions()):
            raise ValueError("solution must assign a parent to every version")
        for i, p in self.parent.items():
            if p != 0 and g.cost(p, i) is None:
                raise ValueError(f"edge ({p},{i}) not revealed in graph")
            if p == 0 and g.materialization_cost(i) is None:
                raise ValueError(f"no materialization cost for {i}")
        # acyclicity / reachability from root
        seen = set()
        for i in g.versions():
            path = []
            v = i
            while v != 0 and v not in seen:
                path.append(v)
                v = self.parent[v]
                if len(path) > g.n:
                    raise ValueError("cycle detected in storage solution")
            seen.update(path)

    def children(self) -> Dict[int, List[int]]:
        ch: Dict[int, List[int]] = {v: [] for v in self.graph.vertices()}
        for i, p in self.parent.items():
            ch[p].append(i)
        return ch

    def depth(self, i: int) -> int:
        d = 0
        while i != 0:
            i = self.parent[i]
            d += 1
        return d

    # -- costs (paper §2.1) --------------------------------------------------
    def edge_cost(self, i: int) -> EdgeCost:
        p = self.parent[i]
        c = self.graph.materialization_cost(i) if p == 0 else self.graph.cost(p, i)
        assert c is not None
        return c

    def _edge_ids(self) -> np.ndarray:
        ea = self.graph.arrays()
        n = self.graph.n
        pa = np.zeros(n + 1, dtype=np.int64)
        for i, p in self.parent.items():
            pa[i] = p
        vs = np.arange(1, n + 1, dtype=np.int64)
        eid = ea.lookup_many(pa[vs], vs)
        assert (eid >= 0).all(), "solution edge not revealed in graph"
        return eid

    def storage_cost(self) -> float:
        """Total storage C = Σ Δ over edges of the storage tree."""
        ea = self.graph.arrays()
        # sequential left-fold, matching a per-edge Python summation exactly
        total = 0.0
        for x in ea.delta[self._edge_ids()].tolist():
            total += x
        return total

    def recreation_costs(self) -> Dict[int, float]:
        """R_i for every version — Φ summed along the path from the root.

        Iterative (explicit chain walk with memoization) so deep delta chains
        never hit the interpreter recursion limit.
        """
        memo: Dict[int, float] = {0: 0.0}
        for i in self.graph.versions():
            chain: List[int] = []
            v = i
            while v not in memo:
                chain.append(v)
                v = self.parent[v]
            r = memo[v]
            for x in reversed(chain):
                r = r + self.edge_cost(x).phi
                memo[x] = r
        return {i: memo[i] for i in self.graph.versions()}

    def sum_recreation(self, weights: Optional[Dict[int, float]] = None) -> float:
        rc = self.recreation_costs()
        if weights is None:
            return sum(rc.values())
        return sum(rc[i] * weights.get(i, 0.0) for i in rc)

    def max_recreation(self) -> float:
        return max(self.recreation_costs().values())

    def materialized(self) -> List[int]:
        return sorted(i for i, p in self.parent.items() if p == 0)

    def edges(self) -> Iterable[Tuple[int, int]]:
        return ((p, i) for i, p in self.parent.items())

    def summary(self) -> str:
        return (
            f"storage={self.storage_cost():.6g} "
            f"sum_rec={self.sum_recreation():.6g} "
            f"max_rec={self.max_recreation():.6g} "
            f"materialized={len(self.materialized())}/{self.graph.n}"
        )
