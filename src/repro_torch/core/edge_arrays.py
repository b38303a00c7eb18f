"""Flat, array-native edge store for version graphs.

``EdgeArrays`` is the canonical in-memory representation of the augmented
graph ``G`` (paper §2.2): four contiguous NumPy arrays ``src`` / ``dst`` /
``delta`` / ``phi`` holding one edge per slot, plus CSR-style offsets for
O(1) row slicing in both directions.  Vertex ids are ``0..n`` where ``0`` is
the dummy root; edges out of ``0`` are materializations (``Δ_ii``/``Φ_ii``).

Layout
------
* edges are sorted by ``(src, dst)`` — each out-row is a contiguous slice
  ``[row_ptr[u], row_ptr[u + 1])`` with ``dst`` ascending, so point lookups
  are a binary search and whole-row relaxations are single masked array ops;
* ``rperm`` permutes edge ids into ``dst``-grouped order with
  ``rrow_ptr`` as the reverse-CSR offsets (in-edges of ``v`` are
  ``rperm[rrow_ptr[v]:rrow_ptr[v + 1]]``);
* ``key = src * (n + 2) + dst`` is the sorted composite key used by the
  vectorized batch lookup (``lookup_many``).

Duplicate ``(src, dst)`` pairs passed to :meth:`from_edges` keep the *last*
occurrence — matching the overwrite semantics of the old dict-of-dicts
adjacency.  The arrays convert losslessly to PyTorch tensors via
:meth:`to_torch`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class EdgeArrays:
    """Immutable flat edge store; build with :meth:`from_edges`."""

    n: int                  # number of versions; vertex ids are 0..n
    src: np.ndarray         # int64 [m], sorted by (src, dst)
    dst: np.ndarray         # int64 [m]
    delta: np.ndarray       # float64 [m], storage bytes Δ
    phi: np.ndarray         # float64 [m], recreation cost Φ
    row_ptr: np.ndarray     # int64 [n + 2], CSR offsets over src
    rrow_ptr: np.ndarray    # int64 [n + 2], CSR offsets over dst
    rperm: np.ndarray       # int64 [m], edge ids grouped by dst
    key: np.ndarray         # int64 [m] = src * (n + 2) + dst, ascending

    # ------------------------------------------------------------------ build
    @classmethod
    def from_edges(
        cls,
        n: int,
        src: np.ndarray,
        dst: np.ndarray,
        delta: np.ndarray,
        phi: np.ndarray,
    ) -> "EdgeArrays":
        """Canonicalize raw edge buffers: sort by ``(src, dst)``, dedup
        keeping the last occurrence of each pair, and build both CSRs."""
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        delta = np.asarray(delta, dtype=np.float64)
        phi = np.asarray(phi, dtype=np.float64)
        m = src.shape[0]
        stride = n + 2
        if m:
            composite = src * stride + dst
            # stable sort by composite key; within equal keys insertion order
            # is preserved, so the *last* element of each run is the latest
            # write — the dict-overwrite semantics of the old adjacency.
            order = np.argsort(composite, kind="stable")
            composite = composite[order]
            last = np.ones(m, dtype=bool)
            last[:-1] = composite[1:] != composite[:-1]
            keep = order[last]
            src, dst = src[keep], dst[keep]
            delta, phi = delta[keep], phi[keep]
            key = composite[last]
        else:
            key = np.empty(0, dtype=np.int64)
        row_ptr = np.searchsorted(src, np.arange(stride, dtype=np.int64))
        rperm = np.lexsort((src, dst))
        rrow_ptr = np.searchsorted(dst[rperm], np.arange(stride, dtype=np.int64))
        return cls(
            n=n, src=src, dst=dst, delta=delta, phi=phi,
            row_ptr=row_ptr.astype(np.int64),
            rrow_ptr=rrow_ptr.astype(np.int64),
            rperm=rperm.astype(np.int64),
            key=key,
        )

    # ------------------------------------------------------------------ shape
    @property
    def m(self) -> int:
        """Number of (deduplicated) edges."""
        return int(self.src.shape[0])

    # ----------------------------------------------------------------- access
    def out_range(self, u: int) -> Tuple[int, int]:
        """Edge-id range ``[s, e)`` of ``u``'s out-edges."""
        return int(self.row_ptr[u]), int(self.row_ptr[u + 1])

    def out_degree(self, u: int) -> int:
        return int(self.row_ptr[u + 1] - self.row_ptr[u])

    def in_edge_ids(self, v: int) -> np.ndarray:
        """Edge ids of ``v``'s in-edges (ascending ``src``)."""
        return self.rperm[self.rrow_ptr[v]:self.rrow_ptr[v + 1]]

    def lookup(self, i: int, j: int) -> int:
        """Edge id of ``(i, j)`` or ``-1`` — binary search within row ``i``."""
        s, e = int(self.row_ptr[i]), int(self.row_ptr[i + 1])
        k = s + int(np.searchsorted(self.dst[s:e], j))
        if k < e and self.dst[k] == j:
            return k
        return -1

    def lookup_many(self, src_ids: np.ndarray, dst_ids: np.ndarray) -> np.ndarray:
        """Vectorized edge-id lookup; ``-1`` marks unrevealed pairs."""
        src_ids = np.asarray(src_ids, dtype=np.int64)
        dst_ids = np.asarray(dst_ids, dtype=np.int64)
        q = src_ids * (self.n + 2) + dst_ids
        if self.m == 0:
            return np.full(q.shape, -1, dtype=np.int64)
        pos = np.minimum(np.searchsorted(self.key, q), self.m - 1)
        out = np.where(self.key[pos] == q, pos, np.int64(-1))
        return out.astype(np.int64)

    # ---------------------------------------------------------------- exports
    def iter_edges(self) -> Iterator[Tuple[int, int, float, float]]:
        for e in range(self.m):
            yield (
                int(self.src[e]), int(self.dst[e]),
                float(self.delta[e]), float(self.phi[e]),
            )

    def to_torch(self, device: "object" = "cuda") -> Dict[str, "object"]:
        """The arrays as tensors on ``device``, the card unless the caller
        asks for the CPU (lazy torch import)."""
        import torch

        return {
            name: torch.as_tensor(getattr(self, name), device=device)
            for name in ("src", "dst", "delta", "phi", "row_ptr", "rrow_ptr",
                         "rperm")
        }
