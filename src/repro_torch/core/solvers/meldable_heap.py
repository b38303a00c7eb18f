"""Mergeable min-heaps of ``(weight, id)`` items with vectorized bulk offsets.

This is the in-edge structure behind the near-linear Edmonds MCA in
:mod:`repro_torch.core.solvers.mst`.  The classic formulations use skew or pairing
heaps of individual edges; at the scales we target (10M+ edges driven from
Python) a pointer-per-edge heap spends all its time in the interpreter.
:class:`RunHeap` keeps the same *interface* contract — amortized-O(1)
``meld``, bulk ``add_offset``, cheap ``pop`` — but stores items as **sorted
runs** (numpy arrays pre-sorted by ``(weight, id)``):

* a *run* is a contiguous ``(w, ids)`` array pair sorted ascending by
  ``(w, id)`` with a cursor ``pos`` and a cached head;
* a heap holds at most ~log2(items) runs, one per binary size class:
  ``meld`` adopts the donor's runs and then *consolidates* — equal-size
  runs merge (one vectorized lexsort) and carry, exactly like binary-counter
  addition / bottom-up mergesort, so each item is re-merged O(log n) times
  total and ``peek``/``pop`` scan a logarithmic run list;
* ``add_offset(c)`` adds ``c`` to every remaining item **eagerly**, as one
  in-place contiguous numpy add per run.  The textbook structure makes this
  O(1) with a lazy per-heap scalar, but lazily *summed* offsets regroup the
  float arithmetic — ``w + (c1 + c2)`` is not bit-equal to ``(w + c1) +
  c2`` — and the Edmonds parity contract (bit-identical trees vs the seed
  oracle, which subtracts reduced costs sequentially in place) needs every
  offset applied individually in chronological order.  Eager application
  costs O(remaining items) per call, but as C-speed contiguous array ops
  behind an O(log) Python loop; in Edmonds each edge absorbs one offset per
  contraction level containing its head — exactly the seed's update count,
  minus the seed's Python-level rescans and fancy-index gathers.

Additive shifts preserve the within-run ``(w, id)`` order, so offsets never
force a re-sort.  Ties on weight break to the lower ``id`` — the tie-break
contract the Edmonds seed oracle uses (lowest edge id on equal cost).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Tuple

import numpy as np


class _Run:
    """A sorted ``(w, ids)`` slab with a cursor; arrays are owned, not shared."""

    __slots__ = ("w", "ids", "pos", "head_w", "head_id")

    def __init__(self, w: np.ndarray, ids: np.ndarray) -> None:
        self.w = w
        self.ids = ids
        self.pos = 0
        self.head_w = float(w[0])
        self.head_id = int(ids[0])

    def _refresh_head(self) -> None:
        p = self.pos
        self.head_w = float(self.w[p])
        self.head_id = int(self.ids[p])

    def _remaining(self) -> int:
        return self.ids.shape[0] - self.pos


def _merge_runs(a: _Run, b: _Run) -> _Run:
    aw = a.w[a.pos:]
    bw = b.w[b.pos:]
    # disjoint weight ranges concatenate pre-sorted (strict <: on a boundary
    # tie the ids would still need interleaving)
    if aw[-1] < bw[0]:
        return _Run(
            np.concatenate((aw, bw)),
            np.concatenate((a.ids[a.pos:], b.ids[b.pos:])),
        )
    if bw[-1] < aw[0]:
        return _Run(
            np.concatenate((bw, aw)),
            np.concatenate((b.ids[b.pos:], a.ids[a.pos:])),
        )
    w = np.concatenate((aw, bw))
    ids = np.concatenate((a.ids[a.pos:], b.ids[b.pos:]))
    o = np.lexsort((ids, w))
    return _Run(w[o], ids[o])


class RunHeap:
    """Mergeable min-heap over ``(weight, id)`` items; see module docstring.

    Runs always have at least one remaining item (exhausted runs are removed
    immediately), and ``_runs`` stays logarithmic in the item count via
    size-class consolidation, so head scans are O(log).
    """

    __slots__ = ("_runs", "_n", "_compact_at")

    def __init__(self) -> None:
        self._runs: List[_Run] = []
        self._n = 0
        self._compact_at = 64

    # ------------------------------------------------------------ construction
    @classmethod
    def from_sorted(cls, w: np.ndarray, ids: np.ndarray) -> "RunHeap":
        """Heap over one pre-sorted run (``(w, id)`` ascending).

        ``w`` must be float64 and exclusively owned by the heap — offsets
        mutate it in place.
        """
        h = cls()
        if w.shape[0]:
            h._runs.append(_Run(w, ids))
            h._n = int(w.shape[0])
            h._compact_at = max(64, 2 * h._n)  # born fully live
        return h

    def push(self, w: float, item: int) -> None:
        """Insert a single item (a one-element run, then consolidate)."""
        self._runs.append(
            _Run(np.array([w], dtype=np.float64), np.array([item], dtype=np.int64))
        )
        self._n += 1
        self._consolidate()

    # ----------------------------------------------------------------- queries
    def __len__(self) -> int:
        return self._n

    def __bool__(self) -> bool:
        return self._n > 0

    def _min_run(self) -> _Run:
        runs = self._runs
        best = runs[0]
        bw = best.head_w
        bi = best.head_id
        for r in runs:
            hw = r.head_w
            if hw < bw or (hw == bw and r.head_id < bi):
                best = r
                bw = hw
                bi = r.head_id
        return best

    def peek(self) -> Tuple[float, int]:
        """``(weight, id)`` of the min item; IndexError when empty.

        Ties across runs resolve to the lower head id.  A uniform offset can
        collapse two *distinct* weights in the same run to bitwise equality
        (rounding), leaving an equal-weight block whose ids are not sorted —
        ``peek`` ignores entries hidden behind a tied head; use
        :meth:`min_tied_ids` for the exact lowest-id-on-tie contract.
        """
        r = self._min_run()
        return r.head_w, r.head_id

    def min_tied_ids(self) -> Tuple[float, np.ndarray]:
        """Min weight and the ids of *all* remaining items tied at it.

        Offsets only shift runs uniformly, so runs stay weakly sorted and
        items tied at the min form a leading block of each run whose head is
        tied — one ``searchsorted`` per tied run.  This recovers the exact
        lowest-id-on-tie contract even after rounding collapses distinct
        weights to equality (see :meth:`peek`).
        """
        w = self._min_run().head_w
        tied: List[np.ndarray] = []
        for r in self._runs:
            if r.head_w == w:
                stop = r.pos + int(
                    np.searchsorted(r.w[r.pos:], w, side="right")
                )
                tied.append(r.ids[r.pos:stop])
        return w, tied[0] if len(tied) == 1 else np.concatenate(tied)

    # --------------------------------------------------------------- mutation
    def add_offset(self, c: float) -> None:
        """Add ``c`` to every remaining item, one in-place array add per run.

        A uniform shift preserves run order, so no re-sort; cached heads get
        the same single float add the array elements do, so they stay
        bit-consistent.
        """
        for r in self._runs:
            if r.pos:
                r.w[r.pos:] += c
            else:
                r.w += c
            r.head_w += c

    def pop(self) -> Tuple[float, int]:
        """Remove and return the min ``(weight, id)``."""
        r = self._min_run()
        out = (r.head_w, r.head_id)
        r.pos += 1
        self._n -= 1
        if r.pos < r.ids.shape[0]:
            r._refresh_head()
        else:
            self._runs.remove(r)
        return out

    def meld(self, other: "RunHeap") -> "RunHeap":
        """Merge ``other`` into this heap (or vice versa) and return the result.

        The side with fewer runs donates its run objects to the other —
        callers must keep using the *returned* object and drop both operands.
        Consolidation then merges equal-size-class runs (binary-counter
        carry), keeping the run list logarithmic; each item takes part in
        O(log total) merges over a heap's lifetime.
        """
        a, b = self, other
        if len(b._runs) > len(a._runs):
            a, b = b, a
        a._runs.extend(b._runs)
        a._n += b._n
        b._runs = []
        b._n = 0
        # defer the binary-counter carry while the run list is short: head
        # scans and offsets over ≤8 runs cost less than eager tiny merges
        if len(a._runs) > 8:
            a._consolidate()
        return a

    def _consolidate(self) -> None:
        runs = self._runs
        if len(runs) <= 1:
            return
        by_class: Dict[int, _Run] = {}
        for r in runs:
            k = r._remaining().bit_length()
            while k in by_class:
                # both operands are in [2^(k-1), 2^k), so the merge lands in
                # class k+1 exactly — the carry always terminates
                r = _merge_runs(by_class.pop(k), r)
                k += 1
            by_class[k] = r
        self._runs = list(by_class.values())

    def drop_while(self, dead: Callable[[np.ndarray], np.ndarray]) -> None:
        """Discard dead items until the min item is alive (or the heap empties).

        ``dead`` maps an ``ids`` array to a boolean mask (True = discard).  It
        must be *stable*: an item reported dead stays dead forever (Edmonds
        self-loops only ever stay self-loops as components coarsen).  Under
        that contract this may also discard dead items that are not currently
        minimal — it scans the min run past other runs' heads in doubling
        batches so the predicate runs vectorized — which is safe and saves
        re-inspection later.
        """
        while self._runs:
            r = self._min_run()
            ids = r.ids
            pos = r.pos
            n = ids.shape[0]
            if not bool(dead(ids[pos : pos + 1])[0]):
                return
            pos += 1
            batch = 4
            while pos < n:
                stop = min(n, pos + batch)
                mask = dead(ids[pos:stop])
                if mask.all():
                    pos = stop
                    batch *= 2
                    continue
                pos += int(np.argmin(mask))  # first False = first live item
                break
            self._n -= pos - r.pos
            r.pos = pos
            if pos < n:
                r._refresh_head()
            else:
                self._runs.remove(r)

    def compact(self, dead: Callable[[np.ndarray], np.ndarray]) -> None:
        """Physically remove every dead item now (same ``dead`` contract as
        :meth:`drop_while`).

        Filtering preserves each run's sort order, so no re-sort; offsets
        applied after the purge then touch live items only.  Without purging,
        a long contraction chain pays every ``add_offset`` over an
        ever-growing tail of dead self-loops — the old quadratic regime at
        array speed instead of the near-linear live-edge bound.
        """
        runs: List[_Run] = []
        n = 0
        for r in self._runs:
            ids = r.ids[r.pos:]
            alive = ~dead(ids)
            k = int(alive.sum())
            if k == 0:
                continue
            if k != ids.shape[0]:
                r = _Run(r.w[r.pos:][alive], ids[alive])
            runs.append(r)
            n += k
        self._runs = runs
        self._n = n
        self._consolidate()
        self._compact_at = max(64, 2 * n)

    def maybe_compact(self, dead: Callable[[np.ndarray], np.ndarray]) -> None:
        """Amortized :meth:`compact`: only when the heap has doubled since the
        last purge (so at least half the items *could* be dead).  Keeps purge
        work O(1) amortized per item on purge-heavy workloads while staying
        O(log) total purges on dense heaps that stay mostly live."""
        if self._n >= self._compact_at:
            self.compact(dead)

    # ------------------------------------------------------------- inspection
    def items(self) -> Iterator[Tuple[float, int]]:
        """Yield all remaining ``(weight, id)`` items, unordered."""
        for r in self._runs:
            p = r.pos
            for raw, item in zip(r.w[p:].tolist(), r.ids[p:].tolist()):
                yield raw, int(item)
