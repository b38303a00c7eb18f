"""Live storage/recreation-tradeoff telemetry over a ``VersionStore``.

The port's own copy of the JAX package's ``repro.obs.tradeoff``: the
monitor reads only the store's metadata, so its samples equal the JAX
package's for the same store.

The paper's central quantity is the (C, R) tradeoff: total storage cost C
against recreation cost R per version.  Offline, the benchmarks measure it;
this module makes it *live state*: a :class:`TradeoffMonitor` attached to a
store samples both sides of the tradeoff on every commit and repack —

* **storage side** — bytes at rest split by encoding (full objects vs
  deltas), object counts;
* **recreation side** — per-version modelled recreation cost Φ along the
  current storage chains: p50/p99/max percentiles, the plain sum (Problem 2
  objective), and the **access-weighted recreation sum** Σ w_v·R(v) with the
  store's Laplace-smoothed access weights — the Problem 5/6 objective the
  workload-aware repacks optimize.

Samples keep to a bounded history (deque), and the sample taken right after
a ``repack`` becomes the **baseline**: :meth:`drift` compares the latest
sample against it, so the service tier's :class:`FsckSweeper` can report
*quantitative* drift — "access-weighted R is 2.3× the post-repack
baseline" — instead of only flagging that a constraint broke.  Before any
repack, the baseline is the sample taken at attach time (labelled
``start``).

Sampling is O(n) in the version count (one memoized pass computes every
chain cost), runs under the store lock for a consistent snapshot, and
happens on the committing/repacking thread — attach a monitor where commits
are service-scale events (the ``DatasetService`` does this by default), not
inside tight store-building loops.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Deque, Dict, List, Optional

__all__ = ["TradeoffMonitor", "TradeoffSample"]


@dataclasses.dataclass(frozen=True)
class TradeoffSample:
    """One point-in-time measurement of both sides of the (C, R) tradeoff."""

    timestamp: float
    event: str                          # "start" | "commit" | "repack" | "sample"
    versions: int
    full_objects: int
    delta_objects: int
    storage_bytes_full: int
    storage_bytes_delta: int
    recreation_p50_s: float
    recreation_p99_s: float
    recreation_max_s: float
    recreation_sum_s: float
    access_weighted_recreation_s: float
    max_chain_depth: int

    @property
    def storage_bytes_total(self) -> int:
        return self.storage_bytes_full + self.storage_bytes_delta

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["storage_bytes_total"] = self.storage_bytes_total
        return d


class TradeoffMonitor:
    """Bounded-history (C, R) sampler bound to one store (see module docs).

    The store calls :meth:`on_commit` / :meth:`on_repack` when a monitor is
    attached (``store.tradeoff_monitor``); anything else may call
    :meth:`sample` ad hoc.  Thread-safe: samples are taken under the store
    lock, history mutation under the monitor's own lock.
    """

    def __init__(self, store: Any, *, capacity: int = 512) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.store = store
        self._lock = threading.Lock()
        self.history: "Deque[TradeoffSample]" = collections.deque(
            maxlen=int(capacity)
        )
        self.baseline: Optional[TradeoffSample] = None

    # -- measurement -------------------------------------------------------
    def _chain_costs(self) -> Dict[int, float]:
        """Recreation cost Φ per version, one memoized O(n) pass (caller
        holds the store lock)."""
        versions = self.store.versions
        costs: Dict[int, float] = {}
        for vid in versions:
            chain: List[int] = []
            v: Optional[int] = vid
            while v is not None and v not in costs:
                chain.append(v)
                v = versions[v].stored_base
                if len(chain) > len(versions):
                    raise RuntimeError("storage graph cycle")
            acc = 0.0 if v is None else costs[v]
            for u in reversed(chain):
                acc += versions[u].phi
                costs[u] = acc
        return costs

    def _chain_depths(self) -> int:
        versions = self.store.versions
        depth: Dict[int, int] = {}
        for vid in versions:
            chain: List[int] = []
            v: Optional[int] = vid
            while v is not None and v not in depth:
                chain.append(v)
                v = versions[v].stored_base
            for u in reversed(chain):
                b = versions[u].stored_base
                depth[u] = 0 if b is None else depth[b] + 1
        return max(depth.values(), default=0)

    def sample(self, event: str = "sample") -> TradeoffSample:
        """Measure now, append to history, and return the sample."""
        from ..service.metrics import percentile  # local: leaf-only import

        store = self.store
        with store._lock:
            versions = store.versions
            full_b = delta_b = full_n = delta_n = 0
            for m in versions.values():
                if m.stored_base is None:
                    full_b += m.stored_bytes
                    full_n += 1
                else:
                    delta_b += m.stored_bytes
                    delta_n += 1
            if versions:
                costs = self._chain_costs()
                xs = list(costs.values())
                weights = store.access_weights()
                awr = sum(weights[v] * costs[v] for v in costs)
                p50 = percentile(xs, 50)
                p99 = percentile(xs, 99)
                mx = max(xs)
                total = sum(xs)
                depth = self._chain_depths()
            else:
                awr = p50 = p99 = mx = total = 0.0
                depth = 0
        s = TradeoffSample(
            timestamp=time.time(),
            event=event,
            versions=len(versions),
            full_objects=full_n,
            delta_objects=delta_n,
            storage_bytes_full=full_b,
            storage_bytes_delta=delta_b,
            recreation_p50_s=p50,
            recreation_p99_s=p99,
            recreation_max_s=mx,
            recreation_sum_s=total,
            access_weighted_recreation_s=awr,
            max_chain_depth=depth,
        )
        with self._lock:
            self.history.append(s)
            if self.baseline is None:
                self.baseline = dataclasses.replace(s, event="start")
        return s

    # -- store hooks -------------------------------------------------------
    def on_commit(self, vid: int) -> TradeoffSample:
        return self.sample("commit")

    def on_repack(self, stats: Optional[Dict[str, Any]] = None) -> TradeoffSample:
        """Post-repack sample; becomes the drift baseline."""
        s = self.sample("repack")
        with self._lock:
            self.baseline = s
        return s

    # -- introspection -----------------------------------------------------
    @property
    def latest(self) -> Optional[TradeoffSample]:
        with self._lock:
            return self.history[-1] if self.history else None

    def drift(self) -> Optional[Dict[str, Any]]:
        """Latest sample vs the baseline (post-repack if one happened, else
        the attach-time sample): absolute values plus ratios.  ``None``
        until at least one sample exists."""
        with self._lock:
            if not self.history or self.baseline is None:
                return None
            latest, base = self.history[-1], self.baseline

        def ratio(now: float, then: float) -> Optional[float]:
            return (now / then) if then > 0 else None

        return {
            "baseline_event": base.event,
            "baseline_age_s": latest.timestamp - base.timestamp,
            "versions_added": latest.versions - base.versions,
            "storage_bytes": latest.storage_bytes_total,
            "storage_bytes_baseline": base.storage_bytes_total,
            "storage_ratio": ratio(
                latest.storage_bytes_total, base.storage_bytes_total
            ),
            "access_weighted_recreation_s":
                latest.access_weighted_recreation_s,
            "access_weighted_recreation_baseline_s":
                base.access_weighted_recreation_s,
            "access_weighted_recreation_ratio": ratio(
                latest.access_weighted_recreation_s,
                base.access_weighted_recreation_s,
            ),
            "recreation_p99_ratio": ratio(
                latest.recreation_p99_s, base.recreation_p99_s
            ),
        }

    def describe_drift(self) -> Optional[str]:
        """Human one-liner for logs/repack recommendations, e.g.
        ``access-weighted R is 2.31x the post-repack baseline; storage is
        1.08x (+12 versions since)``."""
        d = self.drift()
        if d is None:
            return None
        kind = ("post-repack" if d["baseline_event"] == "repack"
                else "attach-time")
        awr = d["access_weighted_recreation_ratio"]
        sto = d["storage_ratio"]
        awr_s = f"{awr:.2f}x" if awr is not None else "n/a"
        sto_s = f"{sto:.2f}x" if sto is not None else "n/a"
        return (
            f"access-weighted R is {awr_s} the {kind} baseline; storage is "
            f"{sto_s} (+{d['versions_added']} versions since)"
        )

    def snapshot(self) -> Dict[str, Any]:
        """JSON-friendly view for ``DatasetService.stats()`` / exporters."""
        latest = self.latest
        with self._lock:
            base = self.baseline
            n = len(self.history)
        return {
            "samples": n,
            "latest": latest.to_dict() if latest else None,
            "baseline": base.to_dict() if base else None,
            "drift": self.drift(),
        }
