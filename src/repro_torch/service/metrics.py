"""Service-tier metrics: counters plus latency tracks with p50/p99 rollups.

Every request through the :class:`~repro_torch.service.service.DatasetService`
records into one shared :class:`ServiceMetrics` — queue wait (enqueue →
batch dispatch), decode time (one sample per dispatched batch), end-to-end
latency per operation, and counters for the coalescing/batching machinery
(``checkout.coalesced``, ``checkout.batches``, ``checkout.warm_hits``, …)
and the background fsck sweep (``fsck.sweeps``, ``fsck.findings``,
``fsck.repack_recommended``).

Tracks keep a bounded window of recent samples (oldest dropped) for the
quantile rollups while ``count``/``mean`` cover everything ever observed, so
a long-lived service neither grows without bound nor loses its throughput
totals.  All methods are thread-safe: reader-pool threads and the event loop
record into the same registry.
"""

from __future__ import annotations

import collections
import math
import threading
from typing import Deque, Dict, Iterable, List, Union

__all__ = ["LatencyTrack", "ServiceMetrics", "percentile"]


def percentile(samples: Iterable[float], q: float) -> float:
    """Nearest-rank percentile of a non-empty sample set (``q`` in 0..100).

    Half-point ranks round *up* (explicit floor-half-up): builtin
    ``round()`` is banker's rounding, which sends every ``x.5`` rank to the
    nearer even index — on even-length windows the median rank (exactly
    ``.5``) then always resolves to the lower neighbor and the reported
    quantile biases low.
    """
    xs = sorted(samples)
    if not xs:
        raise ValueError("percentile of empty sample set")
    idx = int(math.floor(q / 100.0 * (len(xs) - 1) + 0.5))
    return xs[min(len(xs) - 1, max(0, idx))]


class LatencyTrack:
    """One latency series: bounded sample window + lifetime count/sum."""

    __slots__ = ("samples", "count", "total", "peak")

    def __init__(self, cap: int) -> None:
        self.samples: Deque[float] = collections.deque(maxlen=cap)
        self.count = 0
        self.total = 0.0
        self.peak = 0.0

    def record(self, seconds: float) -> None:
        self.samples.append(seconds)
        self.count += 1
        self.total += seconds
        if seconds > self.peak:
            self.peak = seconds

    def summary(self) -> Dict[str, float]:
        """Rollup in milliseconds (quantiles over the retained window)."""
        if not self.count:
            return {"count": 0}
        window: List[float] = list(self.samples)
        return {
            "count": self.count,
            "mean_ms": round(self.total / self.count * 1e3, 4),
            "p50_ms": round(percentile(window, 50) * 1e3, 4),
            "p99_ms": round(percentile(window, 99) * 1e3, 4),
            "max_ms": round(self.peak * 1e3, 4),
        }


class ServiceMetrics:
    """Thread-safe counter + latency-track registry for the service tier."""

    def __init__(self, *, track_cap: int = 100_000) -> None:
        self._lock = threading.Lock()
        self._track_cap = int(track_cap)
        self._counters: Dict[str, int] = {}
        self._tracks: Dict[str, LatencyTrack] = {}
        self._gauges: Dict[str, float] = {}

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def counter(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def set_gauge(self, name: str, value: float) -> None:
        """Last-write-wins point-in-time value (tradeoff drift ratios, store
        gauges — anything that is a level, not a count or a latency)."""
        with self._lock:
            self._gauges[name] = value

    def gauge(self, name: str, default: float = 0.0) -> float:
        with self._lock:
            return self._gauges.get(name, default)

    def observe(self, track: str, seconds: float) -> None:
        with self._lock:
            t = self._tracks.get(track)
            if t is None:
                t = self._tracks[track] = LatencyTrack(self._track_cap)
            t.record(seconds)

    def track(self, name: str) -> Dict[str, float]:
        with self._lock:
            t = self._tracks.get(name)
            return t.summary() if t is not None else {"count": 0}

    def snapshot(self) -> Dict[str, Union[Dict, int]]:
        """Point-in-time view: every counter, track rollup, and gauge."""
        with self._lock:
            return {
                "counters": dict(sorted(self._counters.items())),
                "tracks": {
                    name: t.summary()
                    for name, t in sorted(self._tracks.items())
                },
                "gauges": dict(sorted(self._gauges.items())),
            }
