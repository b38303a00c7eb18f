"""Concurrent serving tier for versioned datasets.

The store layer answers "what does version v contain?"; this package
answers it *under traffic*: an asyncio front-end that coalesces identical
requests, folds concurrent distinct requests into one batched checkout
plan, coordinates the single writer with many readers, and keeps
per-request latency/hit-rate metrics — the serving half of the paper's
recreation-cost story.

The port's copy of the JAX package's ``repro.service``; the store under it
runs on the card unless the repository was opened with ``device="cpu"``.

Entry points: :class:`DatasetService` (or ``Repository.serve()``),
:class:`ServiceMetrics` for the shared registry, :class:`FsckSweeper` for
background integrity sweeps.
"""

from .metrics import LatencyTrack, ServiceMetrics, percentile
from .service import DatasetService
from .sweeper import FsckSweeper

__all__ = [
    "DatasetService",
    "FsckSweeper",
    "LatencyTrack",
    "ServiceMetrics",
    "percentile",
]
