"""Observability for the port: span tracing and live tradeoff telemetry.

The port's copy of the JAX package's ``repro.obs``:

* :mod:`.tracer` — the span tracer the service, store, materializer, delta
  codec and ``optimize`` record into; disabled by default, one attribute
  check per instrumentation point then.
* :mod:`.export` — Chrome trace-event JSON (Perfetto-loadable) and
  Prometheus-style text over a ``DatasetService.stats()`` snapshot.
* :mod:`.tradeoff` — :class:`TradeoffMonitor`: live (C, R) samples on every
  commit and repack of a store, with a post-repack baseline.
* :mod:`.cli` — ``python -m repro_torch.obs {summary,trace,convert,prom,overhead}``
  (``--device cpu`` for the plain versions; the default is the card).

Quick start::

    from repro_torch import obs

    with obs.tracing() as tracer:            # enabled tracer, auto-restored
        ...  # run service traffic
    obs.chrome_trace(tracer, "trace.json")   # load in ui.perfetto.dev
"""

from __future__ import annotations

import contextlib
from typing import Iterator

from .export import (
    chrome_trace,
    dump_spans_jsonl,
    load_spans_jsonl,
    prometheus_text,
    validate_chrome_trace,
)
from .tracer import (
    NULL_SPAN,
    Span,
    Tracer,
    add_event,
    enabled,
    get_tracer,
    set_tracer,
    span,
    start,
)
from .tradeoff import TradeoffMonitor, TradeoffSample

__all__ = [
    "Span",
    "Tracer",
    "NULL_SPAN",
    "get_tracer",
    "set_tracer",
    "span",
    "start",
    "add_event",
    "enabled",
    "tracing",
    "chrome_trace",
    "validate_chrome_trace",
    "prometheus_text",
    "dump_spans_jsonl",
    "load_spans_jsonl",
    "TradeoffMonitor",
    "TradeoffSample",
]


@contextlib.contextmanager
def tracing(*, capacity: int = 65536) -> Iterator[Tracer]:
    """Install a fresh enabled tracer as the process global for the block;
    restores the previous tracer on exit and yields the new one (its spans
    stay readable after the block ends)."""
    tracer = Tracer(enabled=True, capacity=capacity)
    old = set_tracer(tracer)
    try:
        yield tracer
    finally:
        set_tracer(old)
