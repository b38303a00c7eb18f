"""Span tracer: nested wall-clock intervals across the event loop and pools.

The port's own copy of the JAX package's ``repro.obs.tracer``, with the same
semantics (it holds no framework code; the port imports nothing of
``repro``).

One :class:`Tracer` owns a bounded ring buffer of finished :class:`Span`\\ s.
The **span contract** every instrumented layer follows:

* A span is an interval ``[t0, t1)`` on the tracer clock
  (``time.monotonic`` — the same clock the asyncio event loop and the
  service metrics use, so span totals reconcile exactly with the
  ``ServiceMetrics`` latency tracks) plus a ``name``, a free-form ``attrs``
  dict, and parent/trace ids for nesting.
* Parenthood propagates through a ``contextvars.ContextVar``: entering a
  span (``with tracer.span("x"):``) makes it the current parent for
  anything opened in the same task/thread context — including across
  ``await`` boundaries, because asyncio snapshots the context per task.
  Thread pools do **not** inherit context; a caller dispatching work onto a
  worker thread wraps the callable's body in :meth:`Tracer.attach` to carry
  its span across explicitly (the service tier does this for every batch).
* A span may be *started* in one context and *ended* in another
  (``sp = tracer.start("x")`` … ``sp.end()`` from a pool thread): ``end``
  is thread-safe and idempotent, and only ``__enter__``/``__exit__`` touch
  the context var.
* Track assignment for the exporters happens at start: spans opened inside
  an asyncio task get a per-task track (concurrent requests don't
  interleave on one Perfetto row); spans opened elsewhere get their
  thread's track.

Disabled tracers (the default global) are near-free: ``span()``/``start``
return a shared no-op singleton whose methods do nothing, and
``add_event``/``record`` return immediately — the hot serving path pays one
attribute check per instrumentation point.  ``Span.__bool__`` is ``True``
for real spans and ``False`` for the singleton, so call sites can guard
expensive attribute computation with ``if sp: sp.set(...)``.

The ring buffer keeps the most recent ``capacity`` finished spans
(``dropped`` counts overwrites), so a long-lived service traces
continuously with bounded memory.  All mutation is lock-guarded; reader
pool threads, the writer thread and the event loop share one tracer.
"""

from __future__ import annotations

import asyncio
import contextlib
import contextvars
import functools
import itertools
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Iterator, List, Optional

__all__ = [
    "Span",
    "Tracer",
    "get_tracer",
    "set_tracer",
    "span",
    "start",
    "add_event",
    "enabled",
]

_current_span: "contextvars.ContextVar[Optional[Span]]" = contextvars.ContextVar(
    "repro_torch_obs_current_span", default=None
)


def _track_name() -> str:
    """Exporter track for a span started here: the running asyncio task if
    any (so concurrent requests get separate Perfetto rows), else the
    thread."""
    try:
        task = asyncio.current_task()
    except RuntimeError:
        task = None
    if task is not None:
        return f"task:{task.get_name()}"
    return f"thread:{threading.current_thread().name}"


class Span:
    """One traced interval.  Created by a :class:`Tracer`; see module docs
    for the start/end and context-propagation contract."""

    __slots__ = (
        "name", "span_id", "parent_id", "trace_id", "t0", "t1",
        "attrs", "track", "_tracer", "_token",
    )

    def __init__(
        self,
        tracer: "Tracer",
        name: str,
        span_id: int,
        parent_id: Optional[int],
        trace_id: int,
        t0: float,
        track: str,
        attrs: Optional[Dict[str, Any]] = None,
    ) -> None:
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.trace_id = trace_id
        self.t0 = t0
        self.t1: Optional[float] = None
        self.attrs: Dict[str, Any] = attrs or {}
        self.track = track
        self._tracer = tracer
        self._token: Optional[contextvars.Token] = None

    def set(self, **attrs: Any) -> "Span":
        """Attach attributes (merged; later calls win on key collision)."""
        self.attrs.update(attrs)
        return self

    def end(self, t1: Optional[float] = None) -> None:
        """Close the span and record it.  Thread-safe, idempotent; callable
        from a different thread than the one that started the span."""
        if self.t1 is None:
            self.t1 = self._tracer.now() if t1 is None else t1
            self._tracer._record(self)

    @property
    def duration(self) -> float:
        if self.t1 is None:
            return 0.0
        return self.t1 - self.t0

    def __enter__(self) -> "Span":
        self._token = _current_span.set(self)
        return self

    def __exit__(self, *exc: Any) -> None:
        if self._token is not None:
            _current_span.reset(self._token)
            self._token = None
        self.end()

    def __bool__(self) -> bool:
        return True

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        state = f"{self.duration * 1e3:.3f}ms" if self.t1 else "open"
        return f"<Span {self.name!r} #{self.span_id} {state}>"

    def to_dict(self) -> Dict[str, Any]:
        """JSON-serializable form (the JSONL dump / ``convert`` format)."""
        return {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "trace_id": self.trace_id,
            "t0": self.t0,
            "t1": self.t1,
            "track": self.track,
            "attrs": self.attrs,
        }


class _NullSpan:
    """Shared do-nothing span returned by disabled tracers.  Falsy, so call
    sites can skip attribute computation with ``if sp:``."""

    __slots__ = ()

    def set(self, **attrs: Any) -> "_NullSpan":
        return self

    def end(self, t1: Optional[float] = None) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> None:
        pass

    def __bool__(self) -> bool:
        return False

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return "<NullSpan>"


NULL_SPAN = _NullSpan()


class Tracer:
    """Span factory + bounded ring buffer (see module docstring).

    ``enabled=False`` (the default for the global tracer) makes every
    entry point a near-zero no-op; flipping :meth:`enable`/:meth:`disable`
    at runtime is safe — spans already open finish normally.
    """

    #: the tracer clock — one source for spans AND the service metrics
    now = staticmethod(time.monotonic)

    def __init__(self, *, enabled: bool = False, capacity: int = 65536) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.enabled = bool(enabled)
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._spans: "deque[Span]" = deque(maxlen=self.capacity)
        self.dropped = 0
        self._ids = itertools.count(1)

    # -- lifecycle ---------------------------------------------------------
    def enable(self) -> "Tracer":
        self.enabled = True
        return self

    def disable(self) -> "Tracer":
        self.enabled = False
        return self

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self.dropped = 0

    # -- span creation -----------------------------------------------------
    def span(self, name: str, **attrs: Any):
        """Context-manager span: sets the context parent while entered."""
        if not self.enabled:
            return NULL_SPAN
        return self._make(name, _current_span.get(), attrs)

    def start(self, name: str, *, parent: Optional[Span] = None, **attrs: Any):
        """Explicit-lifetime span: does NOT touch the context var; close it
        with ``.end()`` from any thread.  ``parent`` overrides the current
        context parent (pass a span captured on the event loop to parent
        work running in a pool thread)."""
        if not self.enabled:
            return NULL_SPAN
        if parent is None:
            parent = _current_span.get()
        return self._make(name, parent, attrs)

    def _make(
        self, name: str, parent: Optional[Span], attrs: Dict[str, Any]
    ) -> Span:
        if isinstance(parent, _NullSpan):
            parent = None
        sid = next(self._ids)
        if parent is not None:
            pid: Optional[int] = parent.span_id
            tid = parent.trace_id
        else:
            pid, tid = None, sid
        return Span(self, name, sid, pid, tid, self.now(), _track_name(), attrs)

    def add_event(
        self,
        name: str,
        t0: float,
        t1: float,
        *,
        parent: Optional[Span] = None,
        **attrs: Any,
    ) -> None:
        """Record a finished span retroactively from timestamps already in
        hand (tracer-clock seconds) — e.g. the queue-wait interval between a
        request's enqueue stamp and its batch dispatch."""
        if not self.enabled:
            return
        if parent is None:
            parent = _current_span.get()
        sp = self._make(name, parent, attrs)
        sp.t0 = t0
        sp.t1 = t1
        self._record(sp)

    @contextlib.contextmanager
    def attach(self, parent: Optional[Span]) -> Iterator[None]:
        """Make ``parent`` the context parent for this block — the bridge
        for work dispatched onto pool threads, which don't inherit the
        submitting context.  A ``None``/null parent leaves context alone."""
        if not self.enabled or parent is None or isinstance(parent, _NullSpan):
            yield
            return
        token = _current_span.set(parent)
        try:
            yield
        finally:
            _current_span.reset(token)

    def wrap(self, name: Optional[str] = None, **attrs: Any) -> Callable:
        """Decorator form: traces every call of the wrapped (a)sync function
        as one span named ``name`` (default: the function's qualname)."""

        def deco(fn: Callable) -> Callable:
            label = name or fn.__qualname__
            if asyncio.iscoroutinefunction(fn):

                @functools.wraps(fn)
                async def awrapper(*args: Any, **kwargs: Any):
                    with self.span(label, **attrs):
                        return await fn(*args, **kwargs)

                return awrapper

            @functools.wraps(fn)
            def wrapper(*args: Any, **kwargs: Any):
                with self.span(label, **attrs):
                    return fn(*args, **kwargs)

            return wrapper

        return deco

    # -- ring buffer -------------------------------------------------------
    def _record(self, sp: Span) -> None:
        with self._lock:
            if len(self._spans) == self.capacity:
                self.dropped += 1
            self._spans.append(sp)

    def spans(self) -> List[Span]:
        """Snapshot of the retained finished spans, oldest first."""
        with self._lock:
            return list(self._spans)

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    def current(self) -> Optional[Span]:
        """The context's current parent span (``None`` outside any span)."""
        sp = _current_span.get()
        return None if isinstance(sp, _NullSpan) else sp

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-name rollup over retained spans: count / total / mean / max
        (seconds) — what the CLI summary table prints."""
        agg: Dict[str, Dict[str, float]] = {}
        for sp in self.spans():
            d = agg.setdefault(
                sp.name, {"count": 0, "total_s": 0.0, "max_s": 0.0}
            )
            d["count"] += 1
            d["total_s"] += sp.duration
            if sp.duration > d["max_s"]:
                d["max_s"] = sp.duration
        for d in agg.values():
            d["mean_s"] = d["total_s"] / d["count"]
        return agg


# -- global tracer -----------------------------------------------------------
# Disabled by default: the instrumented layers call through these module
# functions, which cost one attribute check when tracing is off.  The service
# tier and CLI install an enabled tracer via set_tracer() (or pass their own
# Tracer straight to DatasetService).
_GLOBAL = Tracer(enabled=False)


def get_tracer() -> Tracer:
    return _GLOBAL


def set_tracer(tracer: Tracer) -> Tracer:
    """Install ``tracer`` as the process-global default; returns the old
    one (restore it in tests)."""
    global _GLOBAL
    old, _GLOBAL = _GLOBAL, tracer
    return old


def enabled() -> bool:
    return _GLOBAL.enabled


def span(name: str, **attrs: Any):
    """``with span("layer.op") as sp:`` against the global tracer."""
    t = _GLOBAL
    if not t.enabled:
        return NULL_SPAN
    return t.span(name, **attrs)


def start(name: str, *, parent: Optional[Span] = None, **attrs: Any):
    t = _GLOBAL
    if not t.enabled:
        return NULL_SPAN
    return t.start(name, parent=parent, **attrs)


def add_event(
    name: str, t0: float, t1: float, *, parent: Optional[Span] = None,
    **attrs: Any,
) -> None:
    t = _GLOBAL
    if t.enabled:
        t.add_event(name, t0, t1, parent=parent, **attrs)
