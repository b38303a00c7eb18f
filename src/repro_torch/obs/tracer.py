"""Span tracer: nested wall-clock intervals around the store's layers.

The port's own copy of the span API that the store uses (the JAX package's
``repro.obs.tracer``): a span is an interval ``[t0, t1)`` on
``time.monotonic`` plus a ``name``, an ``attrs`` dict and parent/trace ids.
Parenthood propagates through a ``contextvars.ContextVar``: entering a span
(``with span("x"):``) makes it the parent of anything opened in the same
context.  A span may be *started* in one place and *ended* in another
(``sp = start("x")`` ... ``sp.end()``); ``end`` is thread-safe and
idempotent.

The process-global tracer is disabled by default: ``span()``/``start()``
then return a shared, falsy no-op span after one attribute check, so call
sites guard attribute computation with ``if sp: sp.set(...)``.  Install an
enabled :class:`Tracer` with :func:`set_tracer` to record spans into its
bounded ring buffer.
"""

from __future__ import annotations

import contextvars
import itertools
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = ["Span", "Tracer", "get_tracer", "set_tracer", "span", "start"]

_current_span: "contextvars.ContextVar[Optional[Span]]" = contextvars.ContextVar(
    "repro_torch_obs_current_span", default=None
)


class Span:
    """One traced interval; created by a :class:`Tracer`."""

    __slots__ = (
        "name", "span_id", "parent_id", "trace_id", "t0", "t1", "attrs",
        "_tracer", "_token",
    )

    def __init__(
        self,
        tracer: "Tracer",
        name: str,
        span_id: int,
        parent_id: Optional[int],
        trace_id: int,
        t0: float,
        attrs: Optional[Dict[str, Any]] = None,
    ) -> None:
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.trace_id = trace_id
        self.t0 = t0
        self.t1: Optional[float] = None
        self.attrs: Dict[str, Any] = attrs or {}
        self._tracer = tracer
        self._token: Optional[contextvars.Token] = None

    def set(self, **attrs: Any) -> "Span":
        """Attach attributes (merged; later calls win on key collision)."""
        self.attrs.update(attrs)
        return self

    def end(self) -> None:
        """Close the span and record it.  Thread-safe, idempotent."""
        if self.t1 is None:
            self.t1 = self._tracer.now()
            self._tracer._record(self)

    @property
    def duration(self) -> float:
        return 0.0 if self.t1 is None else self.t1 - self.t0

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


class _NullSpan:
    """Shared do-nothing span returned while tracing is off.  Falsy."""

    __slots__ = ()

    def set(self, **attrs: Any) -> "_NullSpan":
        return self

    def end(self) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> None:
        pass

    def __bool__(self) -> bool:
        return False


NULL_SPAN = _NullSpan()


class Tracer:
    """Span factory plus a bounded ring buffer of finished spans."""

    now = staticmethod(time.monotonic)

    def __init__(self, *, enabled: bool = False, capacity: int = 65536) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._spans: "deque[Span]" = deque(maxlen=int(capacity))
        self._ids = itertools.count(1)

    def span(self, name: str, **attrs: Any):
        """Context-manager span: the context parent while entered."""
        if not self.enabled:
            return NULL_SPAN
        return self._make(name, attrs)

    def start(self, name: str, **attrs: Any):
        """Explicit-lifetime span: does not touch the context; close it with
        ``.end()``."""
        if not self.enabled:
            return NULL_SPAN
        return self._make(name, attrs)

    def _make(self, name: str, attrs: Dict[str, Any]) -> Span:
        parent = _current_span.get()
        sid = next(self._ids)
        if parent is not None:
            pid: Optional[int] = parent.span_id
            tid = parent.trace_id
        else:
            pid, tid = None, sid
        return Span(self, name, sid, pid, tid, self.now(), attrs)

    def _record(self, sp: Span) -> None:
        with self._lock:
            self._spans.append(sp)

    def spans(self) -> List[Span]:
        """Snapshot of the retained finished spans, oldest first."""
        with self._lock:
            return list(self._spans)


# Disabled by default: the store calls through these module functions, which
# cost one attribute check when tracing is off.
_GLOBAL = Tracer(enabled=False)


def get_tracer() -> Tracer:
    return _GLOBAL


def set_tracer(tracer: Tracer) -> Tracer:
    """Install ``tracer`` as the process-global default; returns the old one."""
    global _GLOBAL
    old, _GLOBAL = _GLOBAL, tracer
    return old


def span(name: str, **attrs: Any):
    """``with span("layer.op") as sp:`` against the global tracer."""
    t = _GLOBAL
    if not t.enabled:
        return NULL_SPAN
    return t.span(name, **attrs)


def start(name: str, **attrs: Any):
    """Explicit-lifetime span against the global tracer."""
    t = _GLOBAL
    if not t.enabled:
        return NULL_SPAN
    return t.start(name, **attrs)
