"""Trace/metric exporters: Chrome trace-event JSON and Prometheus text.

The port's own copy of the JAX package's ``repro.obs.export``: the same
events, validator and metric names (still prefixed ``repro_``), so dashboards
read either package's service alike.

Two output formats over the tracer/metrics state:

* :func:`chrome_trace` — the Chrome trace-event format (the ``trace_event``
  JSON Perfetto and ``chrome://tracing`` load).  Every finished span becomes
  one complete (``"ph": "X"``) event; tracks (one per thread/task, assigned
  at span start) become ``tid``\\ s with ``thread_name`` metadata events, so
  concurrent requests render as separate rows instead of interleaving.
  Timestamps are microseconds relative to the earliest span in the export
  (the tracer clock is ``time.monotonic``, so absolute values are
  meaningless across processes anyway).  ``pid`` groups spans from
  different runs/processes in one file (the serving benchmark exports its
  chain/global runs side by side this way).
* :func:`prometheus_text` — Prometheus/OpenMetrics-style text exposition
  over a ``DatasetService.stats()`` snapshot: counters → ``_total``
  counters, latency tracks → summaries (quantile samples + ``_count`` /
  ``_sum``), gauges / materializer stats / tradeoff samples → gauges.
  Metric names are sanitized (``[^a-zA-Z0-9_]`` → ``_``) and prefixed
  ``repro_``.

:func:`validate_chrome_trace` is the CI contract: it checks the structural
invariants Perfetto needs (event list, required keys, non-negative
``ts``/``dur``, integer pids/tids, metadata naming every tid) and returns a
list of problems — empty means loadable.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Sequence, Union

from .tracer import Span, Tracer

__all__ = [
    "chrome_trace",
    "validate_chrome_trace",
    "prometheus_text",
    "dump_spans_jsonl",
    "load_spans_jsonl",
]

_SpanLike = Union[Span, Dict[str, Any]]


def _as_dict(sp: _SpanLike) -> Dict[str, Any]:
    return sp.to_dict() if isinstance(sp, Span) else sp


def chrome_trace(
    spans: Union[Tracer, Iterable[_SpanLike]],
    path: Union[str, Path, None] = None,
    *,
    pid: int = 1,
    process_name: str = "repro",
    base: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Render spans as a Chrome trace-event JSON object (optionally written
    to ``path``).

    ``base`` merges these events into an existing export (pass the previous
    call's return value with a different ``pid`` to put several runs in one
    file — each shows up as its own process group in Perfetto).
    """
    if isinstance(spans, Tracer):
        spans = spans.spans()
    rows = [_as_dict(s) for s in spans]
    rows = [r for r in rows if r.get("t1") is not None]
    rows.sort(key=lambda r: r["t0"])

    out = base if base is not None else {"traceEvents": [], "displayTimeUnit": "ms"}
    events: List[Dict[str, Any]] = out["traceEvents"]

    # one time origin per file: fixed by the first export into it, so a
    # later run merged with base= lands to the right of the first (the
    # tracer clock is monotonic within the process)
    t_min = out.get("_origin_s")
    if t_min is None:
        t_min = out["_origin_s"] = min((r["t0"] for r in rows), default=0.0)

    events.append({
        "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
        "ts": 0, "args": {"name": process_name},
    })
    tids: Dict[str, int] = {}
    for r in rows:
        track = r.get("track") or "thread:?"
        tid = tids.get(track)
        if tid is None:
            tid = tids[track] = len(tids) + 1
            events.append({
                "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "ts": 0, "args": {"name": track},
            })
        args = {
            k: v for k, v in (r.get("attrs") or {}).items()
        }
        args["span_id"] = r["span_id"]
        if r.get("parent_id") is not None:
            args["parent_id"] = r["parent_id"]
        events.append({
            "ph": "X",
            "name": r["name"],
            "cat": r["name"].split(".", 1)[0],
            "pid": pid,
            "tid": tid,
            "ts": round(max(0.0, r["t0"] - t_min) * 1e6, 3),
            "dur": round((r["t1"] - r["t0"]) * 1e6, 3),
            "args": args,
        })

    if path is not None:
        Path(path).write_text(
            json.dumps(_strip_private(out), indent=None, separators=(",", ":"))
            + "\n"
        )
    return out


def _strip_private(trace: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v for k, v in trace.items() if not k.startswith("_")}


def validate_chrome_trace(
    trace: Union[str, Path, Dict[str, Any]]
) -> List[str]:
    """Structural validation of a Chrome trace export (see module docs).
    Accepts a path, a JSON string, or the parsed object; returns a list of
    problems — empty means Perfetto-loadable."""
    if isinstance(trace, Path) or (
        isinstance(trace, str) and "\n" not in trace and not trace.lstrip().startswith("{")
    ):
        try:
            trace = json.loads(Path(trace).read_text())
        except (OSError, json.JSONDecodeError) as e:
            return [f"unreadable trace file: {e}"]
    elif isinstance(trace, str):
        try:
            trace = json.loads(trace)
        except json.JSONDecodeError as e:
            return [f"invalid JSON: {e}"]

    problems: List[str] = []
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        return ["top level must be an object with a 'traceEvents' array"]
    events = trace["traceEvents"]
    if not isinstance(events, list):
        return ["'traceEvents' must be an array"]
    named_tids: Dict[int, set] = {}
    used_tids: Dict[int, set] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event[{i}]: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "M", "B", "E", "i", "C"):
            problems.append(f"event[{i}]: unknown phase {ph!r}")
            continue
        for key in ("name", "pid", "tid"):
            if key not in ev:
                problems.append(f"event[{i}]: missing {key!r}")
        if not isinstance(ev.get("pid"), int) or not isinstance(ev.get("tid"), int):
            problems.append(f"event[{i}]: pid/tid must be integers")
            continue
        if ph == "M":
            if ev.get("name") == "thread_name":
                named_tids.setdefault(ev["pid"], set()).add(ev["tid"])
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"event[{i}]: ts must be a number >= 0, got {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(
                    f"event[{i}]: X event needs dur >= 0, got {dur!r}"
                )
            used_tids.setdefault(ev["pid"], set()).add(ev["tid"])
    for pid, tids in used_tids.items():
        missing = tids - named_tids.get(pid, set())
        if missing:
            problems.append(
                f"pid {pid}: tids {sorted(missing)} have no thread_name "
                f"metadata"
            )
    return problems


# -- Prometheus text ---------------------------------------------------------
_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _metric_name(*parts: str) -> str:
    return _NAME_RE.sub("_", "_".join(("repro",) + parts))


def prometheus_text(snapshot: Dict[str, Any]) -> str:
    """Render a ``DatasetService.stats()``-shaped snapshot (``counters`` /
    ``tracks`` / ``gauges`` / ``store`` / ``tradeoff`` sub-dicts, each
    optional) as Prometheus text exposition."""
    lines: List[str] = []

    def emit(name: str, value: Any, mtype: str, labels: str = "",
             suffix: str = "") -> None:
        if not any(l.startswith(f"# TYPE {name} ") for l in lines):
            lines.append(f"# TYPE {name} {mtype}")
        lines.append(f"{name}{suffix}{labels} {value}")

    for key, val in sorted((snapshot.get("counters") or {}).items()):
        emit(_metric_name(key, "total"), val, "counter")

    for key, tr in sorted((snapshot.get("tracks") or {}).items()):
        name = _metric_name(key, "seconds")
        count = tr.get("count", 0)
        lines.append(f"# TYPE {name} summary")
        for q, field in (("0.5", "p50_ms"), ("0.99", "p99_ms")):
            if field in tr:
                lines.append(
                    f'{name}{{quantile="{q}"}} {tr[field] / 1e3:.9g}'
                )
        lines.append(f"{name}_count {count}")
        if "mean_ms" in tr:
            lines.append(
                f"{name}_sum {tr['mean_ms'] / 1e3 * count:.9g}"
            )
        else:
            lines.append(f"{name}_sum 0")

    for key, val in sorted((snapshot.get("gauges") or {}).items()):
        emit(_metric_name(key), val, "gauge")

    store = snapshot.get("store") or {}
    for key, val in sorted(store.items()):
        emit(_metric_name("store", key), val, "gauge")

    trade = snapshot.get("tradeoff") or {}
    latest = trade.get("latest") or {}
    if latest:
        name = _metric_name("tradeoff", "storage_bytes")
        lines.append(f"# TYPE {name} gauge")
        lines.append(
            f'{name}{{kind="full"}} {latest.get("storage_bytes_full", 0)}'
        )
        lines.append(
            f'{name}{{kind="delta"}} {latest.get("storage_bytes_delta", 0)}'
        )
        name = _metric_name("tradeoff", "objects")
        lines.append(f"# TYPE {name} gauge")
        lines.append(f'{name}{{kind="full"}} {latest.get("full_objects", 0)}')
        lines.append(f'{name}{{kind="delta"}} {latest.get("delta_objects", 0)}')
        name = _metric_name("tradeoff", "recreation_seconds")
        lines.append(f"# TYPE {name} gauge")
        for q, field in (("0.5", "recreation_p50_s"),
                         ("0.99", "recreation_p99_s"),
                         ("max", "recreation_max_s")):
            lines.append(
                f'{name}{{quantile="{q}"}} {latest.get(field, 0.0):.9g}'
            )
        emit(
            _metric_name("tradeoff", "sum_recreation_seconds"),
            f"{latest.get('recreation_sum_s', 0.0):.9g}", "gauge",
        )
        emit(
            _metric_name("tradeoff", "access_weighted_recreation_seconds"),
            f"{latest.get('access_weighted_recreation_s', 0.0):.9g}", "gauge",
        )
    drift = trade.get("drift") or {}
    for key in ("storage_ratio", "access_weighted_recreation_ratio"):
        if key in drift and drift[key] is not None:
            emit(
                _metric_name("tradeoff_drift", key), f"{drift[key]:.9g}",
                "gauge",
            )
    return "\n".join(lines) + "\n"


# -- raw span dump / convert -------------------------------------------------
def dump_spans_jsonl(
    spans: Union[Tracer, Sequence[_SpanLike]], path: Union[str, Path]
) -> int:
    """Write spans as one-JSON-object-per-line (the ``convert`` input
    format); returns the number written."""
    if isinstance(spans, Tracer):
        spans = spans.spans()
    rows = [_as_dict(s) for s in spans]
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r, separators=(",", ":")) + "\n")
    return len(rows)


def load_spans_jsonl(path: Union[str, Path]) -> List[Dict[str, Any]]:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows
