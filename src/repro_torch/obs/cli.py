"""Command-line front-end: ``python -m repro_torch.obs {summary,trace,convert,prom,overhead}``.

The counterpart of the JAX package's ``python -m repro.obs``, with its
subcommands, flags and exit status, over the port's tracer and exporters,
plus ``--device`` on the commands that drive a store (default ``cuda``: the
kernels on the card; ``cpu`` runs the plain versions).

* ``summary`` — per-span-name rollup table (count / total / mean / max) plus
  the live tradeoff snapshot; ``--synthetic`` builds a throwaway store and
  drives real service traffic through an enabled tracer first, so the
  command is a self-contained end-to-end exercise of the whole
  instrumentation path (the CI smoke step).  ``--trace-out`` additionally
  writes a Perfetto-loadable Chrome trace (validated before exit — a
  structurally broken export fails the command), ``--prom`` writes the
  Prometheus text exposition.
* ``trace OUT`` — synthetic exercise, write only the Chrome trace.
* ``convert IN OUT`` — spans JSONL (``dump_spans_jsonl`` format) → Chrome
  trace JSON, validated.
* ``prom`` — synthetic exercise, print the Prometheus exposition.
* ``overhead`` — the disabled-tracer overhead gate: measures warm-checkout
  latency, counts instrumentation points hit per warm checkout, measures
  the per-call cost of a disabled ``span()``, and fails (exit 1) if the
  projected overhead exceeds ``--budget-pct`` (default 2%).  Projection,
  not A/B timing: ``points × per_call_cost / warm_latency`` is robust to
  noisy CI runners, where two back-to-back timings of the same code easily
  differ by more than the budget.

Exit status: 0 = ok, 1 = gate/validation failure, 2 = usage error.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import tempfile
import time
from typing import Any, Dict, Optional, Tuple

from .export import (
    chrome_trace,
    dump_spans_jsonl,
    load_spans_jsonl,
    prometheus_text,
    validate_chrome_trace,
)
from .tracer import Tracer, get_tracer, set_tracer, span as _span


# -- synthetic self-exercise -------------------------------------------------
def _synthetic_traffic(root: str, device: str) -> Tuple[Tracer, Dict[str, Any]]:
    """Build a small store and drive real service traffic under an enabled
    tracer: commits, cold + warm + coalesced checkouts, a constrained
    repack, and an fsck sweep — every instrumented layer fires at least
    once.  Returns (tracer, service stats snapshot)."""
    import numpy as np
    import torch

    from ..analysis.cli import build_synthetic_store
    from ..core import OptimizeSpec
    from ..service.service import DatasetService

    repo = build_synthetic_store(root, device=device)

    async def drive() -> Dict[str, Any]:
        rng = np.random.RandomState(1)
        async with DatasetService(
            repo, readers=2, batch_window_s=0.001
        ) as svc:
            vids = sorted(repo.store.versions)
            await svc.checkout_many(vids)          # cold batch
            await svc.checkout_many(vids[:3] * 2)  # warm + coalesced
            tree = dict(await svc.checkout())
            w = tree["w"]
            noise = rng.randn(*w.shape).astype(np.float32)
            tree["w"] = w + torch.from_numpy(noise).to(w.dtype)
            await svc.commit(tree, message="synthetic update")
            await svc.checkout()                   # post-commit warm path
            await svc.repack(OptimizeSpec.problem(6, theta=10.0))
            await svc.checkout_many(vids[:2])
            await svc.fsck()
            return svc.stats()

    tracer = Tracer(enabled=True)
    old = set_tracer(tracer)
    try:
        stats = asyncio.run(drive())
    finally:
        set_tracer(old)
    return tracer, stats


def _exercise(args: argparse.Namespace) -> Tuple[Tracer, Dict[str, Any]]:
    with tempfile.TemporaryDirectory() as td:
        return _synthetic_traffic(td, args.device)


# -- rendering ---------------------------------------------------------------
def _summary_table(tracer: Tracer) -> str:
    rows = sorted(
        tracer.summary().items(), key=lambda kv: -kv[1]["total_s"]
    )
    name_w = max([len(n) for n, _ in rows] + [len("span")])
    lines = [
        f"{'span':<{name_w}}  {'count':>6}  {'total_ms':>10}  "
        f"{'mean_ms':>9}  {'max_ms':>9}"
    ]
    for name, d in rows:
        lines.append(
            f"{name:<{name_w}}  {int(d['count']):>6}  "
            f"{d['total_s'] * 1e3:>10.3f}  {d['mean_s'] * 1e3:>9.3f}  "
            f"{d['max_s'] * 1e3:>9.3f}"
        )
    return "\n".join(lines)


def _tradeoff_block(stats: Dict[str, Any]) -> str:
    trade = stats.get("tradeoff") or {}
    latest = trade.get("latest")
    if not latest:
        return "tradeoff: no samples"
    lines = [
        "tradeoff (latest sample, event=%s):" % latest["event"],
        f"  versions={latest['versions']}  "
        f"storage={latest['storage_bytes_total']}B "
        f"(full={latest['storage_bytes_full']}B x{latest['full_objects']}, "
        f"delta={latest['storage_bytes_delta']}B x{latest['delta_objects']})",
        f"  recreation_s p50={latest['recreation_p50_s']:.4g} "
        f"p99={latest['recreation_p99_s']:.4g} "
        f"max={latest['recreation_max_s']:.4g}  "
        f"access_weighted_sum={latest['access_weighted_recreation_s']:.4g}  "
        f"max_chain_depth={latest['max_chain_depth']}",
    ]
    drift = trade.get("drift")
    if drift and drift.get("access_weighted_recreation_ratio") is not None:
        lines.append(
            f"  drift vs {drift['baseline_event']} baseline: "
            f"storage {drift['storage_ratio']:.3f}x, "
            f"access-weighted R "
            f"{drift['access_weighted_recreation_ratio']:.3f}x "
            f"(+{drift['versions_added']} versions)"
        )
    return "\n".join(lines)


def _write_trace(tracer: Tracer, path: str) -> int:
    chrome_trace(tracer, path)
    problems = validate_chrome_trace(path)
    if problems:
        print(f"trace validation FAILED for {path}:", file=sys.stderr)
        for p in problems:
            print(f"  - {p}", file=sys.stderr)
        return 1
    print(f"wrote {path} ({len(tracer)} spans, Perfetto-loadable)")
    return 0


# -- commands ----------------------------------------------------------------
def _cmd_summary(args: argparse.Namespace) -> int:
    if not args.synthetic:
        print(
            "summary: only --synthetic mode is available from the CLI (a "
            "live tracer exists only inside the traced process; export one "
            "with dump_spans_jsonl and use 'convert')",
            file=sys.stderr,
        )
        return 2
    tracer, stats = _exercise(args)
    if args.json:
        print(json.dumps({
            "spans": tracer.summary(),
            "tradeoff": stats.get("tradeoff"),
            "counters": stats.get("counters"),
        }, indent=2, sort_keys=True))
    else:
        print(_summary_table(tracer))
        print()
        print(_tradeoff_block(stats))
    rc = 0
    if args.trace_out:
        rc = max(rc, _write_trace(tracer, args.trace_out))
    if args.prom:
        with open(args.prom, "w") as f:
            f.write(prometheus_text(stats))
        print(f"wrote {args.prom}")
    return rc


def _cmd_trace(args: argparse.Namespace) -> int:
    tracer, _ = _exercise(args)
    if args.spans_out:
        n = dump_spans_jsonl(tracer, args.spans_out)
        print(f"wrote {args.spans_out} ({n} spans, JSONL)")
    return _write_trace(tracer, args.out)


def _cmd_convert(args: argparse.Namespace) -> int:
    rows = load_spans_jsonl(args.inp)
    chrome_trace(rows, args.out)
    problems = validate_chrome_trace(args.out)
    if problems:
        print(f"convert: output failed validation:", file=sys.stderr)
        for p in problems:
            print(f"  - {p}", file=sys.stderr)
        return 1
    print(f"converted {len(rows)} spans -> {args.out}")
    return 0


def _cmd_prom(args: argparse.Namespace) -> int:
    _, stats = _exercise(args)
    sys.stdout.write(prometheus_text(stats))
    return 0


def _cmd_overhead(args: argparse.Namespace) -> int:
    """Disabled-tracer overhead gate (see module docstring)."""
    import numpy as np

    from ..store.version_store import VersionStore

    assert not get_tracer().enabled, "overhead gate needs tracing disabled"
    with tempfile.TemporaryDirectory() as td:
        store = VersionStore(td, device=args.device, access_flush_every=10**9)
        rng = np.random.RandomState(0)
        tree = {"w": rng.randn(128, 128).astype(np.float32)}
        vid = store.commit(tree, message="base")
        for i in range(args.chain):
            t = dict(tree)
            w = t["w"].copy()
            w[i % 128, :8] += 1.0
            t["w"] = w
            tree = t
            vid = store.commit(tree, parents=[vid], message=f"step {i}")

        store.checkout(vid)  # warm the cache
        # 1) warm-checkout latency (the protected quantity)
        reps = args.reps
        t0 = time.perf_counter()
        for _ in range(reps):
            store.checkout(vid)
        warm_s = (time.perf_counter() - t0) / reps

        # 2) instrumentation points hit per warm checkout
        probe = Tracer(enabled=True)
        old = set_tracer(probe)
        try:
            store.checkout(vid)
        finally:
            set_tracer(old)
        points = len(probe)

        # 3) per-call cost of a disabled span()
        calls = 200_000
        t0 = time.perf_counter()
        for _ in range(calls):
            _span("overhead.probe")
        per_call_s = (time.perf_counter() - t0) / calls

    overhead_pct = 100.0 * points * per_call_s / warm_s if warm_s > 0 else 0.0
    out = {
        "warm_checkout_us": round(warm_s * 1e6, 3),
        "instrumentation_points": points,
        "disabled_span_ns": round(per_call_s * 1e9, 3),
        "overhead_pct": round(overhead_pct, 5),
        "budget_pct": args.budget_pct,
    }
    print(json.dumps(out, indent=2))
    if overhead_pct > args.budget_pct:
        print(
            f"overhead gate FAILED: {overhead_pct:.4f}% > "
            f"{args.budget_pct}% budget",
            file=sys.stderr,
        )
        return 1
    print(
        f"overhead gate ok: {points} points x {per_call_s * 1e9:.0f}ns "
        f"= {overhead_pct:.4f}% of a {warm_s * 1e6:.0f}us warm checkout "
        f"(budget {args.budget_pct}%)"
    )
    return 0


def _device_arg(s: argparse.ArgumentParser) -> None:
    s.add_argument("--device", default="cuda",
                   help="where the store's kernels run: cuda (default; raises "
                        "without a card) or cpu (the plain versions)")


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Observability tooling: span-trace summaries, Chrome "
                    "trace / Prometheus exports, and the disabled-tracer "
                    "overhead gate.",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("summary", help="per-span rollup + tradeoff snapshot")
    s.set_defaults(fn=_cmd_summary)
    s.add_argument("--synthetic", action="store_true",
                   help="build a throwaway store and drive traced service "
                        "traffic (the CI self-exercise)")
    s.add_argument("--trace-out", default=None, metavar="PATH",
                   help="also write a validated Chrome trace JSON")
    s.add_argument("--prom", default=None, metavar="PATH",
                   help="also write the Prometheus text exposition")
    s.add_argument("--json", action="store_true",
                   help="machine-readable summary on stdout")
    _device_arg(s)

    s = sub.add_parser("trace", help="synthetic exercise -> Chrome trace")
    s.set_defaults(fn=_cmd_trace, synthetic=True)
    s.add_argument("out", help="Chrome trace JSON output path")
    s.add_argument("--spans-out", default=None, metavar="PATH",
                   help="also dump raw spans as JSONL ('convert' input)")
    _device_arg(s)

    s = sub.add_parser("convert", help="spans JSONL -> Chrome trace JSON")
    s.set_defaults(fn=_cmd_convert)
    s.add_argument("inp", help="spans JSONL (dump_spans_jsonl format)")
    s.add_argument("out", help="Chrome trace JSON output path")

    s = sub.add_parser("prom", help="synthetic exercise -> Prometheus text")
    s.set_defaults(fn=_cmd_prom, synthetic=True)
    _device_arg(s)

    s = sub.add_parser("overhead",
                       help="fail if disabled-tracer overhead exceeds budget")
    s.set_defaults(fn=_cmd_overhead)
    s.add_argument("--budget-pct", type=float, default=2.0,
                   help="max projected overhead, %% of warm-checkout latency "
                        "(default 2.0)")
    s.add_argument("--chain", type=int, default=16,
                   help="delta-chain length of the microbench store")
    s.add_argument("--reps", type=int, default=200,
                   help="warm-checkout timing repetitions")
    _device_arg(s)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":  # pragma: no cover - module entry
    sys.exit(main())
