"""The port's observability copy against the JAX package's ``repro.obs``.

* tracer — the same span sequence, on the same clock readings, through both
  tracers gives equal spans and equal ``summary()``; ``attach`` and
  ``add_event`` parent correctly across a pool thread; tracks, the ring
  buffer and the disabled tracer behave as in the JAX package;
* exporters — ``prometheus_text`` of one snapshot is equal in both
  packages; the port's Chrome trace validates with both validators; JSONL
  round-trips;
* tradeoff — ``TradeoffMonitor`` samples of one store (committed by the JAX
  package, read by both) are equal in C, R and chain depth;
* the service under an enabled tracer: layer spans, span totals reconciling
  with the metrics tracks, the monitor's lifecycle and drift gauges;
* ``import repro_torch.service`` and ``repro_torch.analysis`` leave ``jax``
  out of ``sys.modules`` (in a subprocess, as tests/test_torch_store.py
  does).
"""

import asyncio
import itertools
import json
import os
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

import repro.obs as jobs
from repro.obs import TradeoffMonitor as JaxMonitor
from repro.store import Repository as JaxRepository
from repro_torch import obs
from repro_torch.service import DatasetService
from repro_torch.store import Repository, VersionStore
from test_torch_service import run

SRC = Path(__file__).resolve().parent.parent / "src"
LIMIT = 20.0


def payload(seed: int, shape=(32, 24)):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(*shape).astype(np.float32)}


def build_repo(tmp_path, versions=5):
    repo = Repository(tmp_path, device="cpu")
    for i in range(versions):
        repo.commit(payload(i), message=f"v{i}")
    return repo


def fixed_clock(tracer):
    """Make ``tracer`` read a deterministic clock: 0.0, 0.5, 1.0, ..."""
    ticks = itertools.count()
    tracer.now = lambda: next(ticks) * 0.5
    return tracer


def span_script(mod, tracer):
    """One span sequence, written against a package's obs module."""
    with tracer.span("svc.checkout", vid=3) as root:
        with tracer.span("mat.plan"):
            pass
        tracer.add_event("svc.queue_wait", 0.25, 0.75, parent=root, vid=3)
        sp = tracer.start("svc.batch", size=2)
        with tracer.attach(sp):
            with tracer.span("mat.checkout_many") as m:
                m.set(hits=1)
        sp.end()
    with tracer.span("svc.commit"):
        pass
    return [(s.name, s.span_id, s.parent_id, s.trace_id, s.t0, s.t1, s.attrs)
            for s in tracer.spans()]


class TestTracerAgainstJax:
    def test_same_sequence_same_spans_and_summary(self):
        jt = fixed_clock(jobs.Tracer(enabled=True))
        tt = fixed_clock(obs.Tracer(enabled=True))
        assert span_script(obs, tt) == span_script(jobs, jt)
        assert tt.summary() == jt.summary()
        assert set(tt.summary()["svc.checkout"]) == {"count", "total_s", "max_s", "mean_s"}

    def test_attach_and_add_event_parent_across_a_thread(self):
        tr = obs.Tracer(enabled=True)
        with ThreadPoolExecutor(max_workers=1) as pool:
            with tr.span("svc.request") as req:
                bsp = tr.start("svc.batch")

                def work():
                    assert tr.current() is None  # pools inherit no context
                    with tr.attach(bsp):
                        with tr.span("mat.decode"):
                            pass
                        tr.add_event("svc.decode", 1.0, 2.0, vids=1)
                    return threading.current_thread().name

                thread_name = pool.submit(work).result(timeout=LIMIT)
                bsp.end()
        by_name = {s.name: s for s in tr.spans()}
        assert by_name["mat.decode"].parent_id == by_name["svc.batch"].span_id
        assert by_name["svc.decode"].parent_id == by_name["svc.batch"].span_id
        assert by_name["svc.batch"].parent_id == req.span_id
        assert by_name["svc.decode"].duration == 1.0
        assert by_name["mat.decode"].track == f"thread:{thread_name}"

    def test_ring_buffer_and_disabled_tracer(self):
        tr = obs.Tracer(enabled=True, capacity=3)
        for i in range(5):
            with tr.span(f"s{i}"):
                pass
        assert [s.name for s in tr.spans()] == ["s2", "s3", "s4"] and tr.dropped == 2
        off = obs.Tracer()
        assert off.span("x") is obs.NULL_SPAN and not off.start("y")
        off.add_event("z", 0.0, 1.0)
        assert len(off) == 0

    def test_wrap_and_tracing_restores_the_global(self):
        before = obs.get_tracer()
        with obs.tracing() as tr:
            assert obs.enabled() and obs.get_tracer() is tr

            @tr.wrap("fn.sync")
            def f():
                return 1

            @tr.wrap()
            async def g():
                return 2

            assert f() == 1 and asyncio.run(g()) == 2
        assert obs.get_tracer() is before and not obs.enabled()
        assert {s.name for s in tr.spans()} == {"fn.sync", g.__wrapped__.__qualname__}


class TestExportersAgainstJax:
    def snapshot(self):
        return {
            "counters": {"checkout.batches": 3, "requests.checkout": 7},
            "tracks": {"latency.checkout": {"count": 7, "mean_ms": 1.5,
                                            "p50_ms": 1.2, "p99_ms": 4.0}},
            "gauges": {"tradeoff.storage_ratio": 1.25},
            "store": {"hits": 4, "misses": 3},
            "tradeoff": {
                "latest": {"storage_bytes_full": 10, "storage_bytes_delta": 5,
                           "full_objects": 1, "delta_objects": 2,
                           "recreation_p50_s": 0.01, "recreation_p99_s": 0.02,
                           "recreation_max_s": 0.03, "recreation_sum_s": 0.06,
                           "access_weighted_recreation_s": 0.015},
                "drift": {"storage_ratio": 1.25,
                          "access_weighted_recreation_ratio": None},
            },
        }

    def test_prometheus_text_equal(self):
        snap = self.snapshot()
        text = obs.prometheus_text(snap)
        assert text == jobs.prometheus_text(snap)
        assert "repro_checkout_batches_total 3" in text

    def test_chrome_trace_validates_in_both_packages(self, tmp_path):
        tt = fixed_clock(obs.Tracer(enabled=True))
        span_script(obs, tt)
        path = tmp_path / "trace.json"
        trace = obs.chrome_trace(tt, path)
        assert obs.validate_chrome_trace(path) == []
        assert jobs.validate_chrome_trace(path) == []
        jt = fixed_clock(jobs.Tracer(enabled=True))
        span_script(jobs, jt)
        assert json.dumps(obs.chrome_trace(tt)) == json.dumps(jobs.chrome_trace(jt))
        merged = obs.chrome_trace(tt, pid=2, base=trace)
        assert obs.validate_chrome_trace(merged) == []
        assert obs.validate_chrome_trace({"traceEvents": [{"ph": "X"}]})

    def test_jsonl_round_trip(self, tmp_path):
        tt = fixed_clock(obs.Tracer(enabled=True))
        span_script(obs, tt)
        path = tmp_path / "spans.jsonl"
        assert obs.dump_spans_jsonl(tt, path) == len(tt)
        rows = obs.load_spans_jsonl(path)
        assert obs.chrome_trace(rows) == obs.chrome_trace(tt)


class TestTradeoffAgainstJax:
    def test_samples_equal_on_one_store(self, tmp_path):
        root = tmp_path / "store"
        jrepo = JaxRepository(root)
        tree = payload(0, shape=(96, 64))  # 6 blocks: edits store as deltas
        for i in range(6):
            tree = dict(tree)
            w = tree["w"].copy()
            w[i, :3] += 1.0
            tree["w"] = w
            if i == 3:
                jrepo.branch("dev", at=2)
            jrepo.commit(tree, message=f"c{i}", branch="dev" if i == 3 else None)
        jrepo.checkout(4)  # an access, so the weights are not uniform
        jrepo.close()
        js = jobs.TradeoffMonitor(JaxRepository(root).store).sample()
        ts = obs.TradeoffMonitor(VersionStore(root, device="cpu")).sample()
        a, b = js.to_dict(), ts.to_dict()
        a.pop("timestamp"), b.pop("timestamp")
        assert b == a
        assert b["max_chain_depth"] >= 2 and b["delta_objects"] >= 4

    def test_store_hooks_and_baseline(self, tmp_path):
        repo = build_repo(tmp_path, versions=3)
        mon = obs.TradeoffMonitor(repo.store)
        repo.store.tradeoff_monitor = mon
        repo.commit(payload(7), message="x")
        assert mon.latest.event == "commit" and mon.latest.versions == 4
        from repro_torch.core import OptimizeSpec

        repo.repack(OptimizeSpec.problem(2))
        assert mon.baseline.event == "repack"
        assert mon.drift()["baseline_event"] == "repack"
        assert "post-repack" in mon.describe_drift()
        jmon = JaxMonitor(repo.store)  # the JAX monitor reads the same fields
        a, b = jmon.sample().to_dict(), mon.sample().to_dict()
        a.pop("timestamp"), b.pop("timestamp")
        assert a == b


class TestServiceUnderTracing:
    def test_spans_cover_layers_and_reconcile(self, tmp_path):
        repo = build_repo(tmp_path, versions=4)
        vids = sorted(repo.store.versions)

        async def go():
            async with DatasetService(repo, readers=2, batch_window_s=0.001) as svc:
                await svc.checkout_many(vids)
                await svc.checkout_many([vids[0]] * 3)
                await svc.commit(payload(50), message="append")
                await svc.fsck()
                return svc.stats()

        with obs.tracing() as tr:
            stats = run(go())
        names = {s.name for s in tr.spans()}
        assert {"svc.checkout", "svc.batch", "svc.queue_wait", "svc.decode",
                "svc.commit", "store.commit", "mat.checkout_many", "mat.plan",
                "svc.fsck_sweep", "svc.quiesce"} <= names
        summary = tr.summary()
        for span_name, track in (("svc.queue_wait", "queue_wait"), ("svc.decode", "decode")):
            tk = stats["tracks"][track]
            assert summary[span_name]["count"] == tk["count"]
            assert summary[span_name]["total_s"] == pytest.approx(
                tk["mean_ms"] * tk["count"] / 1e3, rel=0.05)
        by_id = {s.span_id: s for s in tr.spans()}
        for s in tr.spans():
            if s.name == "svc.queue_wait":
                assert by_id[s.parent_id].name == "svc.checkout"
        assert obs.validate_chrome_trace(obs.chrome_trace(tr)) == []
        text = obs.prometheus_text(stats)
        assert "repro_requests_checkout_total 7" in text
        assert text == jobs.prometheus_text(stats)

    def test_monitor_lifecycle_and_drift_gauges(self, tmp_path):
        repo = build_repo(tmp_path, versions=3)

        async def go():
            svc = DatasetService(repo, readers=1)
            await svc.start()
            assert repo.store.tradeoff_monitor is not None
            await svc.commit(payload(20), message="append")
            during = svc.stats()
            await svc.fsck()
            swept = svc.stats()
            await svc.stop()
            assert repo.store.tradeoff_monitor is None
            return during, swept, svc.stats()

        during, swept, after = run(go())
        trade = during["tradeoff"]
        assert trade["latest"]["event"] == "commit" and trade["latest"]["versions"] == 4
        assert trade["drift"]["baseline_event"] == "start"
        assert trade["drift"]["versions_added"] == 1
        g = swept["gauges"]
        assert g["tradeoff.storage_ratio"] >= 1.0 and g["tradeoff.versions_added"] == 1
        assert after["tradeoff"]["samples"] == swept["tradeoff"]["samples"]

    def test_tradeoff_opt_out(self, tmp_path):
        repo = build_repo(tmp_path, versions=2)

        async def go():
            async with DatasetService(repo, tradeoff=False) as svc:
                assert repo.store.tradeoff_monitor is None
                return svc.stats()

        assert "tradeoff" not in run(go())


def test_service_and_analysis_imports_leave_jax_out():
    code = (
        "import sys, repro_torch.service, repro_torch.analysis, repro_torch.obs,"
        " repro_torch.kernels.xor_delta, repro_torch.kernels.ops;"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')];"
        "assert not bad, bad"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
