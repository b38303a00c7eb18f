"""The port's DatasetService on the CPU, and against the JAX package's.

The first classes follow tests/test_service.py at its small sizes, with the
port's repository on ``device="cpu"``: coalescing, batching into one
``checkout_many``, snapshot-consistent reads racing commits, repack
quiescing readers, a cancelled waiter that leaves the shared future alone,
``stop()`` draining, the fsck sweeper publishing findings, and a failed
kernel build that raises into the request's future.

``TestAgainstJax`` then drives one fixed request script, sequentially so
that it is deterministic, through the JAX ``DatasetService`` over a JAX
repository and through the port's over a port repository: the trees, logs,
diffs, new vids, the repack's storage and recreation figures and the fsck
reports must be equal.

No pytest-asyncio: each test runs its own loop with ``asyncio.run`` on a
thread joined with a deadline, and every wait is bounded by
``asyncio.wait_for``, so that a hang fails fast.
"""

import asyncio
import threading

import numpy as np
import pytest
import torch

import repro_torch.kernels as kernels
from repro.core import OptimizeSpec as JaxSpec
from repro.store import Repository as JaxRepository
from repro_torch.core import OptimizeSpec
from repro_torch.service import DatasetService, ServiceMetrics, percentile
from repro_torch.service.service import _AsyncRWLock
from repro_torch.store import Repository

LIMIT = 10.0  # seconds: any single await of these tests


def bounded(coro):
    return asyncio.wait_for(coro, LIMIT)


def run(coro):
    """``asyncio.run`` on a thread joined with a deadline: a loop that spins
    without yielding (so that no ``wait_for`` can fire) fails the test
    instead of hanging the suite."""
    out = {}

    def target():
        try:
            out["value"] = asyncio.run(bounded(coro))
        except BaseException as e:  # handed to the test's thread
            out["error"] = e

    worker = threading.Thread(target=target, daemon=True)
    worker.start()
    worker.join(2 * LIMIT)
    assert not worker.is_alive(), "the event loop never finished"
    if "error" in out:
        raise out["error"]
    return out["value"]


def payload(seed: int, shape=(32, 24)):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(*shape).astype(np.float32)}


def build_repo(tmp_path, versions=6):
    repo = Repository(tmp_path, device="cpu")
    trees = {}
    for i in range(versions):
        vid = repo.commit(payload(i), message=f"v{i}")
        trees[vid] = payload(i)
    return repo, trees


def same(tree, want) -> bool:
    return np.array_equal(np.asarray(tree["w"]), want["w"])


class TestCoalescingAndBatching:
    def test_concurrent_same_ref_single_materialization(self, tmp_path):
        repo, trees = build_repo(tmp_path)
        tip = repo.resolve("main")

        async def go():
            async with repo.serve(readers=4) as svc:
                out = await bounded(asyncio.gather(*(svc.checkout("main") for _ in range(10))))
                return out, svc.stats()

        out, stats = run(go())
        assert all(same(t, trees[tip]) for t in out)
        c = stats["counters"]
        assert c["requests.checkout"] == 10
        assert c["checkout.coalesced"] == 9
        assert c["checkout.batched_refs"] == 1
        assert stats["store"]["hits"] == 0
        assert all(isinstance(t["w"], torch.Tensor) for t in out)

    def test_each_request_gets_private_tree_dict(self, tmp_path):
        repo, _ = build_repo(tmp_path)

        async def go():
            async with repo.serve() as svc:
                return await bounded(asyncio.gather(svc.checkout("main"), svc.checkout("main")))

        a, b = run(go())
        assert a is not b
        a["extra"] = 1
        assert "extra" not in b

    def test_coalescing_keyed_by_vid_not_ref_spelling(self, tmp_path):
        repo, _ = build_repo(tmp_path)
        tip = repo.resolve("main")
        repo.tag("rel", at=tip)

        async def go():
            async with repo.serve() as svc:
                await bounded(asyncio.gather(
                    svc.checkout("main"), svc.checkout("rel"), svc.checkout(tip)))
                return svc.stats()["counters"]

        c = run(go())
        assert c["checkout.coalesced"] == 2
        assert c["checkout.batched_refs"] == 1

    def test_window_folds_distinct_refs_into_one_checkout_many(self, tmp_path):
        repo, trees = build_repo(tmp_path, versions=8)
        vids = sorted(trees)[:6]
        calls = []
        inner = repo.store.checkout_many

        def spy(vs):
            calls.append(list(vs))
            return inner(vs)

        repo.store.checkout_many = spy

        async def go():
            async with repo.serve(batch_window_s=0.05) as svc:
                out = await bounded(svc.checkout_many(vids))
                return out, svc.stats()["counters"]

        out, c = run(go())
        assert all(same(t, trees[v]) for t, v in zip(out, vids))
        assert c["checkout.batches"] == 1 and c["checkout.batched_refs"] == len(vids)
        assert calls == [vids]

    def test_max_batch_forces_early_dispatch(self, tmp_path):
        repo, trees = build_repo(tmp_path, versions=8)

        async def go():
            async with repo.serve(batch_window_s=30.0, max_batch=4) as svc:
                await bounded(svc.checkout_many(sorted(trees)[:4]))
                return svc.stats()["counters"]

        c = run(go())
        assert c["checkout.batches"] == 1 and c["checkout.batched_refs"] == 4

    def test_unknown_ref_rejects_without_poisoning_batch(self, tmp_path):
        repo, trees = build_repo(tmp_path)
        good = sorted(trees)[0]

        async def go():
            async with repo.serve(batch_window_s=0.02) as svc:
                ok, bad = await bounded(asyncio.gather(
                    svc.checkout(good), svc.checkout("no-such-branch"),
                    return_exceptions=True))
                return ok, bad, svc.stats()["counters"]

        ok, bad, c = run(go())
        assert same(ok, trees[good])
        assert isinstance(bad, ValueError)
        assert c["errors.checkout"] == 1


class TestWriteCoordination:
    def test_checkout_main_racing_commit_sees_old_or_new_tip(self, tmp_path):
        repo, trees = build_repo(tmp_path)
        old_tip = repo.resolve("main")
        fresh = payload(99)

        async def go():
            async with repo.serve(readers=3) as svc:
                results = await bounded(asyncio.gather(
                    *(svc.checkout("main") for _ in range(3)),
                    svc.commit(fresh, message="racing"),
                    *(svc.checkout("main") for _ in range(3)),
                ))
                after = await bounded(svc.checkout("main"))
                return results, after

        results, after = run(go())
        reads = results[:3] + results[4:]
        for t in reads:  # a whole old tip or a whole new one, never a mix
            assert same(t, trees[old_tip]) or same(t, fresh)
        assert same(after, fresh) and repo.resolve("main") == results[3]

    def test_reads_interleaved_with_commits_stay_correct(self, tmp_path):
        repo, trees = build_repo(tmp_path)
        hot = sorted(trees)

        async def go():
            async with repo.serve(readers=3) as svc:
                for i in range(3):
                    out = await bounded(asyncio.gather(
                        svc.commit(payload(100 + i), message=f"a{i}"),
                        *(svc.checkout(v) for v in hot)))
                    assert all(same(t, trees[v]) for t, v in zip(out[1:], hot))
                return svc.stats()["counters"]

        c = run(go())
        assert c["requests.commit"] == 3 and c.get("errors.checkout", 0) == 0

    def test_repack_quiesces_readers_and_trees_survive(self, tmp_path):
        repo, trees = build_repo(tmp_path, versions=8)
        vids = sorted(trees)
        active = {"readers": 0, "max_during_repack": 0}
        lock = threading.Lock()
        inner_many, inner_repack = repo.store.checkout_many, repo.repack

        def spy_many(vs):
            with lock:
                active["readers"] += 1
            try:
                return inner_many(vs)
            finally:
                with lock:
                    active["readers"] -= 1

        def spy_repack(spec, **kw):
            active["max_during_repack"] = max(active["max_during_repack"], active["readers"])
            return inner_repack(spec, **kw)

        repo.store.checkout_many, repo.repack = spy_many, spy_repack

        async def go():
            async with repo.serve(readers=3, batch_window_s=0.01) as svc:
                await bounded(svc.checkout_many(vids))  # warm
                reads = asyncio.gather(*(svc.checkout(v) for v in vids[::-1]))
                stats = await bounded(svc.repack(OptimizeSpec.problem(2)))
                await bounded(reads)
                out = await bounded(svc.checkout_many(vids))
                return stats, out, svc.stats()["store"]["purges"]

        stats, out, purges = run(go())
        assert active["max_during_repack"] == 0  # no decode ran under the rewrite
        assert purges >= 1 and stats["optimize"]["backend"] == "torch"
        assert all(same(t, trees[v]) for t, v in zip(out, vids))

    def test_repack_takes_an_optimize_spec(self, tmp_path):
        repo, _ = build_repo(tmp_path, versions=3)

        async def go():
            async with repo.serve() as svc:
                with pytest.raises(TypeError):
                    await bounded(svc.repack("lmg"))

        run(go())

    def test_log_and_diff_through_service(self, tmp_path):
        repo, trees = build_repo(tmp_path)
        vids = sorted(trees)

        async def go():
            async with repo.serve() as svc:
                return (await bounded(svc.log("main")),
                        await bounded(svc.diff(vids[0], vids[-1])))

        lg, d = run(go())
        assert lg[0].vid == vids[-1]
        assert "w" in d.changed

    def test_requests_refuse_before_start_and_after_stop(self, tmp_path):
        repo, _ = build_repo(tmp_path)

        async def before():
            with pytest.raises(RuntimeError, match="not started"):
                await DatasetService(repo).checkout("main")

        async def after():
            async with repo.serve() as svc:
                pass
            with pytest.raises(RuntimeError, match="not started"):
                await svc.checkout("main")

        run(before())
        run(after())

    def test_stop_drains_pending_batches(self, tmp_path):
        repo, trees = build_repo(tmp_path)
        vids = sorted(trees)

        async def go():
            svc = await repo.serve(batch_window_s=30.0).start()
            tasks = [asyncio.ensure_future(svc.checkout(v)) for v in vids]
            await asyncio.sleep(0.01)  # enqueued, the window far from closing
            assert len(svc._pending) == len(vids)
            await bounded(svc.stop())  # dispatches the window and waits
            assert all(t.done() for t in tasks)
            return [t.result() for t in tasks]

        out = run(go())
        assert all(same(t, trees[v]) for t, v in zip(out, vids))
        assert sum(repo.store.versions[v].access_count for v in vids) >= len(vids)


class TestCancellation:
    def test_cancelled_waiter_does_not_cancel_the_shared_future(self, tmp_path):
        repo, trees = build_repo(tmp_path)
        tip = repo.resolve("main")

        async def go():
            async with repo.serve(batch_window_s=0.05) as svc:
                tasks = [asyncio.create_task(svc.checkout("main")) for _ in range(4)]
                await asyncio.sleep(0.01)
                tasks[0].cancel()
                done = await bounded(asyncio.gather(*tasks, return_exceptions=True))
                late = await bounded(svc.checkout("main"))
                return done, late, svc.stats()["counters"]

        done, late, c = run(go())
        assert isinstance(done[0], asyncio.CancelledError)
        assert all(same(t, trees[tip]) for t in done[1:])
        assert same(late, trees[tip]) and c.get("errors.checkout", 0) == 0

    def test_cancel_during_write_acquire_releases_claim(self):
        async def go():
            lock = _AsyncRWLock()
            release = asyncio.Event()

            async def reader():
                async with lock.read():
                    await release.wait()

            r = asyncio.create_task(reader())
            await asyncio.sleep(0)

            async def writer():
                async with lock.write():
                    pass

            w = asyncio.create_task(writer())
            await asyncio.sleep(0.01)
            w.cancel()
            with pytest.raises(asyncio.CancelledError):
                await w
            release.set()
            await r
            async with lock.write():
                pass
            async with lock.read():
                pass
            return True

        assert run(go()) is True


class TestFailures:
    def test_failed_kernel_build_raises_into_the_future(self, tmp_path, monkeypatch):
        """A reader thread that builds the kernels first and fails must fail
        its batch's requests, release the build lock and not hang later
        requests."""
        repo, trees = build_repo(tmp_path)
        vid = sorted(trees)[0]
        inner = repo.store.checkout_many

        def broken_build():
            raise RuntimeError("nvcc failed with exit code 1 building delta_kernels.cu")

        def through_the_kernels(vs):
            kernels.library("delta_kernels")  # the first launch on a card
            return inner(vs)

        monkeypatch.setattr(kernels, "_libs", {})
        monkeypatch.setattr(kernels, "build", broken_build)
        repo.store.checkout_many = through_the_kernels

        async def go():
            async with repo.serve(readers=2) as svc:
                first = await bounded(asyncio.gather(
                    svc.checkout(vid), svc.checkout("main"), return_exceptions=True))
                again = await bounded(asyncio.gather(svc.checkout(vid), return_exceptions=True))
                repo.store.checkout_many = inner
                ok = await bounded(svc.checkout(vid))
                return first, again, ok, svc.stats()["counters"]

        first, again, ok, c = run(go())
        for r in first + again:
            assert isinstance(r, RuntimeError) and "nvcc failed" in str(r)
        assert not kernels._load_lock.locked()
        assert same(ok, trees[vid]) and c["errors.checkout"] == 3


class TestFsckSweep:
    def test_periodic_sweep_records_metrics(self, tmp_path):
        repo, _ = build_repo(tmp_path)

        async def go():
            async with repo.serve(fsck_interval_s=0.03) as svc:
                for _ in range(200):
                    if svc.metrics.counter("fsck.sweeps") >= 2:
                        break
                    await asyncio.sleep(0.02)
                return svc.stats(), svc.last_fsck

        stats, report = run(go())
        assert stats["counters"]["fsck.sweeps"] >= 2
        assert report is not None and not report.findings
        assert stats["fsck"]["checked"] > 0

    def test_sweeper_publishes_findings(self, tmp_path):
        repo, _ = build_repo(tmp_path)
        repo.store.objects.put(b"bytes no version references")

        async def go():
            async with repo.serve() as svc:
                report = await bounded(svc.fsck())
                return report, svc.stats()

        report, stats = run(go())
        assert [f.rule for f in report.findings] == ["fsck.orphan-object"]
        assert stats["counters"]["fsck.sweeps"] == 1
        assert stats["counters"]["fsck.findings"] == 1
        assert stats["fsck"]["findings"] == 1
        assert stats["gauges"]["tradeoff.versions_added"] == 0

    def test_constraint_drift_recommends_a_repack(self, tmp_path):
        repo, _ = build_repo(tmp_path, versions=4)
        repo.repack(OptimizeSpec.problem(6, theta=10.0))
        s = repo.store
        s.last_repack["constraints"] = [{"metric": "max_recreation", "bound": 0.0}]

        async def go():
            async with repo.serve() as svc:
                report = await bounded(svc.fsck())
                return report, svc.stats()["counters"]

        report, c = run(go())
        assert [f.rule for f in report.gating()] == ["fsck.constraint"]
        assert c["fsck.repack_recommended"] == 1


class TestMetrics:
    def test_percentile_nearest_rank(self):
        assert percentile(list(range(1, 101)), 50) in (50, 51)
        assert percentile([1, 2], 50) == 2  # half ranks round up
        with pytest.raises(ValueError):
            percentile([], 50)

    def test_track_window_bounded_but_totals_lifetime(self):
        m = ServiceMetrics(track_cap=10)
        for i in range(100):
            m.observe("lat", 0.001 * (i + 1))
        s = m.track("lat")
        assert s["count"] == 100 and s["p50_ms"] >= 90.0 and s["max_ms"] == 100.0

    def test_service_latency_tracks_populated(self, tmp_path):
        repo, _ = build_repo(tmp_path)

        async def go():
            async with repo.serve() as svc:
                await bounded(svc.checkout("main"))
                await bounded(svc.commit(payload(50), message="x"))
                return svc.stats()["tracks"]

        tracks = run(go())
        for name in ("latency.checkout", "latency.commit", "queue_wait", "decode"):
            assert tracks[name]["count"] == 1


# ----------------------------------------------------- against the JAX package
def jax_payload(seed):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(32, 24).astype(np.float32),
            "ids": rng.randint(0, 2**20, size=700).astype(np.int32)}


def edited(tree, i):
    tree = {k: np.array(v) for k, v in tree.items()}
    tree["w"][i % 32, :3] += 1.0
    return tree


async def request_script(svc, repo, spec):
    """One fixed, sequential script; returns what a client saw."""
    out = {"trees": [], "vids": []}
    tree = jax_payload(0)
    out["vids"].append(await bounded(svc.commit(tree, message="root")))
    for i in range(1, 6):
        tree = edited(tree, i)
        branch = "dev" if i == 4 else None
        if branch:
            repo.branch("dev", at=out["vids"][1])
        out["vids"].append(await bounded(svc.commit(tree, message=f"c{i}", branch=branch)))
    for ref in ["main", "dev", out["vids"][0], out["vids"][2]]:
        out["trees"].append(await bounded(svc.checkout(ref)))
    out["trees"] += await bounded(svc.checkout_many(out["vids"][::-1]))
    out["log"] = [(m.vid, m.parents, m.message, m.stored_base)
                  for m in await bounded(svc.log("main"))]
    d = await bounded(svc.diff(out["vids"][0], "dev"))
    out["diff"] = (d.a, d.b, d.added, d.removed, d.changed, d.unchanged, d.bytes_changed)
    theta = 1.2 * max(repo.store.recreation_cost(v) for v in repo.store.versions)
    rep = await bounded(svc.repack(spec.problem(6, theta=theta)))
    out["repack"] = (rep["before"], rep["after"], rep["gc_freed_bytes"],
                     rep["optimize"]["objective_value"])
    out["trees"] += await bounded(svc.checkout_many(out["vids"]))
    out["vids"].append(await bounded(svc.commit(edited(tree, 9), message="after")))
    report = await bounded(svc.fsck())
    out["fsck"] = sorted((f.rule, str(f.severity), f.subject) for f in report.findings)
    out["checked"] = report.checked
    out["counters"] = svc.stats()["counters"]
    return out


class TestAgainstJax:
    def test_same_request_script_same_results(self, tmp_path):
        async def drive(repo, spec):
            async with repo.serve(readers=2, batch_window_s=0.0) as svc:
                return await request_script(svc, repo, spec)

        jax_out = run(drive(JaxRepository(tmp_path / "jax"), JaxSpec))
        port_out = run(drive(Repository(tmp_path / "port", device="cpu"), OptimizeSpec))
        assert port_out["vids"] == jax_out["vids"]
        assert port_out["log"] == jax_out["log"]
        assert port_out["diff"] == jax_out["diff"]
        assert port_out["repack"] == jax_out["repack"]
        assert port_out["fsck"] == jax_out["fsck"] == []
        assert port_out["checked"] == jax_out["checked"]
        assert port_out["counters"] == jax_out["counters"]
        assert len(port_out["trees"]) == len(jax_out["trees"]) == 16
        for got, want in zip(port_out["trees"], jax_out["trees"]):
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == torch.from_numpy(np.array(want[k])).dtype
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
