"""End-to-end dataset serving on the PyTorch port: commits interleaved with
reads staying warm (the twin of ``examples/serve_dataset.py``).

The scenario the append-aware cache discipline exists for — a service
answering checkout traffic for a hot set of dataset versions while a
writer keeps committing new ones.  A commit only *appends* to the storage
graph, so under the per-entry chain-fingerprint discipline (the store
default) it invalidates nothing the readers are using: the hot set stays
warm across every write, and the materializer's ``invalidations`` counter
stays at zero.  A ``repack``, which rewrites chains wholesale, still
purges everything — the demo ends with one to show both sides.

The whole run executes under ``repro_torch.obs.tracing()``: every request
is traced end to end (enqueue → queue wait → batch fold → decode → device
launches), the service's ``TradeoffMonitor`` samples the
storage/recreation tradeoff on every commit and repack, and the demo
finishes by printing the tradeoff snapshot plus a per-span summary and
writing a Perfetto-loadable Chrome trace of everything it just did.

Run:  PYTHONPATH=src python examples/serve_dataset_torch.py [--device cpu]
      [--trace-out PATH]   (the default device, ``cuda``, needs a card)
"""

import argparse
import asyncio
import os
import tempfile

import numpy as np

from repro_torch import obs
from repro_torch.core import OptimizeSpec
from repro_torch.store.repository import Repository


async def run(repo: Repository) -> dict:
    rng = np.random.RandomState(0)
    async with repo.serve(readers=4, fsck_interval_s=0.25) as svc:
        # seed a hot set of versions and warm them
        tree = {"x": rng.randn(128, 32).astype(np.float32)}
        await svc.commit(tree, message="v0")
        for i in range(7):
            tree = {"x": tree["x"] + rng.randn(128, 32).astype(np.float32) * 0.1}
            await svc.commit(tree, message=f"v{i + 1}")
        hot = [1, 3, 5, 8]
        await svc.checkout_many(hot)

        # interleave: every round commits a fresh version, then re-reads the
        # hot set -- which stays served from cache across the writes
        for round_no in range(5):
            await svc.commit(
                {"x": rng.randn(128, 32).astype(np.float32)},
                message=f"append {round_no}",
            )
            await svc.checkout_many(hot)

        stats = svc.stats()
        store = stats["store"]
        c = stats["counters"]
        facts = {"invalidations": store["invalidations"],
                 "interleave_purges": store["purges"]}
        print(
            f"[interleave] {c['requests.commit']} commits between reads: "
            f"{c['checkout.warm_hits']} warm hits, "
            f"{store['invalidations']} invalidations, "
            f"{store['purges']} purges"
        )
        assert store["invalidations"] == 0 and store["purges"] == 0

        # background fsck has been sweeping the growing graph meanwhile
        await svc.fsck()
        print(
            f"[fsck] {svc.metrics.counter('fsck.sweeps')} sweep(s), "
            f"{svc.metrics.counter('fsck.findings')} finding(s)"
        )

        # a repack rewrites chains -> the cache purges wholesale, and the
        # next reads rebuild from the re-optimized storage
        await svc.repack(OptimizeSpec.problem(2))
        trees = await svc.checkout_many(hot)
        assert all(tuple(t["x"].shape) == (128, 32) for t in trees)
        purges = svc.stats()["store"]["purges"]
        facts["purges"] = purges
        print(f"[repack] storage re-optimized, cache purges={purges}")
        assert purges >= 1

        lat = svc.metrics.track("latency.checkout")
        print(
            f"[latency] {lat['count']} checkouts: "
            f"p50 {lat['p50_ms']} ms, p99 {lat['p99_ms']} ms"
        )

        # the TradeoffMonitor sampled the storage/recreation tradeoff on
        # every commit and again after the repack (Problems 5/6 objective)
        trade = svc.stats()["tradeoff"]
        latest = trade["latest"]
        print(
            f"[tradeoff] {latest['versions']} versions after "
            f"{trade['samples']} samples: "
            f"{latest['full_objects']} full + {latest['delta_objects']} delta "
            f"objects, access-weighted recreation "
            f"{latest['access_weighted_recreation_s'] * 1e3:.2f} ms"
        )
        print(f"[tradeoff] {repo.store.tradeoff_monitor.describe_drift()}")
        return facts


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="where the store's kernels and solvers run (default: cuda)")
    parser.add_argument(
        "--trace-out",
        default=os.path.join(tempfile.gettempdir(), "serve_dataset_torch_trace.json"),
        help="where to write the Perfetto-loadable Chrome trace",
    )
    args = parser.parse_args(argv)

    with obs.tracing() as tracer:
        with tempfile.TemporaryDirectory() as root:
            repo = Repository(root, device=args.device)
            facts = asyncio.run(run(repo))
            repo.close()

    summary = tracer.summary()
    print(f"[trace] {len(tracer)} spans across {len(summary)} names; top 5:")
    top = sorted(summary.items(), key=lambda kv: -kv[1]["total_s"])[:5]
    for name, s in top:
        print(f"  {name:<22} x{s['count']:<4} {s['total_s'] * 1e3:8.2f} ms")
    obs.chrome_trace(tracer, args.trace_out, process_name="serve_dataset")
    problems = obs.validate_chrome_trace(args.trace_out)
    assert not problems, problems
    print(f"[trace] wrote Perfetto trace to {args.trace_out}")
    print("OK ✓")
    return {**facts, "spans": len(tracer)}


if __name__ == "__main__":
    main()
