"""Batched + coalesced dataset serving through the port's DatasetService
tier (the twin of ``examples/serve_batched.py``).

Builds a small branching version history, then fires concurrent checkout
traffic at the async service front-end to show its two de-duplication
mechanisms doing their job:

* **coalescing** — eight simultaneous requests for the same ref share one
  materialization (the ``checkout.coalesced`` counter accounts for 7 of 8);
  each client still gets a tree of its own to write into;
* **batching** — requests for distinct refs arriving within the batching
  window fold into a single ``checkout_many`` plan, so storage chains
  shared between the refs decode once.

Run:  PYTHONPATH=src python examples/serve_batched_torch.py [--device cpu]
(the default, ``cuda``, needs a card).
"""

import argparse
import asyncio
import tempfile

import numpy as np
import torch

from repro_torch.store.repository import Repository


def build_history(repo: Repository, versions: int = 12) -> None:
    rng = np.random.RandomState(0)
    tree = {"w": rng.randn(64, 48).astype(np.float32)}
    repo.commit(tree, message="root")
    for i in range(versions - 1):
        tree = {"w": tree["w"].copy()}
        tree["w"][i % 60 : i % 60 + 2] += rng.randn(2, 48).astype(np.float32)
        repo.commit(tree, message=f"step {i}")
    repo.tag("release", at=repo.resolve("main"))


async def serve(repo: Repository) -> dict:
    async with repo.serve(readers=4, batch_window_s=0.005) as svc:
        # 8 concurrent requests for one ref -> one decode, 7 coalesced
        trees = await asyncio.gather(
            *(svc.checkout("release") for _ in range(8))
        )
        assert all(torch.equal(t["w"], trees[0]["w"]) for t in trees)
        assert len({t["w"].data_ptr() for t in trees}) == 8, "clients share a tree"
        c = svc.metrics.counter
        facts = {"coalesced": c("checkout.coalesced"),
                 "materialized": c("checkout.batched_refs")}
        print(
            f"[coalesce] 8 concurrent checkout('release') -> "
            f"{facts['coalesced']} coalesced, "
            f"{facts['materialized']} materialized"
        )

        # distinct refs inside one batching window -> one folded plan
        before = c("checkout.batches")
        await svc.checkout_many([2, 4, 6, 8, 10])
        facts["batch_dispatches"] = c("checkout.batches") - before
        print(
            f"[batch] 5 distinct refs -> "
            f"{facts['batch_dispatches']} checkout_many dispatch(es)"
        )

        # the same refs again: all warm now, served from cache
        await svc.checkout_many([2, 4, 6, 8, 10])
        facts["warm_hits"] = c("checkout.warm_hits")
        print(
            f"[warm] repeat pass: {c('checkout.warm_hits')} warm hits, "
            f"{c('checkout.warm_misses')} misses overall"
        )

        lat = svc.metrics.track("latency.checkout")
        print(
            f"[latency] {lat['count']} checkouts: "
            f"p50 {lat['p50_ms']} ms, p99 {lat['p99_ms']} ms"
        )
        return facts


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the store's kernels run (default: cuda)")
    device = ap.parse_args(argv).device
    with tempfile.TemporaryDirectory() as root:
        repo = Repository(root, device=device)
        build_history(repo)
        facts = asyncio.run(serve(repo))
        repo.close()
    print("OK ✓")
    return facts


if __name__ == "__main__":
    main()
