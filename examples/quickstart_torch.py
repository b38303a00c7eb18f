"""Quickstart on the PyTorch port: the paper end to end (the port's twin of
``examples/quickstart.py``).

Canonical API tour, every solver and kernel on ``--device``:

1. Reproduces the paper's Figure 1 worked example with the declarative
   spec grid — every problem is ``optimize(graph, OptimizeSpec.problem(n))``.
2. Builds a synthetic versioned-dataset workload (paper §5.1), sweeps the
   grid, and prints the storage/recreation frontier.
3. Commits real tensor payloads through a ``Repository`` (named branches +
   tags over the VersionStore), repacks against a spec, and verifies
   checkouts are byte-identical.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
(the default, ``cuda``, needs a card).
"""

import argparse
import tempfile

import numpy as np
import torch

from repro_torch.core import (
    OptimizeSpec, VersionGraph, dc_like, generate, optimize,
)
from repro_torch.store import Repository


def figure1(device: str = "cuda") -> dict:
    print("=== Paper Figure 1 — the (objective, constraint) grid ===")
    g = VersionGraph(5, directed=True)
    for i, (s, r) in enumerate(
        [(10000, 10000), (10100, 10100), (9700, 9700), (9800, 9800), (10120, 10120)], 1
    ):
        g.set_materialization(i, s, r)
    g.set_delta(1, 2, 200, 350)
    g.set_delta(1, 3, 1000, 3000)
    g.set_delta(2, 4, 50, 200)
    g.set_delta(3, 5, 800, 2500)
    g.set_delta(2, 5, 200, 550)

    spt = optimize(g, OptimizeSpec.problem(2), device=device)       # min every R_i
    mca = optimize(g, OptimizeSpec.problem(1), device=device)       # min storage C
    print(f"  store-everything (Fig 1 ii):   C={spt.objective_values['storage']:>7.0f}  "
          f"maxR={spt.objective_values['max_recreation']:.0f}")
    print(f"  min-storage MCA  (Fig 1 iii):  C={mca.objective_value:>7.0f}  "
          f"maxR={mca.objective_values['max_recreation']:.0f}")
    lmg = optimize(g, OptimizeSpec.problem(3, beta=20150), device=device)
    print(f"  balanced (Fig 1 iv budget):    C={lmg.objective_values['storage']:>7.0f}  "
          f"maxR={lmg.objective_values['max_recreation']:.0f}  "
          f"materialized={lmg.solution.materialized()}")
    print(f"  -> {lmg.summary()}")
    return {name: (res.objective_values["storage"], res.objective_values["max_recreation"])
            for name, res in (("spt", spt), ("mca", mca), ("lmg", lmg))}


def frontier(device: str = "cuda") -> list:
    print("\n=== Spec grid on a DC-like synthetic workload (paper §5.1) ===")
    wl = generate(dc_like(150, seed=7))
    g = wl.graph
    mca = optimize(g, OptimizeSpec.problem(1), device=device)
    spt = optimize(g, OptimizeSpec.problem(2), device=device)
    c0, r0 = mca.objective_value, mca.objective_values["sum_recreation"]
    print(f"  {'spec':22s} {'storage(GB)':>12s} {'sum rec(GB)':>12s} {'max rec(GB)':>12s}")
    rows = [
        ("P1 min C", mca),
        ("P2 min each R", spt),
        ("P3 β=1.1·Cmin", optimize(g, OptimizeSpec.problem(3, beta=c0 * 1.1), device=device)),
        ("P3 β=1.5·Cmin", optimize(g, OptimizeSpec.problem(3, beta=c0 * 1.5), device=device)),
        ("P6 θ=2·maxSPT", optimize(g, OptimizeSpec.problem(
            6, theta=spt.objective_values["max_recreation"] * 2), device=device)),
        ("LAST α=2", optimize(g, OptimizeSpec.heuristic("last", alpha=2.0), device=device)),
        ("GitH w=20", optimize(g, OptimizeSpec.heuristic("gith", window=20,
                                                         max_depth=20), device=device)),
    ]
    table = []
    for name, res in rows:
        v = res.objective_values
        print(f"  {name:22s} {v['storage']/1e9:12.3f} "
              f"{v['sum_recreation']/1e9:12.3f} {v['max_recreation']/1e9:12.4f}")
        table.append((name, v["storage"], v["sum_recreation"], v["max_recreation"]))
    # the paper's headline: ~1.1x storage slack cuts Σ-recreation enormously
    lmg = optimize(g, OptimizeSpec.problem(3, beta=c0 * 1.1), device=device)
    print(f"  -> P3 at 1.1x MCA storage reduces Σ-recreation "
          f"{r0 / lmg.objective_value:.1f}x vs MCA")
    return table


def tensors(device: str = "cuda") -> dict:
    print("\n=== Repository on real tensor payloads ===")
    rng = np.random.RandomState(0)
    payload = {"w": rng.randn(256, 256).astype(np.float32)}
    with tempfile.TemporaryDirectory() as d:
        repo = Repository(d, device=device)
        vids = [repo.commit(payload, message="base")]
        for i in range(5):
            payload = {"w": payload["w"].copy()}
            payload["w"][i * 10 : i * 10 + 8] += 1.0  # localized edit
            vids.append(repo.commit(payload, message=f"edit {i}"))
        repo.tag("release-1")          # immutable pointer at the main tip
        repo.branch("hotfix", at=vids[2])
        store = repo.store
        stored = store.storage_bytes()
        print(f"  6 versions on 'main' + tag + branch, "
              f"{stored/1e3:.1f} KB stored "
              f"(full would be ~{6 * 256 * 256 * 4 / 1e3:.0f} KB uncompressed)")
        sla = store.cost_model.phi_full(300_000, 300_000) * 2
        stats = repo.repack(OptimizeSpec.problem(6, theta=sla))
        print(f"  repack(P6 θ=SLA): storage {stats['before']['storage_bytes']/1e3:.1f} "
              f"-> {stats['after']['storage_bytes']/1e3:.1f} KB, "
              f"max restore {stats['after']['max_recreation_s']*1e3:.2f} ms "
              f"(solver={stats['optimize']['solver']})")
        want = torch.from_numpy(payload["w"])
        w = repo.checkout("release-1")["w"]
        assert torch.equal(w, want), "checkout mismatch!"
        print("  checkout('release-1') verified byte-identical ✓")
        # batched checkout: one plan over the storage graph, shared chain
        # prefixes decoded once, bit-identical to sequential checkouts
        trees = repo.checkout_many(vids)
        assert torch.equal(trees[-1]["w"], want)
        d01 = repo.diff(vids[0], "release-1")
        print(f"  checkout_many({len(vids)} versions) in one plan ✓ "
              f"(cache: {store.materializer.stats()['hits']} hits); "
              f"diff base..release-1: {d01.summary()}")
        repo.close()
    return {"stored_bytes": stored, "diff": d01.summary(),
            "repacked_bytes": stats["after"]["storage_bytes"]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the kernels and solvers run (default: cuda)")
    device = ap.parse_args(argv).device
    return {"figure1": figure1(device), "frontier": frontier(device),
            "tensors": tensors(device)}


if __name__ == "__main__":
    main()
