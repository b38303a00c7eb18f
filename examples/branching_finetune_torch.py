"""Branch/merge model versioning on the PyTorch port — the paper's DATAHUB
scenario on weights (the twin of ``examples/branching_finetune.py``).

Two teams fork a base checkpoint onto *named branches*, fine-tune on
different data, and the branches are merged (model souping) and tagged.
All six states live in one version DAG behind the ``Repository`` facade;
the storage graph is then optimized declaratively — a Problem-3 spec with
``use_access_frequencies=True`` routing the real access counts into the
spec's workload field (paper Fig. 16).

Run:  PYTHONPATH=src python examples/branching_finetune_torch.py [--device cpu]
(the default, ``cuda``, needs a card).
"""

import argparse
import shutil
import tempfile

import torch

from repro_torch.configs import ARCHS
from repro_torch.core import OptimizeSpec
from repro_torch.data.pipeline import SyntheticTokenPipeline
from repro_torch.models.registry import get_model
from repro_torch.store import Repository, flatten_payload
from repro_torch.training.optimizer import OptimizerConfig, init_opt_state
from repro_torch.training.train_loop import TrainConfig, make_train_step
from repro_torch.tree import tree_map


def finetune(bundle, params, *, seed: int, device: str, steps: int = 8):
    tcfg = TrainConfig(optimizer=OptimizerConfig(peak_lr=5e-4, warmup_steps=2,
                                                 total_steps=steps))
    step_fn = make_train_step(bundle, tcfg)
    pipe = SyntheticTokenPipeline(vocab=bundle.cfg.vocab, seq_len=64,
                                  global_batch=4, seed=seed, device=device)
    # the step updates params in place: it must not write into the base
    params = tree_map(lambda p: p.detach().clone(), params)
    state = {"params": params, "opt": init_opt_state(params), "error_fb": None}
    for _ in range(steps):
        state, m = step_fn(state, pipe.next_batch())
    return tree_map(lambda p: p.detach(), state["params"]), float(m["loss"])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where training, the kernels and the solvers run (default: cuda)")
    device = ap.parse_args(argv).device
    cfg = ARCHS["minitron-4b"].reduced()
    bundle = get_model(cfg)
    base = bundle.init(torch.Generator(device=device).manual_seed(0), device=device)

    d = tempfile.mkdtemp(prefix="repro_branches_")
    repo = Repository(d, device=device)

    v_base = repo.commit(base, message="pretrained base")
    repo.tag("pretrained", at=v_base)
    print(f"v{v_base}: base committed on 'main', tagged 'pretrained'")

    repo.branch("team-a", at="pretrained")
    team_a, loss_a = finetune(bundle, base, seed=1, device=device)
    v_a = repo.commit(team_a, branch="team-a", message="team A finetune")
    team_a2, loss_a2 = finetune(bundle, team_a, seed=11, device=device)
    v_a2 = repo.commit(team_a2, branch="team-a", message="team A round 2")

    repo.branch("team-b", at="pretrained")
    team_b, loss_b = finetune(bundle, base, seed=2, device=device)
    v_b = repo.commit(team_b, branch="team-b", message="team B finetune")

    soup = tree_map(lambda a, b: ((a.float() + b.float()) / 2).to(a.dtype),
                    team_a2, team_b)
    # merge commit: both branch tips as parents, landing on main
    v_soup = repo.commit(soup, parent=["team-a", "team-b"], branch="main",
                         message="soup(A2, B)")
    repo.tag("soup-v1", at=v_soup)
    print(f"version DAG: base->({v_a}->{v_a2}, {v_b})->merge v{v_soup}; "
          f"branches={repo.branches()} tags={repo.tags()}")

    store = repo.store
    full = sum(m.raw_bytes for m in store.log())
    print(f"raw payloads {full/1e6:.1f} MB -> stored {store.storage_bytes()/1e6:.1f} MB "
          f"(delta chains)")

    # what did team A's second round actually touch vs the base?
    dstat = repo.diff("pretrained", "team-a")
    print(f"diff pretrained..team-a: {dstat.summary()}")

    # simulate an access pattern: the soup is served constantly — after the
    # first request the materialization cache serves it from memory
    hits0 = store.materializer.stats()["hits"]
    for _ in range(25):
        repo.checkout("soup-v1")
    repo.checkout("pretrained")
    mstats = store.materializer.stats()
    print(f"serving 26 checkouts: {mstats['hits']} cache hits, "
          f"{mstats['full_decodes']} full decodes + "
          f"{mstats['delta_applies']} delta applies total")

    # declarative workload-aware repack: Problem 3 (min Σ w_i R_i s.t.
    # C ≤ 1.4x current) with the recorded access counts as the workload
    spec = OptimizeSpec.problem(3, beta=store.storage_bytes() * 1.4)
    stats = repo.repack(spec, use_access_frequencies=True)
    print(f"workload-aware repack [{stats['optimize']['solver']}]: Σrestore "
          f"{stats['before']['sum_recreation_s']*1e3:.1f}ms -> "
          f"{stats['after']['sum_recreation_s']*1e3:.1f}ms "
          f"at ≤1.4x storage (gc freed {stats['gc_freed_bytes']/1e6:.1f} MB); "
          f"hot versions prefetched back into the cache")

    # every version still reconstructs exactly
    rec = repo.checkout("soup-v1")
    flat_soup = flatten_payload(soup)
    for k, arr in flat_soup.items():
        assert torch.equal(rec[k], arr), k
    print("soup checkout verified byte-identical ✓")
    repo.close()
    shutil.rmtree(d, ignore_errors=True)
    return {"hits_of_26": mstats["hits"] - hits0, "losses": (loss_a, loss_a2, loss_b),
            "soup_leaves": len(flat_soup)}


if __name__ == "__main__":
    main()
