"""Versioned datasets feeding the training pipeline (paper scenario #2), on
the PyTorch port (the twin of ``examples/dataset_versions.py``).

A tokenized corpus evolves through cleaning -> dedup -> mixture updates;
each stage is a commit on the repository's ``main`` branch, *tagged* with a
stable name (deltas, not copies).  Training jobs pin a dataset tag —
switching versions is a checkout, reproducible forever, and the storage
stays near the size of one copy + edits.

Run:  PYTHONPATH=src python examples/dataset_versions_torch.py [--device cpu]
(the default, ``cuda``, needs a card).
"""

import argparse
import shutil
import tempfile

import numpy as np
import torch

from repro_torch.data.pipeline import VersionedDatasetPipeline
from repro_torch.store import Repository


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the kernels and the pipeline run (default: cuda)")
    device = ap.parse_args(argv).device
    d = tempfile.mkdtemp(prefix="repro_data_")
    repo = Repository(d, device=device)
    store = repo.store
    rng = np.random.RandomState(0)

    # raw corpus — 4 shards of token ids
    shards = {f"shard{i:02d}": rng.randint(0, 50000, 200_000).astype(np.int32)
              for i in range(4)}
    repo.commit(shards, message="raw corpus")
    repo.tag("corpus-raw")

    # cleaning pass rewrites 3% of tokens in two shards
    cleaned = {k: v.copy() for k, v in shards.items()}
    for k in ("shard00", "shard02"):
        idx = rng.choice(cleaned[k].size, size=cleaned[k].size * 3 // 100, replace=False)
        cleaned[k][idx] = 0
    repo.commit(cleaned, message="cleaning pass")
    repo.tag("corpus-cleaned")

    # dedup drops one shard, adds a fresh one
    dedup = {k: v for k, v in cleaned.items() if k != "shard03"}
    dedup["shard04"] = rng.randint(0, 50000, 150_000).astype(np.int32)
    v3 = repo.commit(dedup, message="dedup + new crawl")
    repo.tag("corpus-dedup-v1")

    raw = sum(m.raw_bytes for m in store.log())
    stored = store.storage_bytes()
    print(f"3 corpus versions: raw {raw/1e6:.1f} MB -> stored "
          f"{stored/1e6:.1f} MB; tags={sorted(repo.tags())}")
    cleaning = repo.diff("corpus-raw", "corpus-cleaned").summary()
    print(f"cleaning touched: {cleaning}")

    # the training job pins the *tag*; the pipeline still speaks raw vids
    assert repo.resolve("corpus-dedup-v1") == v3
    pipe = VersionedDatasetPipeline(store, repo.resolve("corpus-dedup-v1"),
                                    seq_len=128, global_batch=8)
    b0 = pipe.next_batch()
    snap = pipe.snapshot()
    b1 = pipe.next_batch()

    # resume determinism: a new pipeline from the snapshot yields batch 1 again
    pipe2 = VersionedDatasetPipeline(store, v3, seq_len=128, global_batch=8)
    pipe2.restore(snap)
    b1_again = pipe2.next_batch()
    assert torch.equal(b1["tokens"], b1_again["tokens"])
    print(f"pinned dataset 'corpus-dedup-v1' (v{v3}); batch shape "
          f"{tuple(b0['tokens'].shape)}; resume-from-snapshot determinism ✓")
    repo.close()
    shutil.rmtree(d, ignore_errors=True)
    return {"raw_bytes": raw, "stored_bytes": stored, "diff": cleaning}


if __name__ == "__main__":
    main()
