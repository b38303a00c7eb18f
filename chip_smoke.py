#!/usr/bin/env python3
"""Drive the PyTorch port's commit and checkout path on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It needs a CUDA device, ``nvcc`` and the checkout's ``src/``; without them it
exits non-zero and prints no result.  It imports ``repro_torch``, torch and
numpy only, and builds the CUDA kernels from the checkout's sources on first
use (into ``build/``).  Phases:

(a) Kernel checks.  Each CUDA kernel is run at the shapes the main path gives
    it and held bit for bit against its plain PyTorch version on the card
    (edge cases too: duplicate rows across and within chain steps, padding,
    an empty chain).  Each is timed beside its plain version, its bound and,
    for the sparse scatter, ``torch.index_copy`` as the library yardstick.
(b) Commits.  A ``Repository`` in a temporary directory under ``build/``
    takes a dataset of ~509 MiB per version (six leaves, six dtypes, one
    leaf whose size is not a multiple of 4 KiB, three leaves of equal block
    count): a root, 24 commits on ``main`` that each change 0.5% of the
    blocks of two leaves, a mid-chain reshape (full rewrite) and a deleted
    leaf (tombstone), and a 4-commit branch off the middle, with a cache
    budget of three versions.
(c) Checkouts.  The store is reopened with no cache; the main and branch tips
    are checked out cold through the fused chain kernel and through the
    one-hop sparse kernel, then ``checkout_many`` of both tips and a mid
    version.  Every tree is compared byte for byte with numpy ground truth
    kept on the host.
(d) Breakdown.  The host steps of a commit, timed one by one, and one cold
    checkout under the port's span tracer and ``torch.profiler`` (device
    busy and idle share).

The launch counters of the kernels are set to 0 before each main-path phase
and read after it; a kernel its phase should use that launched no time
fails the run, as does any mismatch.  The last lines are the card's name and
power limit (``nvidia-smi``), one JSON object with each kernel's numbers,
and the result line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
SEED = 1505_05211
BLOCK = 4096

# name -> (dtype, shape): ~509 MiB per version at the dataset's own widths
LEAVES = {
    "features/dense": ("float32", (32768, 1024)),    # 128 MiB, 32768 blocks
    "features/half": ("float16", (32768, 2048)),     # 128 MiB, 32768 blocks
    "embeddings/bf16": ("bfloat16", (32768, 2048)),  # 128 MiB, 32768 blocks
    "labels/ids": ("int64", (8_000_001,)),           # 64,000,008 B: ragged
    "tokens/i8": ("int8", (50_000_000,)),            # 47.7 MiB
    "mask/valid": ("bool", (16_777_216,)),           # 16 MiB
}
PAIRS = (("features/dense", "features/half"), ("embeddings/bf16", "labels/ids"))
MAIN_COMMITS = 24
BRANCH_COMMITS = 4
FORK_AT = 12           # branch "dev" forks off main's 12th commit
RESHAPE_AT = 8         # main commit that reshapes labels/ids (full rewrite)
TOMBSTONE_AT = 18      # main commit that deletes mask/valid
CHANGED_SHARE = 0.005  # of a leaf's blocks, per edit


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


# ------------------------------------------------------------------ dataset
def make_dataset(rng: np.random.Generator) -> dict:
    """Host ground truth: name -> numpy array (bfloat16 held as uint16)."""
    import torch

    out = {}
    for name, (dtype, shape) in LEAVES.items():
        n = int(np.prod(shape))
        if dtype == "bfloat16":
            f = torch.from_numpy(rng.standard_normal(n, dtype=np.float32))
            arr = f.to(torch.bfloat16).view(torch.uint16).numpy()
        elif dtype in ("float32", "float16"):
            arr = rng.standard_normal(n, dtype=np.float32).astype(dtype)
        elif dtype == "bool":
            arr = rng.random(n, dtype=np.float32) < 0.5
        else:
            info = np.iinfo(dtype)
            arr = rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)
        out[name] = arr.reshape(shape)
    return out


def edit_blocks(rng: np.random.Generator, arr: np.ndarray) -> np.ndarray:
    """A copy of ``arr`` with one byte changed in 0.5% of its 4 KiB blocks."""
    new = arr.copy()
    raw = new.reshape(-1).view(np.uint8)
    nblocks = -(-raw.size // BLOCK)
    rows = rng.choice(nblocks, max(1, int(nblocks * CHANGED_SHARE)), replace=False)
    pos = np.minimum(rows * BLOCK + rng.integers(0, BLOCK, rows.size), raw.size - 1)
    raw[pos] ^= rng.integers(1, 256, rows.size).astype(np.uint8)
    return new


def as_payload(tree: dict) -> dict:
    """Nested payload of tensors sharing the ground truth's memory."""
    import torch

    payload: dict = {}
    for name, arr in tree.items():
        t = torch.from_numpy(arr)
        if LEAVES[name][0] == "bfloat16":
            t = t.view(torch.bfloat16)
        group, leaf = name.split("/")
        payload.setdefault(group, {})[leaf] = t
    return payload


def same_tree(got: dict, want: dict, what: str) -> None:
    import torch

    check(sorted(got) == sorted(want),
          f"{what}: leaves {sorted(got)} != {sorted(want)}")
    for name, arr in want.items():
        t = got[name]
        check(tuple(t.shape) == arr.shape, f"{what}/{name}: shape {tuple(t.shape)} != {arr.shape}")
        check(t.element_size() == arr.itemsize, f"{what}/{name}: dtype {t.dtype} != {arr.dtype}")
        want_u8 = torch.from_numpy(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))
        check(torch.equal(t.contiguous().reshape(-1).view(torch.uint8), want_u8),
              f"{what}/{name}: bytes differ")


# ---------------------------------------------------------- (a) kernel checks
def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def max_abs_err(got, want) -> float:
    import torch

    check(got.shape == want.shape, f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    torch.cuda.synchronize()
    return float((got.to(torch.int64) - want.to(torch.int64)).abs().max()) if got.numel() else 0.0


def kernel_checks(dev) -> list:
    """Phase (a): each kernel against its plain version at the main path's
    shapes, bit for bit, and timed."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.block_diff import changed_block_mask
    from repro_torch.kernels.chain_apply import chain_delta_apply, chain_delta_apply_batched
    from repro_torch.kernels.sparse_apply import sparse_delta_apply

    g = torch.Generator(device=dev).manual_seed(SEED)

    def rand_blocks(n):
        return torch.randint(-(2**31), 2**31 - 1, (n, 8, 128), dtype=torch.int32,
                             device=dev, generator=g)

    dtype, shape = LEAVES["features/dense"]
    nb = int(np.prod(shape)) * np.dtype(dtype).itemsize // BLOCK  # 32768
    k = int(nb * CHANGED_SHARE)                      # rows one commit changes
    rows_of = lambda n, m: torch.randperm(n, device=dev, generator=g)[:m].to(torch.int32)
    results = []

    # changed_block_mask: a commit's diff of one 128 MiB leaf
    a = rand_blocks(nb)
    b = a.clone()
    changed = rows_of(nb, k).long()
    b[changed, 3, 5] ^= 1
    got, want = changed_block_mask(a, b), ref.changed_block_mask_ref(a, b)
    err = max_abs_err(got, want)
    check(err == 0 and int(got.sum()) == k, "changed_block_mask disagrees with its plain version")
    check(int(changed_block_mask(a, a.clone()).sum()) == 0, "changed_block_mask: identical inputs")
    check(int(changed_block_mask(a, a ^ 1).sum()) == nb, "changed_block_mask: all rows changed")
    results.append({
        "name": "changed_block_mask", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/delta_kernels.cu",
        "replaces": "src/repro/kernels/block_diff.py:31",
        "max_abs_err": err,
        "ms": cuda_ms(lambda: changed_block_mask(a, b)),
        "plain_ms": cuda_ms(lambda: ref.changed_block_mask_ref(a, b)),
        "bound_ms": bound_ms(2 * nb * BLOCK + nb * 4), "bound_by": "bytes",
        "library_ms": None,
    })
    del a, b

    # sparse_delta_apply: one hop of a stepwise checkout (a trimmed wire
    # delta: distinct rows, no padding), plus padding and out-of-range rows
    base = rand_blocks(nb)
    blocks = rand_blocks(k)
    idx = rows_of(nb, k)
    got, want = sparse_delta_apply(base, blocks, idx), ref.sparse_delta_apply_ref(base, blocks, idx)
    err = max_abs_err(got, want)
    check(err == 0, "sparse_delta_apply disagrees with its plain version")
    lib = torch.index_copy(base, 0, idx.long(), blocks)
    check(torch.equal(lib, got), "index_copy disagrees with sparse_delta_apply")
    pad_idx = idx.clone()
    pad_idx[::3] = -1
    pad_idx[1::7] = nb + 5
    check(torch.equal(sparse_delta_apply(base, blocks, pad_idx),
                      ref.sparse_delta_apply_ref(base, blocks, pad_idx)),
          "sparse_delta_apply: padding rows")
    idx64 = idx.long()
    results.append({
        "name": "sparse_delta_apply", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/delta_kernels.cu",
        "replaces": "src/repro/kernels/sparse_apply.py:34",
        "max_abs_err": err,
        "ms": cuda_ms(lambda: sparse_delta_apply(base, blocks, idx)),
        "plain_ms": cuda_ms(lambda: ref.sparse_delta_apply_ref(base, blocks, idx)),
        "bound_ms": bound_ms(2 * nb * BLOCK + k * (BLOCK + 4)), "bound_by": "bytes",
        "library_ms": cuda_ms(lambda: torch.index_copy(base, 0, idx64, blocks)),
    })
    del base, blocks, lib

    # chain_delta_apply_batched: the main tip's checkout of the three 128 MiB
    # leaves edited on alternate commits (12 steps of k rows each, padded to
    # the slot bucket): duplicate rows across steps, padding at the tail
    steps = MAIN_COMMITS // 2
    slots = 1 << (steps * k - 1).bit_length()
    leaves = 3
    bases = rand_blocks(leaves * nb).reshape(leaves, nb, 8, 128)
    cblocks = rand_blocks(leaves * slots).reshape(leaves, slots, 8, 128)
    cidx = torch.full((leaves, slots), -1, dtype=torch.int32, device=dev)
    for leaf in range(leaves):
        for s in range(steps):
            cidx[leaf, s * k:(s + 1) * k] = rows_of(nb, k)
    cidx[:, k // 2] = cidx[:, 3 * k + 1]  # the same row in two steps
    offs = torch.arange(leaves, dtype=torch.int32, device=dev)[:, None] * nb

    def chain_plain():  # the batched wrapper's row offsets, then the plain fold
        flat_idx = torch.where(cidx >= 0, cidx + offs, -1).reshape(-1)
        return ref.chain_delta_apply_ref(
            bases.reshape(-1, 8, 128), cblocks.reshape(-1, 8, 128), flat_idx
        ).reshape(bases.shape)

    got = chain_delta_apply_batched(bases, cblocks, cidx)
    err = max_abs_err(got, chain_plain())
    check(err == 0, "chain_delta_apply_batched disagrees with its plain version")
    for i in range(leaves):
        check(torch.equal(got[i], ref.chain_delta_apply_ref(bases[i], cblocks[i], cidx[i])),
              f"chain_delta_apply_batched: leaf {i} differs from its own chain")
    # single-leaf form, duplicates within one step, an empty chain, all padding
    one_idx = torch.randint(0, 64, (4, 16), dtype=torch.int32, device=dev, generator=g)
    one_idx[:, ::5] = -1
    one_blk = rand_blocks(64).reshape(4, 16, 8, 128)
    small = rand_blocks(64)
    check(torch.equal(chain_delta_apply(small, one_blk, one_idx),
                      ref.chain_delta_apply_ref(small, one_blk, one_idx)),
          "chain_delta_apply: duplicates within and across steps")
    empty = torch.zeros((0,), dtype=torch.int32, device=dev)
    check(torch.equal(chain_delta_apply(small, one_blk[:0].reshape(0, 8, 128), empty), small),
          "chain_delta_apply: empty chain")
    check(torch.equal(chain_delta_apply(small, one_blk, torch.full_like(one_idx, -1)), small),
          "chain_delta_apply: all padding")
    winners = int(torch.unique((cidx + offs)[cidx >= 0]).numel())
    results.append({
        "name": "chain_delta_apply", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/delta_kernels.cu",
        "replaces": "src/repro/kernels/chain_apply.py:76",
        "max_abs_err": err,
        "ms": cuda_ms(lambda: chain_delta_apply_batched(bases, cblocks, cidx)),
        "plain_ms": cuda_ms(chain_plain),
        "bound_ms": bound_ms(2 * leaves * nb * BLOCK + winners * BLOCK + leaves * slots * 4),
        "bound_by": "bytes",
        "library_ms": None,
    })
    del bases, cblocks, got
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    for r in results:
        log(f"kernel {r['name']}: max_abs_err {r['max_abs_err']} ms {r['ms']:.6f} "
            f"plain_ms {r['plain_ms']:.6f} bound_ms {r['bound_ms']:.6f} "
            f"library_ms {r['library_ms']}")
    return results


# ------------------------------------------------------------ main path
class Counters:
    """The wrappers' launch counters, zeroed and read around each phase."""

    def __init__(self):
        from repro_torch.kernels import block_diff, chain_apply, sparse_apply

        self.fns = {
            "changed_block_mask": [block_diff.changed_block_mask],
            "sparse_delta_apply": [sparse_apply.sparse_delta_apply],
            "chain_delta_apply": [chain_apply.chain_delta_apply,
                                  chain_apply.chain_delta_apply_batched],
        }
        self.total = {name: 0 for name in self.fns}

    def zero(self) -> None:
        for fns in self.fns.values():
            for fn in fns:
                fn.launches = 0

    def read(self, phase: str, needs: tuple) -> dict:
        counts = {name: sum(fn.launches for fn in fns) for name, fns in self.fns.items()}
        for name, n in counts.items():
            self.total[name] += n
        log(f"launches {phase}: {json.dumps(counts)}")
        for name in needs:
            check(counts[name] > 0, f"{phase}: kernel {name} was never launched")
        return counts


def drive_commits(root: Path, counters: Counters, device: str = "cuda") -> dict:
    """Phase (b): the history; returns the host ground truth of the
    versions phase (c) checks out."""
    from repro_torch.store import Repository

    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    tree = make_dataset(rng)
    log(f"phase b: dataset {sum(a.nbytes for a in tree.values()) / 2**20:.1f} MiB "
        f"per version, made in {time.perf_counter() - t0:.3f} s")
    budget = 3 * sum(a.nbytes for a in tree.values())
    repo = Repository(root, device=device, cache_budget_bytes=budget)
    truth = {}
    counters.zero()
    t0 = time.perf_counter()
    repo.commit(as_payload(tree), message="root")
    commit_s = [time.perf_counter() - t0]
    fork_tree = None
    for i in range(1, MAIN_COMMITS + 1):
        tree = dict(tree)
        for name in PAIRS[i % 2]:
            tree[name] = edit_blocks(rng, tree[name])
        if i == RESHAPE_AT:
            tree["labels/ids"] = tree["labels/ids"].reshape(-1, 1)
        if i == TOMBSTONE_AT:
            del tree["mask/valid"]
        t0 = time.perf_counter()
        vid = repo.commit(as_payload(tree), message=f"main {i}")
        commit_s.append(time.perf_counter() - t0)
        if i == FORK_AT:
            fork_tree, fork_vid = tree, vid
            truth["mid"] = (vid, tree)
    truth["main"] = ("main", tree)
    repo.branch("dev", at=fork_vid)
    tree = fork_tree
    for i in range(1, BRANCH_COMMITS + 1):
        tree = dict(tree)
        for name in PAIRS[0]:
            tree[name] = edit_blocks(rng, tree[name])
        t0 = time.perf_counter()
        repo.commit(as_payload(tree), branch="dev", message=f"dev {i}")
        commit_s.append(time.perf_counter() - t0)
    truth["dev"] = ("dev", tree)
    repo.close()
    stored = sorted((m.stored_base is None, m.stored_bytes) for m in repo.store.log())
    log(f"phase b: {len(commit_s)} commits in {sum(commit_s):.3f} s "
        f"(root {commit_s[0]:.3f} s, others mean "
        f"{sum(commit_s[1:]) / (len(commit_s) - 1):.3f} s); stored "
        f"{repo.store.storage_bytes()} bytes, "
        f"{sum(1 for full, _ in stored if full)} full objects")
    check(sum(1 for full, _ in stored if full) == 1,
          "phase b: every commit after the root should be stored as a delta")
    counters.read("phase b (commits)", ("changed_block_mask", "chain_delta_apply"))
    return truth


def drive_checkouts(root: Path, truth: dict, counters: Counters, device: str = "cuda") -> None:
    """Phase (c): cold checkouts, fused and stepwise, and a batch."""
    from repro_torch.store import Repository

    def timed(label, fn):
        t0 = time.perf_counter()
        out = fn()
        log(f"phase c: {label} in {time.perf_counter() - t0:.3f} s")
        return out

    for fuse, needs in ((True, ("chain_delta_apply",)), (False, ("sparse_delta_apply",))):
        repo = Repository(root, device=device, cache_budget_bytes=0, fuse_chains=fuse)
        counters.zero()
        for label in ("main", "dev"):
            ref_, want = truth[label]
            got = timed(f"checkout {label} tip (fuse_chains={fuse})",
                        lambda: repo.checkout(ref_))
            same_tree(got, want, f"{label} tip (fuse_chains={fuse})")
        counters.read(f"phase c (fuse_chains={fuse})", needs)
        repo.close()
    repo = Repository(root, device=device, cache_budget_bytes=0)
    counters.zero()
    labels = ("main", "dev", "mid")
    got = timed("checkout_many(main, dev, mid)",
                lambda: repo.checkout_many([truth[lb][0] for lb in labels]))
    for lb, tree in zip(labels, got):
        same_tree(tree, truth[lb][1], f"checkout_many {lb}")
    stats = repo.store.materializer.stats()
    log(f"phase c: checkout_many stats {json.dumps(stats)}")
    counters.read("phase c (checkout_many)", ("chain_delta_apply",))
    repo.close()


def breakdown(root: Path, truth: dict, device: str = "cuda") -> None:
    """Phase (d), after the main path: where a commit's and a cold
    checkout's time goes at full size.  The host steps of a commit are
    timed one by one; one cold fused checkout of the main tip runs under
    the port's tracer (its spans) and torch.profiler (device busy time)."""
    import hashlib

    import torch
    from torch.autograd import DeviceType

    from repro_torch.obs import Tracer, set_tracer
    from repro_torch.store import Repository, delta

    def clock(label, fn):
        t0 = time.perf_counter()
        out = fn()
        log(f"phase d: {label} {time.perf_counter() - t0:.3f} s")
        return out

    repo = Repository(root, device=device, cache_budget_bytes=0)
    objects = repo.store.objects
    flat = clock("flatten_payload", lambda: delta.flatten_payload(as_payload(truth["main"][1])))
    full = clock("encode_full (msgpack pack)", lambda: delta.encode_full(flat))
    clock("sha256 of the full payload", lambda: hashlib.sha256(full).hexdigest())
    sample = full[: 64 << 20]
    t0 = time.perf_counter()
    objects.codec.compress(sample)
    log(f"phase d: {objects.codec.backend} compress "
        f"{len(sample) / (time.perf_counter() - t0) / 1e6:.1f} MB/s on 64 MiB of it")
    del full, sample
    raw = clock("read + decompress the root object",
                lambda: objects.get(repo.store.versions[1].object_key))
    clock("decode_full (msgpack unpack + tensors)", lambda: delta.decode_full(raw))
    del raw

    tracer = Tracer(enabled=True)
    old = set_tracer(tracer)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    try:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            repo.checkout("main")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        set_tracer(old)
    spans: dict = {}
    for sp in tracer.spans():
        spans[sp.name] = spans.get(sp.name, 0.0) + sp.duration
    log(f"phase d: traced cold checkout of main {wall:.3f} s; spans (s): "
        + json.dumps({k: round(v, 6) for k, v in spans.items()}))
    busy: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            busy[e.name] = busy.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e6
    total = sum(busy.values())
    if total:
        log(f"phase d: device busy {total:.6f} s of {wall:.3f} s "
            f"(idle share {1 - total / wall:.6f})")
        for name, sec in sorted(busy.items(), key=lambda kv: -kv[1])[:8]:
            log(f"phase d:   device {sec:.6f} s  {name[:90]}")
    else:
        log("phase d: device busy time not measured (the profiler saw no device events)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import kernels

    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    lib = kernels.build()
    log(f"build: {lib.name} in {time.perf_counter() - t0:.3f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"  ptxas: {line.strip()}")
    kernels.library()

    t0 = time.perf_counter()
    results = kernel_checks(dev)
    log(f"phase a: kernel checks in {time.perf_counter() - t0:.3f} s")

    counters = Counters()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build", prefix="chip_smoke_") as tmp:
        t0 = time.perf_counter()
        truth = drive_commits(Path(tmp) / "repo", counters)
        log(f"phase b: wall {time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        drive_checkouts(Path(tmp) / "repo", truth, counters)
        log(f"phase c: wall {time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        breakdown(Path(tmp) / "repo", truth)
        log(f"phase d: wall {time.perf_counter() - t0:.3f} s")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    for r in results:
        r["launches"] = counters.total[r["name"]]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in results]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
