"""The port's store as a whole, against the JAX package's.

A branching history with sparse edits, full rewrites (reshape and dtype
change), new leaves and tombstones is committed by both packages from the
same numpy payloads.  Both must write the same ``meta.msgpack`` and the same
objects; each must open the other's store and check out, ``log`` and
``diff`` bit-identically; and the port's fused and stepwise checkouts must
agree with each other and with the JAX package's.  The port runs with
``device="cpu"`` (the plain versions of its kernels), the JAX package with
its Pallas kernels in interpret mode.

The payloads hold no 64-bit or bool leaves: the JAX package narrows 64-bit
leaves to 32 bits on its sparse path and its block layout refuses bool, so
there the reference itself is not a reference (the port keeps both intact;
see tests/test_torch_kernels.py for their byte layout).
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.store import Repository as JaxRepository
from repro_torch.store import Repository, VersionStore
from repro_torch.store import materializer as port_materializer
from repro_torch.store.convert import flat_from_numpy, tensor_to_numpy

SRC = Path(__file__).resolve().parents[1] / "src"


def _leaf(rng, shape, dtype):
    x = rng.randn(*shape)
    if dtype == "bfloat16":
        return np.asarray(jnp.asarray(x, jnp.bfloat16))
    if np.issubdtype(np.dtype(dtype), np.floating):
        return x.astype(dtype)
    return (x * 40).astype(dtype)


def _poke(rng, arr, n=2):
    """A copy of ``arr`` with ``n`` elements changed (a sparse edit)."""
    out = arr.copy()
    flat = out.reshape(-1)
    for i in rng.randint(0, flat.size, n):
        flat[i] = flat[i] + np.asarray(1, flat.dtype)
    return out


def _history(seed=0):
    """[(branch, parent ref or None, payload)] of a branching history:
    main has sparse edits, a reshape (full rewrite), a tombstone and a new
    leaf; branch "dev" forks off main's second commit with sparse edits and
    a dtype change."""
    rng = np.random.RandomState(seed)
    p = {
        "feat": {"x": _leaf(rng, (40, 64), "float32"),
                 "z": _leaf(rng, (20, 100), "bfloat16")},
        "tok": _leaf(rng, (3000,), "int8"),
        "w": _leaf(rng, (64, 64), "float16"),
    }
    steps = [("main", None, p)]

    def edit(prev, **changes):
        new = {"feat": dict(prev["feat"]), **{k: v for k, v in prev.items() if k != "feat"}}
        for k, v in changes.items():
            if k in ("x", "z"):
                new["feat"][k] = v
            elif v is None:
                del new[k]
            else:
                new[k] = v
        return new

    m1 = edit(p, x=_poke(rng, p["feat"]["x"]), tok=_poke(rng, p["tok"], 3))
    steps.append(("main", None, m1))
    m2 = edit(m1, tok=m1["tok"].reshape(100, 30), z=_poke(rng, m1["feat"]["z"]))
    steps.append(("main", None, m2))
    m3 = edit(m2, w=None, new=_leaf(rng, (8, 8), "int32"),
              x=_poke(rng, m2["feat"]["x"], 40))
    steps.append(("main", None, m3))
    m4 = edit(m3, tok=_poke(rng, m3["tok"]), x=_poke(rng, m3["feat"]["x"]))
    steps.append(("main", None, m4))
    d1 = edit(m1, w=_poke(rng, m1["w"]), x=_poke(rng, m1["feat"]["x"]))
    steps.append(("dev", 2, d1))
    d2 = edit(d1, z=d1["feat"]["z"].astype(np.float32))
    steps.append(("dev", None, d2))
    d3 = edit(d2, z=_poke(rng, d2["feat"]["z"]), w=_poke(rng, d2["w"]))
    steps.append(("dev", None, d3))
    return steps


def _torch_payload(tree):
    if isinstance(tree, dict):
        return {k: _torch_payload(v) for k, v in tree.items()}
    return flat_from_numpy({"": tree})[""]


def _commit_all(repo, steps, as_torch):
    vids = []
    for branch, parent, payload in steps:
        tree = _torch_payload(payload) if as_torch else payload
        vids.append(repo.commit(tree, branch=branch, parent=parent,
                                message=f"{branch} {len(vids)}"))
    repo.tag("v-mid", at=vids[2])
    repo.switch("dev")
    return vids


def assert_same_tree(port_tree, jax_tree, ordered=True):
    """Same leaves, bytes and dtypes.  ``ordered`` also asks for the same
    key order, which holds when both packages took the same checkout path
    (order depends on the path, in either package, and reaches the
    tombstone list of a delta committed on top)."""
    if ordered:
        assert list(port_tree) == list(jax_tree)
    assert sorted(port_tree) == sorted(jax_tree)
    for k, want in jax_tree.items():
        got = tensor_to_numpy(port_tree[k])
        want = np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, k
        assert got.tobytes() == want.tobytes(), k


def _object_keys(root):
    return sorted(p.relative_to(root).as_posix() for p in (Path(root) / "objects").rglob("*.zst"))


@pytest.fixture
def fixed_clock(monkeypatch):
    # created_at reaches meta.msgpack; both packages read time.time()
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)


@pytest.fixture
def both_stores(tmp_path, fixed_clock):
    steps = _history()
    jroot, troot = tmp_path / "jax", tmp_path / "torch"
    jrepo = JaxRepository(jroot, cache_budget_bytes=0)
    jvids = _commit_all(jrepo, steps, as_torch=False)
    trepo = Repository(troot, device="cpu", cache_budget_bytes=0)
    tvids = _commit_all(trepo, steps, as_torch=True)
    assert jvids == tvids
    jtrees = jrepo.checkout_many(jvids)
    # the same checkouts on both sides: access counts reach the metadata
    for got, want in zip(trepo.checkout_many(tvids), jtrees):
        assert_same_tree(got, want)
    jrepo.close()
    trepo.close()
    return jroot, troot, jvids, jtrees


class TestCrossPackage:
    def test_same_metadata_and_objects(self, both_stores):
        jroot, troot, _, _ = both_stores
        assert (troot / "meta.msgpack").read_bytes() == (jroot / "meta.msgpack").read_bytes()
        assert _object_keys(troot) == _object_keys(jroot)
        for key in _object_keys(jroot):
            assert (troot / key).read_bytes() == (jroot / key).read_bytes()

    @pytest.mark.parametrize("fuse", [True, False])
    @pytest.mark.parametrize("budget", [0, 1 << 20])
    def test_port_checks_out_jax_store(self, both_stores, fuse, budget):
        # both packages take the same requests with the same settings, so
        # the same plans: trees must agree in key order too
        jroot, _, vids, _ = both_stores
        kw = dict(fuse_chains=fuse, cache_budget_bytes=budget)
        repo = Repository(jroot, device="cpu", **kw)
        jrepo = JaxRepository(jroot, **kw)
        for got, want in zip(repo.checkout_many(vids), jrepo.checkout_many(vids)):
            assert_same_tree(got, want)
        # one at a time, newest first, goes down other plans
        for vid in reversed(vids):
            assert_same_tree(repo.checkout(vid), jrepo.checkout(vid))
        assert_same_tree(repo.checkout("v-mid"), jrepo.checkout("v-mid"))

    def test_jax_checks_out_port_store(self, both_stores):
        _, troot, vids, jtrees = both_stores
        repo = JaxRepository(troot, cache_budget_bytes=0)
        for got, want in zip(repo.checkout_many(vids), jtrees):
            assert list(got) == list(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                assert got[k].tobytes() == want[k].tobytes()

    def test_log_and_diff_match(self, both_stores):
        jroot, troot, vids, _ = both_stores
        for root in (jroot, troot):
            jrepo = JaxRepository(root, cache_budget_bytes=0)
            trepo = Repository(root, device="cpu", cache_budget_bytes=0)
            assert trepo.head == jrepo.head == "dev"
            assert trepo.branches() == jrepo.branches()
            assert trepo.tags() == jrepo.tags()
            for ref in ("main", "dev", "v-mid"):
                assert [m.__dict__ for m in trepo.log(ref)] == [
                    m.__dict__ for m in jrepo.log(ref)
                ]
            for a, b in (("v-mid", "main"), ("main", "dev"), (vids[0], vids[-1])):
                assert trepo.diff(a, b).__dict__ == jrepo.diff(a, b).__dict__

    def test_reverse_direction_commit_continues(self, both_stores):
        # the port appends to a JAX-written store and the JAX package reads
        # the result (and vice versa): the stores stay one format
        jroot, troot, vids, _ = both_stores
        rng = np.random.RandomState(7)
        extra = {"feat": {"x": _leaf(rng, (40, 64), "float32")}, "tok": _leaf(rng, (10,), "int8")}
        trepo = Repository(jroot, device="cpu", cache_budget_bytes=0)
        v = trepo.commit(_torch_payload(extra), branch="main")
        jrepo = JaxRepository(jroot, cache_budget_bytes=0)
        assert jrepo.resolve("main") == v
        assert_same_tree(trepo.checkout(v), jrepo.checkout(v))
        jv = jrepo.commit(extra, branch="dev")
        trepo2 = Repository(jroot, device="cpu", cache_budget_bytes=0)
        assert trepo2.resolve("dev") == jv
        assert_same_tree(trepo2.checkout(jv), jrepo.checkout(jv))


    def test_foreign_metadata_carried_through(self, tmp_path):
        # the JAX package's measured-Δ cache and repack record survive a
        # commit through the port untouched
        rng = np.random.RandomState(8)
        x = _leaf(rng, (40, 64), "float32")
        jrepo = JaxRepository(tmp_path, cache_budget_bytes=0)
        jrepo.commit({"x": x})
        jrepo.commit({"x": _poke(rng, x)})
        jrepo.store.build_cost_graph()
        jrepo.store.last_repack = {"solver": "lmg", "constraints": [{"bound": 1.5}]}
        jrepo.store.save_refs()
        edge_cache = dict(jrepo.store._edge_cache)
        assert edge_cache
        trepo = Repository(tmp_path, device="cpu")
        trepo.commit({"x": torch.zeros(3)})
        again = JaxRepository(tmp_path, cache_budget_bytes=0).store
        assert again._edge_cache == edge_cache
        assert again.last_repack == jrepo.store.last_repack


class TestPortPaths:
    def test_fused_stepwise_and_jax_agree(self, tmp_path):
        steps = _history(seed=3)
        trees = {}
        for fuse in (True, False):
            repo = Repository(tmp_path / f"f{fuse}", device="cpu",
                              fuse_chains=fuse, cache_budget_bytes=0)
            vids = _commit_all(repo, steps, as_torch=True)
            trees[fuse] = repo.checkout_many(vids)
            stats = repo.store.materializer.stats()
            assert (stats["fused_segments"] > 0) == fuse
        jroot = tmp_path / "jax"
        vids = _commit_all(JaxRepository(jroot, cache_budget_bytes=0), steps, as_torch=False)
        for fuse in (True, False):
            jrepo = JaxRepository(jroot, fuse_chains=fuse, cache_budget_bytes=0)
            for got, want in zip(trees[fuse], jrepo.checkout_many(vids)):
                assert_same_tree(got, want)

    def test_shared_base_wave(self, tmp_path, monkeypatch):
        # one wave, two segments starting at the same base: both get the
        # same blocked memo, and neither may see the other's writes
        rng = np.random.RandomState(5)
        root = {"x": _leaf(rng, (64, 64), "float32"), "y": _leaf(rng, (64, 64), "float32")}
        mid = {"x": _poke(rng, root["x"]), "y": _poke(rng, root["y"])}
        a = {"x": _poke(rng, mid["x"], 5), "y": mid["y"]}
        b = {"x": _poke(rng, mid["x"], 5), "y": _poke(rng, mid["y"])}
        waves = []
        real = port_materializer.apply_delta_chains

        def spy(requests, **kw):
            waves.append([r[2] for r in requests])
            return real(requests, **kw)

        monkeypatch.setattr(port_materializer, "apply_delta_chains", spy)
        results = {}
        for fuse in (True, False):
            repo = Repository(tmp_path / f"f{fuse}", device="cpu",
                              fuse_chains=fuse, cache_budget_bytes=0)
            v1 = repo.commit(_torch_payload(root))
            v2 = repo.commit(_torch_payload(mid))
            va = repo.commit(_torch_payload(a), branch="a", parent=v2)
            vb = repo.commit(_torch_payload(b), branch="b", parent=v2)
            waves.clear()
            results[fuse] = repo.checkout_many([va, vb])
            assert repo.store.versions[va].stored_base == v2 == 1 + v1
            assert repo.store.versions[vb].stored_base == v2
            if fuse:
                # wave 1 builds v2's memo, wave 2 feeds it to both segments
                assert len(waves) == 2 and len(waves[1]) == 2
                assert waves[1][0] is waves[1][1] and "x" in waves[1][0]
        for fused, stepwise, want in zip(results[True], results[False], (a, b)):
            want = {k: np.asarray(v) for k, v in want.items()}
            assert_same_tree(fused, want, ordered=False)
            assert_same_tree(stepwise, want, ordered=False)

    @pytest.mark.parametrize("invalidation", ["chain", "global"])
    def test_cache_disciplines_and_spans(self, tmp_path, invalidation):
        # a commit keeps chain-tagged entries warm and rotates the global
        # epoch; the spans report the fused launches
        from repro_torch.obs import Tracer, set_tracer

        steps = _history(seed=4)[:3]
        repo = Repository(tmp_path, device="cpu", cache_invalidation=invalidation)
        vids = [repo.commit(_torch_payload(p)) for _, _, p in steps[:2]]
        cold = Repository(tmp_path, device="cpu", cache_budget_bytes=0)
        tracer = Tracer(enabled=True)
        old = set_tracer(tracer)
        try:
            want = cold.checkout(vids[1])
        finally:
            set_tracer(old)
        names = [sp.name for sp in tracer.spans()]
        assert names.count("delta.apply_chains") == 1 and "mat.checkout_many" in names
        chain_span = next(sp for sp in tracer.spans() if sp.name == "delta.apply_chains")
        assert chain_span.attrs["launches"] >= 1 and chain_span.attrs["leaves"] >= 1
        assert_same_tree(repo.checkout(vids[1]), {k: tensor_to_numpy(v) for k, v in want.items()},
                         ordered=False)
        repo.commit(_torch_payload(steps[2][2]))
        repo.checkout(vids[1])
        stats = repo.store.materializer.stats()
        # v2 is decoded once, then checked out twice (by the third commit's
        # delta encoding, then directly): chain mode hits both times;
        # global mode loses the cache to each commit's new epoch
        if invalidation == "chain":
            assert (stats["hits"], stats["invalidations"]) == (2, 0)
        else:
            assert (stats["hits"], stats["invalidations"]) == (1, 2)

    def test_unported_operations_raise(self, tmp_path):
        # every store operation is ported now: repack and build_cost_graph
        # (tests/test_torch_repack.py), fsck and the service tier
        # (tests/test_torch_fsck.py, tests/test_torch_service.py); none of
        # them raises NotImplementedError any more
        from repro_torch.service import DatasetService

        repo = Repository(tmp_path, device="cpu")
        repo.commit({"x": torch.arange(8)})
        assert repo.fsck().findings == repo.store.fsck().findings == []
        assert isinstance(repo.serve(readers=1), DatasetService)


class TestEntryPoints:
    def test_import_leaves_jax_out(self):
        code = (
            "import sys, repro_torch, repro_torch.store, repro_torch.kernels.ops,"
            " repro_torch.core, repro_torch.kernels.segment_ops,"
            " repro_torch.core.solvers.torch_backend, repro_torch.configs,"
            " repro_torch.models, repro_torch.models.convert,"
            " repro_torch.kernels.flash_attention, repro_torch.serving,"
            " repro_torch.launch, repro_torch.launch.serve, repro_torch.launch.train,"
            " repro_torch.training, repro_torch.training.optimizer,"
            " repro_torch.training.train_loop, repro_torch.training.elastic,"
            " repro_torch.distributed.compression, repro_torch.distributed.sharding,"
            " repro_torch.models.moe_ep, repro_torch.launch.mesh,"
            " repro_torch.checkpoint, repro_torch.data.pipeline, repro_torch.tree;"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'repro' or m.startswith('repro.')];"
            "assert not bad, bad"
        )
        env = dict(os.environ, PYTHONPATH=str(SRC))
        proc = subprocess.run([sys.executable, "-c", code], env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr

    def test_default_device_raises_without_cuda(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default store runs")
        with pytest.raises(RuntimeError, match="CUDA"):
            VersionStore(tmp_path)
        with pytest.raises(RuntimeError, match="CUDA"):
            Repository(tmp_path)
        # a CUDA tensor cannot even be made here, so the kernel wrappers'
        # refusal of other devices is checked with the meta device
        from repro_torch.kernels.sparse_apply import sparse_delta_apply

        meta = torch.empty((2, 8, 128), dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="CPU or all on one CUDA"):
            sparse_delta_apply(meta, meta, torch.empty(2, dtype=torch.int32, device="meta"))
