"""The port's repack against the JAX package's, on the same history.

Both packages commit one branching history (a few hundred KiB per version,
sparse edits, a reshape, a tombstone, a dtype change) from the same numpy
payloads, which gives byte-identical stores.  Then:

* ``build_cost_graph`` must measure the same Δ/Φ matrix (edge arrays) and
  persist the same ``edge_cache``;
* ``repack`` with Problems 3 and 6 — the JAX package on ``"numpy"`` and on
  ``"jax"`` (``pallas=False``), the port on ``"torch"`` with
  ``device="cpu"`` — must write the same objects and the same
  ``meta.msgpack`` (apart from each package's backend name), and each
  package must check out the other's repacked store to the committed
  payloads;
* a spec that names no backend selects with ``"torch"`` on the store's
  device; ``gc``, frequency-aware repack with its cache prefetch, and the
  refusal of a ``pallas`` option and of a string solver name are covered
  too.
"""

import shutil
import time

import msgpack
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.store import Repository as JaxRepository
from test_torch_store import _leaf, _object_keys, _poke, _torch_payload, assert_same_tree

import repro_torch.core as tcore
from repro_torch.store import Repository


def _history(seed=3):
    """[(branch, parent ref or None, payload)]: ~315 KiB per version."""
    rng = np.random.RandomState(seed)
    p = {
        "feat": {"x": _leaf(rng, (96, 512), "float32"),
                 "z": _leaf(rng, (64, 256), "bfloat16")},
        "tok": _leaf(rng, (60000,), "int8"),
        "w": _leaf(rng, (128, 128), "float16"),
    }

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

    m1 = edit(p, x=_poke(rng, p["feat"]["x"], 6), tok=_poke(rng, p["tok"], 5))
    m2 = edit(m1, z=_poke(rng, m1["feat"]["z"], 4), w=_poke(rng, m1["w"], 3))
    m3 = edit(m2, tok=m2["tok"].reshape(200, 300), x=_poke(rng, m2["feat"]["x"], 9))
    m4 = edit(m3, w=None, x=_poke(rng, m3["feat"]["x"], 5))
    d1 = edit(m1, w=_poke(rng, m1["w"], 7), x=_poke(rng, m1["feat"]["x"], 3))
    d2 = edit(d1, z=d1["feat"]["z"].astype(np.float32))
    d3 = edit(d2, z=_poke(rng, d2["feat"]["z"], 4), tok=_poke(rng, d2["tok"], 8))
    return [("main", None, p), ("main", None, m1), ("main", None, m2),
            ("main", None, m3), ("main", None, m4), ("dev", 2, d1),
            ("dev", None, d2), ("dev", None, d3)]


def _flat(payload, prefix=""):
    out = {}
    for k, v in sorted(payload.items()):
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.fixture(scope="module")
def committed(tmp_path_factory):
    """Both packages' stores of the same history, and the ground truth."""
    base = tmp_path_factory.mktemp("committed")
    steps = _history()
    mp = pytest.MonkeyPatch()
    mp.setattr(time, "time", lambda: 1_700_000_000.25)  # created_at
    try:
        jrepo = JaxRepository(base / "jax", cache_budget_bytes=1 << 24)
        trepo = Repository(base / "torch", device="cpu", cache_budget_bytes=1 << 24)
        vids = []
        for branch, parent, payload in steps:
            vj = jrepo.commit(payload, branch=branch, parent=parent)
            vt = trepo.commit(_torch_payload(payload), branch=branch, parent=parent)
            assert vj == vt
            vids.append(vj)
        jrepo.close()
        trepo.close()
    finally:
        mp.undo()
    truth = {vid: _flat(payload) for vid, (_, _, payload) in zip(vids, steps)}
    return base, truth


@pytest.fixture
def stores(committed, tmp_path):
    """Fresh copies of both committed stores."""
    base, truth = committed
    jroot, troot = tmp_path / "jax", tmp_path / "torch"
    shutil.copytree(base / "jax", jroot)
    shutil.copytree(base / "torch", troot)
    return jroot, troot, truth


def _meta(root, backend_name):
    """meta.msgpack as a dict, without the fields that hold a clock or the
    package's own backend name."""
    meta = msgpack.unpackb((root / "meta.msgpack").read_bytes(), raw=False)
    for m in meta["versions"].values():
        m.pop("created_at")
    rec = meta.get("last_repack")
    if rec:
        rec.pop("timestamp")
        assert rec.pop("backend") == backend_name
    return meta


def _assert_same_store(jroot, troot, jax_backend, port_backend):
    assert _object_keys(troot) == _object_keys(jroot)
    for key in _object_keys(jroot):
        assert (troot / key).read_bytes() == (jroot / key).read_bytes(), key
    assert _meta(troot, port_backend) == _meta(jroot, jax_backend)


def _check_out_all(jroot, troot, truth):
    """Each package checks out the other's store, to the committed payloads."""
    port = Repository(jroot, device="cpu", cache_budget_bytes=0)
    jax = JaxRepository(troot, cache_budget_bytes=0)
    for vid, want in truth.items():
        assert_same_tree(port.checkout(vid), want, ordered=False)
        got = jax.checkout(vid)
        assert sorted(got) == sorted(want)
        for k, arr in want.items():
            assert np.asarray(got[k]).tobytes() == np.asarray(arr).tobytes(), (vid, k)


def _specs(jrepo, trepo, problem, jax_backend):
    """The same grid point for both packages, with bounds from the cost
    graph.  Both stores measure it here, in the same state: a measured Δ is
    a compressed size, and the key order of a checkout (hence of a delta's
    wire bytes) follows the checkout path, which the cache settings steer."""
    g, _ = jrepo.store.build_cost_graph()
    trepo.store.build_cost_graph()
    if problem == 3:
        kw = {"beta": jcore.minimum_storage_tree(g).storage_cost() * 1.1}
    else:
        kw = {"theta": jcore.shortest_path_tree(g).max_recreation() * 1.5}
    jspec = jcore.OptimizeSpec.problem(problem, backend=jax_backend, **kw)
    return jspec, tcore.OptimizeSpec.problem(problem, backend="torch", **kw)


class TestBuildCostGraph:
    def test_same_matrix_and_edge_cache(self, stores):
        jroot, troot, _ = stores
        jstore = JaxRepository(jroot).store
        tstore = Repository(troot, device="cpu").store
        gj, _ = jstore.build_cost_graph()
        gt, _ = tstore.build_cost_graph()
        assert (gt.n, gt.directed) == (gj.n, gj.directed)
        ej, et = gj.arrays(), gt.arrays()
        for name in ("src", "dst", "delta", "phi", "row_ptr", "rperm"):
            np.testing.assert_array_equal(getattr(et, name), getattr(ej, name))
        assert tstore._edge_cache == jstore._edge_cache
        assert tstore.last_measured_edges == jstore.last_measured_edges > 0
        # persisted: a reopened store re-measures nothing
        again = Repository(troot, device="cpu").store
        again.build_cost_graph()
        assert again.last_measured_edges == 0


class TestRepack:
    @pytest.mark.parametrize("jax_backend", ["numpy", "jax"])
    @pytest.mark.parametrize("problem", [3, 6])
    def test_same_objects_and_meta(self, stores, problem, jax_backend):
        jroot, troot, truth = stores
        jrepo = JaxRepository(jroot, cache_budget_bytes=0)
        trepo = Repository(troot, device="cpu", cache_budget_bytes=0)
        jspec, tspec = _specs(jrepo, trepo, problem, jax_backend)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(time, "time", lambda: 1_700_000_100.5)
            jres = jrepo.repack(jspec)
            tres = trepo.repack(tspec)
        assert tres["optimize"]["backend"] == "torch"
        assert jres["optimize"]["backend"] == jax_backend
        for key in ("before", "after", "gc_freed_bytes"):
            assert tres[key] == jres[key]
        assert tres["optimize"]["objective_value"] == jres["optimize"]["objective_value"]
        assert tres["gc_freed_bytes"] > 0
        _assert_same_store(jroot, troot, jax_backend, "torch")
        _check_out_all(jroot, troot, truth)

    def test_default_spec_runs_on_the_store_device(self, stores):
        # a spec that names no backend selects with "torch" where the store
        # runs (here the CPU's plain versions), as the JAX package's "jax"
        jroot, troot, _ = stores
        jrepo, trepo = JaxRepository(jroot), Repository(troot, device="cpu")
        theta = _specs(jrepo, trepo, 6, "numpy")[0].bound("max_recreation")
        jres = jrepo.repack(jcore.OptimizeSpec.problem(6, theta=theta, backend="jax"))
        tres = trepo.repack(tcore.OptimizeSpec.problem(6, theta=theta))
        assert tres["optimize"]["backend"] == "torch"
        assert tres["after"] == jres["after"]
        _assert_same_store(jroot, troot, "jax", "torch")

    def test_pallas_option_and_solver_names_are_refused(self, stores):
        _, troot, _ = stores
        repo = Repository(troot, device="cpu")
        with pytest.raises(ValueError, match="pallas"):
            repo.repack(tcore.OptimizeSpec.problem(6, theta=1.0, pallas=False))
        with pytest.raises(TypeError, match="OptimizeSpec"):
            repo.repack("mp")
        with pytest.raises(TypeError):
            repo.repack(tcore.OptimizeSpec.problem(6, theta=1.0), theta=2.0)
        assert repo.store.last_repack is None

    def test_empty_store(self, tmp_path):
        res = Repository(tmp_path, device="cpu").repack(
            tcore.OptimizeSpec.problem(2, backend="torch"))
        assert res["gc_freed_bytes"] == 0 and res["after"]["storage_bytes"] == 0


class TestGcAndPrefetch:
    def test_gc_frees_only_orphans(self, stores):
        jroot, troot, _ = stores
        trepo = Repository(troot, device="cpu")
        jrepo = JaxRepository(jroot)
        assert trepo.gc() == jrepo.gc() == 0
        orphan = b"an object no version references" * 100
        for repo in (trepo, jrepo):
            repo.store.objects.put(orphan)
        freed = trepo.gc()
        assert freed == jrepo.gc() > 0
        assert _object_keys(troot) == _object_keys(jroot)
        assert trepo.gc() == 0

    def test_frequency_aware_repack_prefetches(self, stores):
        jroot, troot, truth = stores
        hot = [2, 7, 7, 5, 7, 2]
        kw = {"cache_budget_bytes": 1 << 24, "prefetch_hot_k": 2}
        jrepo = JaxRepository(jroot, **kw)
        trepo = Repository(troot, device="cpu", **kw)
        for vid in hot:
            jrepo.checkout(vid)
            trepo.checkout(vid)
        jspec, tspec = _specs(jrepo, trepo, 3, "numpy")
        with pytest.raises(ValueError, match="workload-aware"):
            trepo.repack(tcore.OptimizeSpec.problem(2, backend="torch"),
                         use_access_frequencies=True)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(time, "time", lambda: 1_700_000_200.75)
            jres = jrepo.repack(jspec, use_access_frequencies=True)
            tres = trepo.repack(tspec, use_access_frequencies=True)
        assert tres["after"] == jres["after"]
        assert trepo.store.access_weights() == jrepo.store.access_weights()
        _assert_same_store(jroot, troot, "numpy", "torch")
        # the two hottest versions (and what their new chains pass through)
        # are warm under the new storage graph
        cache = trepo.store.materializer.cache
        assert cache.vids() == jrepo.store.materializer.cache.vids()
        assert {2, 7} <= set(cache.vids())
        assert cache.stats()["purges"] == 1
        hits = cache.hits
        assert_same_tree(trepo.checkout(7), truth[7], ordered=False)
        assert cache.hits == hits + 1
