"""A write into a checked-out tree never reaches another tree (CPU).

The JAX package freezes every array a checkout hands out, so a write raises
(tests/test_materializer.py::test_cached_arrays_are_read_only and
test_zero_budget_arrays_also_read_only).  Torch tensors carry no read-only
flag, so the port's contract is the other half of the same guarantee: a
write into any leaf of a tree that a public checkout returned changes no
later checkout of any version, no other result of the same
``checkout_many``, no tree an earlier checkout returned and no tree another
service client was handed.  Each case here states it as "after a write, the
trees are still the committed payloads".

Every write case fails on the port as it was before checkouts copied their
shared leaves: the cache, ``apply_delta``'s pass-through of unchanged
leaves, and the service's coalesced requests each handed one tensor to
several holders.  The last tests pin the other side: an uncached cold
checkout hands out the decoded leaves themselves, with no copy.
"""

import asyncio

import numpy as np
import pytest
import torch

from repro_torch.store import Repository, VersionStore
from repro_torch.store.materializer import Materializer


def payloads():
    """v0 and its child v1, which changes 8 elements of ``w``."""
    rng = np.random.RandomState(0)
    v0 = {"w": rng.randn(64, 1024).astype(np.float32),
          "b": rng.randn(2048).astype(np.float32)}
    v1 = {"w": v0["w"].copy(), "b": v0["b"]}
    v1["w"][0, :8] += 1.0
    return v0, v1


def committed(tmp_path, **store_kwargs):
    store = VersionStore(tmp_path, device="cpu", **store_kwargs)
    want = payloads()
    vids = [store.commit(want[0])]
    vids.append(store.commit(want[1], parents=[vids[0]]))
    assert store.versions[vids[1]].stored_base == vids[0]  # a delta
    return store, vids, [{k: torch.from_numpy(a) for k, a in p.items()} for p in want]


def equal(tree, want) -> bool:
    return set(tree) == set(want) and all(torch.equal(tree[k], want[k]) for k in want)


def warm(store, v0, v1):
    store.checkout(v1)
    return store.checkout(v1), ("w", v1), []


def zero_budget(store, v0, v1):
    t0, t1 = store.checkout_many([v0, v1])
    return t0, ("b", v0), [(t1, v1)]


def batch_shares_b(store, v0, v1):
    t0, t1 = store.checkout_many([v0, v1])
    return t1, ("b", v1), [(t0, v0)]


def same_vid_twice(store, v0, v1):
    t, u = store.checkout_many([v1, v1])
    return t, ("w", v1), [(u, v1)]


def earlier_tree(store, v0, v1):
    first = store.checkout(v1)
    return store.checkout(v1), ("w", v1), [(first, v1)]


CASES = {
    "warm": (warm, {}),
    "cache_budget_bytes=0": (zero_budget, {"cache_budget_bytes": 0}),
    "checkout_many([v0, v1]) sharing b": (batch_shares_b, {}),
    "checkout_many([v1, v1])": (same_vid_twice, {}),
    "an earlier checkout's tree": (earlier_tree, {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_write_reaches_no_other_tree(tmp_path, case):
    drive, store_kwargs = CASES[case]
    store, (v0, v1), want = committed(tmp_path, **store_kwargs)
    by_vid = {v0: want[0], v1: want[1]}
    tree, (key, vid), others = drive(store, v0, v1)
    assert equal(tree, by_vid[vid])
    tree[key].view(-1)[0] = 123.0
    for other, other_vid in others:
        assert equal(other, by_vid[other_vid]), "the write reached another result"
    later = store.checkout_many([v0, v1, v1])
    assert [equal(t, by_vid[v]) for t, v in zip(later, (v0, v1, v1))] == [True] * 3
    assert equal(store.checkout(vid), by_vid[vid])


def test_coalesced_service_clients_get_their_own_trees(tmp_path):
    repo = Repository(tmp_path, device="cpu")
    want = payloads()
    vids = [repo.commit(p) for p in want]  # on main: v1's parent is v0
    v1_want = {k: torch.from_numpy(a) for k, a in want[1].items()}

    async def serve():
        async with repo.serve(readers=2, batch_window_s=0.005) as svc:
            a, b = await asyncio.wait_for(
                asyncio.gather(svc.checkout(vids[1]), svc.checkout(vids[1])), 10)
            assert svc.metrics.counter("checkout.coalesced") == 1
            a["w"][0, 0] = 123.0
            a["b"][0] = 77.0
            later = await asyncio.wait_for(svc.checkout(vids[1]), 10)
            return b, later

    b, later = asyncio.run(serve())
    assert equal(b, v1_want), "one client's write reached the other's tree"
    assert equal(later, v1_want)
    assert equal(repo.checkout(vids[1]), v1_want)


def _spy(monkeypatch) -> list:
    """Record the trees the materializer decoded before any copy."""
    seen = []
    inner = Materializer._checkout

    def spy(self, vids):
        trees, out = inner(self, vids)
        seen.append([dict(t) for t in out])
        return trees, out

    monkeypatch.setattr(Materializer, "_checkout", spy)
    return seen


def test_uncached_cold_checkout_copies_nothing(tmp_path, monkeypatch):
    store, (v0, v1), want = committed(tmp_path, cache_budget_bytes=0)
    seen = _spy(monkeypatch)
    tree = store.checkout(v1)
    assert equal(tree, want[1])
    # every leaf is the decoded tensor itself, and shares storage with nothing
    assert all(tree[k] is seen[0][0][k] for k in tree)
    ptrs = [t.untyped_storage().data_ptr() for t in tree.values()]
    assert len(set(ptrs)) == len(tree) == 2


def test_warm_checkout_copies_only_what_the_cache_holds(tmp_path, monkeypatch):
    store, (v0, v1), want = committed(tmp_path)
    store.checkout(v1)
    cached = {t.untyped_storage().data_ptr()
              for held in store.materializer.cache.trees() for t in held.values()}
    tree = store.checkout(v1)
    assert equal(tree, want[1])
    assert not {t.untyped_storage().data_ptr() for t in tree.values()} & cached
    # a tree too large for the budget is not cached: its leaves go out as they are
    store2, (u0, u1), _ = committed(tmp_path / "small", cache_budget_bytes=1024)
    seen = _spy(monkeypatch)
    tree2 = store2.checkout(u1)
    assert all(tree2[k] is seen[0][0][k] for k in tree2)
