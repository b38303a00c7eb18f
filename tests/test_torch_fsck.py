"""The port's storage-graph fsck against the JAX package's, on one store.

A history is committed by one package (each case runs twice: the JAX store
writing it, then the port's), corrupted on disk as tests/test_analysis_fsck.py
corrupts its stores, and checked by ``repro.analysis.fsck_store`` and the
port's ``fsck_store`` (``device="cpu"``), each over a store freshly opened
from the same directory.  The reports must be equal as sets of
(rule, severity, subject), with equal counts, and equal in what they checked.

The history keeps an int64 leaf.  Unchanged, it passes through both
packages alike.  Edited sparsely, it shows the reference's int64 narrowing
(ROADMAP Queue 3): the JAX store checks such a version out as int32, so its
fsck flags the version's fingerprint on a store the port committed, where
the port's fsck finds nothing; ``test_int64_leaf_edited_sparsely`` pins that
difference.
"""

from collections import Counter

import numpy as np
import pytest

from repro.analysis import fsck_store as jax_fsck
from repro.core import OptimizeSpec as JaxSpec
from repro.store import Repository as JaxRepository
from repro.store import VersionStore as JaxStore
from repro_torch.analysis import Severity, fsck_store
from repro_torch.core import OptimizeSpec
from repro_torch.store import Repository, VersionStore

WRITERS = ("jax", "torch")


def payload(seed: int, shape=(48, 32)):
    rng = np.random.RandomState(seed)
    return {
        "w": rng.randn(*shape).astype(np.float32),
        "b": rng.randn(shape[1]).astype(np.float32),
        "ids": rng.randint(0, 2**40, size=1500).astype(np.int64),
    }


def open_repo(writer, root):
    if writer == "jax":
        return JaxRepository(root)
    return Repository(root, device="cpu")


def edit(tree, i, key="w"):
    tree = dict(tree)
    x = np.array(tree[key])
    x[i, :4] += 1.0
    tree[key] = x
    return tree


def build(writer, root):
    """v1 full, v2..v4 small edits of ``w`` (delta storage), ``ids``
    unchanged throughout."""
    repo = open_repo(writer, root)
    tree = payload(0)
    repo.commit(tree, message="c0")
    for i in range(1, 4):
        tree = edit(tree, i)
        repo.commit(tree, message=f"c{i}")
    assert repo.store.versions[4].stored_base == 3
    return repo, tree


def both_reports(root, **kw):
    return jax_fsck(JaxStore(root), **kw), fsck_store(VersionStore(root, device="cpu"), **kw)


def findings(report):
    return Counter((f.rule, str(f.severity), f.subject) for f in report.findings)


def assert_equal_reports(root, **kw):
    jr, tr = both_reports(root, **kw)
    assert findings(tr) == findings(jr)
    assert tr.checked == jr.checked
    return findings(tr)


def obj_path(store, vid):
    return store.objects._path(store.versions[vid].object_key)


# -- corruptions: each edits the writer's store and returns the findings
# -- (rule, subject) both reports must hold at least
def clean(repo, root, writer):
    return set()


def cycle(repo, root, writer):
    s = repo.store
    s.versions[3].stored_base, s.versions[4].stored_base = 4, 3
    s._save_meta()
    return {("fsck.cycle", "v3")}


def dangling(repo, root, writer):
    s = repo.store
    s.versions[4].parents = [99]
    s.versions[3].stored_base = 42
    s._save_meta()
    return {("fsck.dangling-parent", "v4"), ("fsck.dangling-base", "v3")}


def missing_object(repo, root, writer):
    obj_path(repo.store, 2).unlink()
    return {("fsck.missing-object", "v2")}


def orphan(repo, root, writer):
    key, _ = repo.store.objects.put(b"orphaned bytes that no version references")
    return {("fsck.orphan-object", f"object:{key[:12]}")}


def truncated(repo, root, writer):
    p = obj_path(repo.store, 4)
    blob = p.read_bytes()
    p.write_bytes(blob[: len(blob) // 2])
    return {("fsck.unreadable", "v4")}


def bit_flip(repo, root, writer):
    p = obj_path(repo.store, 2)
    blob = bytearray(p.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    p.write_bytes(bytes(blob))
    return {("fsck.fingerprint", "v2")}


def bad_ref(repo, root, writer):
    repo.store.refs["branches"]["ghost"] = 999
    repo.store.refs["head"] = "nope"
    repo.store._save_meta()
    return {("fsck.ref", "branch:ghost"), ("fsck.ref", "head:nope")}


def broken_constraint(repo, root, writer):
    s = repo.store
    spec = JaxSpec if writer == "jax" else OptimizeSpec
    repo.repack(spec.problem(6, theta=10.0))
    m = max(s.recreation_cost(v) for v in s.versions)
    s.last_repack["constraints"] = [{"metric": "max_recreation", "bound": m + 0.004}]
    s._save_meta()
    assert not findings(both_reports(root)[1])  # held right after the repack
    tree = {k: np.array(v) for k, v in repo.checkout().items()}
    for i in range(3):
        tree = edit(tree, i)
        repo.commit(tree, message=f"drift {i}")
    return {("fsck.constraint", "constraint:max_recreation")}


CORRUPTIONS = [clean, cycle, dangling, missing_object, orphan, truncated,
               bit_flip, bad_ref, broken_constraint]


@pytest.mark.parametrize("writer", WRITERS)
@pytest.mark.parametrize("corrupt", CORRUPTIONS, ids=lambda f: f.__name__)
def test_reports_equal(tmp_path, writer, corrupt):
    root = tmp_path / "store"
    repo, _ = build(writer, root)
    expected = corrupt(repo, root, writer)
    got = assert_equal_reports(root)
    assert {(rule, subj) for rule, _, subj in got} >= expected
    if corrupt is clean:
        assert not got
    if corrupt is orphan:
        assert {sev for rule, sev, _ in got} == {str(Severity.WARNING)}


@pytest.mark.parametrize("writer", WRITERS)
def test_sampled_reports_equal(tmp_path, writer):
    root = tmp_path / "store"
    build(writer, root)
    jr, tr = both_reports(root, sample=2)
    assert findings(tr) == findings(jr) == Counter()
    assert tr.checked == jr.checked and tr.checked["fsck.fingerprint"] == 2


@pytest.mark.parametrize("writer", WRITERS)
def test_int64_leaf_edited_sparsely(tmp_path, writer):
    root = tmp_path / "store"
    repo, tree = build(writer, root)
    tree = dict(tree)
    ids = tree["ids"].copy()
    ids[5] = 2**40 + 7
    tree["ids"] = ids
    vid = repo.commit(tree, message="edit ids")
    jr, tr = both_reports(root)
    narrowed = Counter({("fsck.fingerprint", "error", f"v{vid}"): 1})
    if writer == "jax":
        # the JAX store wrote a delta of the narrowed leaf: both re-decode it
        # to something else than what was committed
        assert findings(jr) == findings(tr) == narrowed
    else:
        # the port wrote the true int64 delta; only the JAX re-decode narrows
        assert findings(tr) == Counter()
        assert findings(jr) == narrowed
    assert tr.checked == jr.checked


def test_repository_and_store_fsck_are_the_port_fsck(tmp_path):
    repo, _ = build("torch", tmp_path / "store")
    assert repo.fsck().findings == repo.store.fsck().findings == []
    report = repo.fsck(sample=1)
    assert report.checked["fsck.fingerprint"] == 1
    assert "repro_torch.analysis fsck" in report.render()
