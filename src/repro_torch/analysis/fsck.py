"""Storage-graph fsck — integrity checking for a VersionStore on disk.

The port's copy of the JAX package's ``repro.analysis.fsck``: the same
checks, rule ids, severities and subjects.  The independent chain re-decode
runs the port's codec on the store's device (the one-hop sparse kernel on
the card, its plain version with ``device="cpu"``).

Walks the physical storage graph the way ``git fsck`` walks an object
database, reporting :class:`~repro.analysis.findings.Finding`\\ s instead of
raising: a corrupted store should produce a complete damage report, not die
on the first bad object.

Checks (rule ids):

``fsck.dangling-parent`` / ``fsck.dangling-base`` (ERROR)
    Derivation parents / storage bases referencing unknown version ids.
``fsck.cycle`` (ERROR)
    ``stored_base`` chains must be acyclic — a cycle makes every version on
    it unrecreatable (checkout would never reach a full object).
``fsck.missing-object`` (ERROR)
    A version's ``object_key`` has no object file.
``fsck.orphan-object`` (WARNING)
    An object file no version references (leaked bytes; ``gc()`` reclaims).
``fsck.unreadable`` (ERROR)
    Decoding a version's storage chain raised (truncated/corrupt payload,
    codec failure, malformed wire format).
``fsck.fingerprint`` (ERROR)
    Recomputed content fingerprint differs from the recorded one —
    **bit-level payload corruption**.  The chain is re-decoded here
    independently of the materialization cache: the cache key is the
    storage-graph fingerprint (vid/base/key triples), which a bit flip
    inside an object file does *not* change, so a cached tree would mask
    exactly the corruption this check exists to find.  Sampled via
    ``sample=`` on big stores; full sweep by default.
``fsck.ref`` (ERROR)
    Branch/tag pointing at an unknown version; head naming a missing branch.
``fsck.constraint`` (ERROR)
    The store records the spec of its last ``repack`` (``last_repack`` in
    the metadata).  The recorded constraint bounds are re-validated against
    the *current* storage graph with the solvers' ``CONSTRAINT_TOL`` — a
    post-repack mutation that broke an agreed ``storage<=beta`` /
    ``max_recreation<=theta`` bound is drift worth failing CI over.
    Skipped when the graph has cycles or dangling bases (the metrics are
    undefined there; those errors are already reported).
"""

from __future__ import annotations

import hashlib
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence

from ..core.solvers import CONSTRAINT_TOL
from ..store.delta import FlatTree, apply_delta, decode_full, encode_full
from .findings import Finding, Report, Severity

if TYPE_CHECKING:  # pragma: no cover
    from ..store.version_store import VersionStore


def _storage_cycles(versions) -> List[List[int]]:
    """Cycles in the ``stored_base`` functional graph (each as a vid list)."""
    color: Dict[int, int] = {}  # 0/absent=white, 1=on current path, 2=done
    cycles: List[List[int]] = []
    for start in sorted(versions):
        if color.get(start):
            continue
        path: List[int] = []
        v: Optional[int] = start
        while v is not None and v in versions and not color.get(v):
            color[v] = 1
            path.append(v)
            v = versions[v].stored_base
        if v is not None and color.get(v) == 1:
            cycles.append(path[path.index(v):])
        for u in path:
            color[u] = 2
    return cycles


def _sample_vids(vids: Sequence[int], sample: Optional[int]) -> List[int]:
    """Deterministic evenly-spaced subset (first and last always included)."""
    vids = sorted(vids)
    if sample is None or sample >= len(vids) or sample <= 0:
        return list(vids)
    if sample == 1:
        return [vids[-1]]
    step = (len(vids) - 1) / (sample - 1)
    return sorted({vids[round(i * step)] for i in range(sample)})


def _decode_chain(store: "VersionStore", vid: int,
                  memo: Dict[int, FlatTree]) -> FlatTree:
    """Recreate ``vid`` straight from object payloads (no materializer cache;
    see the ``fsck.fingerprint`` rationale in the module docstring)."""
    chain: List[int] = []
    v: Optional[int] = vid
    while v is not None and v not in memo:
        chain.append(v)
        v = store.versions[v].stored_base
    tree = memo[v] if v is not None else None
    for u in reversed(chain):
        payload = store.objects.get(store.versions[u].object_key)
        tree = decode_full(payload) if tree is None else \
            apply_delta(tree, payload, device=store.device)
        memo[u] = tree
    return memo[vid]


def fsck_store(store: "VersionStore", *,
               sample: Optional[int] = None) -> Report:
    """Run every fsck check over ``store``; returns a :class:`Report`.

    ``sample`` bounds how many versions get the (expensive) independent
    chain re-decode + fingerprint recomputation; graph/object/ref checks
    are always exhaustive.
    """
    report = Report(tool="fsck")
    versions = store.versions

    # ---- graph shape: dangling references, cycles -------------------------
    decodable = set(versions)
    for vid in sorted(versions):
        report.bump("fsck.dangling-parent")
        report.bump("fsck.dangling-base")
        meta = versions[vid]
        for p in meta.parents:
            if p not in versions:
                report.add(Finding(
                    "fsck.dangling-parent", Severity.ERROR, f"v{vid}",
                    f"derivation parent v{p} does not exist",
                    "restore the missing version's metadata or rewrite the "
                    "parents list",
                ))
        b = meta.stored_base
        if b is not None and b not in versions:
            decodable.discard(vid)
            report.add(Finding(
                "fsck.dangling-base", Severity.ERROR, f"v{vid}",
                f"stored_base v{b} does not exist — the version is "
                f"unrecreatable",
                "re-encode the version as a full object or against a "
                "surviving base (repack does both)",
            ))
    report.bump("fsck.cycle", len(versions))
    cycles = _storage_cycles(versions)
    on_cycle = {v for cyc in cycles for v in cyc}
    for cyc in cycles:
        loop = " -> ".join(f"v{v}" for v in cyc + cyc[:1])
        report.add(Finding(
            "fsck.cycle", Severity.ERROR, f"v{min(cyc)}",
            f"stored_base cycle: {loop} — no member can ever reach a full "
            f"object",
            "break the cycle by re-encoding one member as a full object",
        ))

    # ---- object inventory -------------------------------------------------
    live = {m.object_key for m in versions.values()}
    for vid in sorted(versions):
        report.bump("fsck.missing-object")
        meta = versions[vid]
        if not store.objects.exists(meta.object_key):
            decodable.discard(vid)
            report.add(Finding(
                "fsck.missing-object", Severity.ERROR, f"v{vid}",
                f"object {meta.object_key[:12]}… is gone from the object "
                f"store",
                "restore the object file from a replica; the version (and "
                "every delta stored against it) is unrecreatable until then",
            ))
    for key in sorted(store.objects.keys()):
        report.bump("fsck.orphan-object")
        if key not in live:
            report.add(Finding(
                "fsck.orphan-object", Severity.WARNING, f"object:{key[:12]}",
                f"object {key[:12]}… ({store.objects.stored_size(key)} B) is "
                f"referenced by no version",
                "run gc() to reclaim the bytes (repack does this "
                "automatically)",
            ))

    # ---- refs -------------------------------------------------------------
    refs = store.refs
    for kind, singular in (("branches", "branch"), ("tags", "tag")):
        for name, vid in sorted(refs.get(kind, {}).items()):
            report.bump("fsck.ref")
            if vid not in versions:
                report.add(Finding(
                    "fsck.ref", Severity.ERROR, f"{singular}:{name}",
                    f"{singular} {name!r} points at unknown version v{vid}",
                    "delete the ref or repoint it at a surviving version",
                ))
    if refs.get("branches"):
        report.bump("fsck.ref")
        head = refs.get("head")
        if head not in refs["branches"]:
            report.add(Finding(
                "fsck.ref", Severity.ERROR, f"head:{head}",
                f"head names branch {head!r}, which does not exist",
                "switch() to an existing branch",
            ))

    # ---- payload integrity: independent re-decode + fingerprint -----------
    # only chains that are structurally sound can be decoded; every vid
    # excluded here is already covered by an ERROR above
    blocked = set(on_cycle)
    changed = True
    while changed:  # propagate undecodability down base chains
        changed = False
        for vid in list(decodable):
            b = versions[vid].stored_base
            if b is not None and (b in blocked or b not in decodable):
                decodable.discard(vid)
                blocked.add(vid)
                changed = True
    decodable -= blocked
    memo: Dict[int, FlatTree] = {}
    for vid in _sample_vids(sorted(decodable), sample):
        report.bump("fsck.fingerprint")
        meta = versions[vid]
        try:
            flat = _decode_chain(store, vid, memo)
        except Exception as e:
            report.add(Finding(
                "fsck.unreadable", Severity.ERROR, f"v{vid}",
                f"decoding the storage chain raised "
                f"{type(e).__name__}: {e}",
                "the stored payload (or one of its bases) is corrupt; "
                "restore from a replica",
            ))
            memo[vid] = None  # poison: dependents fail fast, not misleadingly
            continue
        fp = hashlib.sha256(encode_full(flat)).hexdigest()
        if meta.content_fp and fp != meta.content_fp:
            report.add(Finding(
                "fsck.fingerprint", Severity.ERROR, f"v{vid}",
                f"recomputed content fingerprint {fp[:12]}… != recorded "
                f"{meta.content_fp[:12]}… — payload bytes changed at rest",
                "bit-level corruption in this version's chain; restore the "
                "affected object(s) from a replica",
            ))

    # ---- recorded optimization constraints --------------------------------
    lr = store.last_repack
    if lr and lr.get("constraints") and versions:
        structurally_sound = not cycles and all(
            (m.stored_base is None or m.stored_base in versions)
            for m in versions.values()
        )
        for cons in lr["constraints"]:
            report.bump("fsck.constraint")
            metric, bound = cons["metric"], float(cons["bound"])
            if not structurally_sound:
                continue  # metrics undefined; graph errors already reported
            if metric == "storage":
                achieved = float(store.storage_bytes())
            else:
                costs = [store.recreation_cost(v) for v in versions]
                achieved = (max(costs) if metric == "max_recreation"
                            else sum(costs))
            if achieved > bound + CONSTRAINT_TOL:
                report.add(Finding(
                    "fsck.constraint", Severity.ERROR,
                    f"constraint:{metric}",
                    f"last repack ({lr.get('describe', '?')}) bounded "
                    f"{metric} <= {bound:g}, but the current storage graph "
                    f"achieves {achieved:g}",
                    "the storage graph drifted past its agreed bound since "
                    "the last repack; repack again with the same spec",
                ))
    return report
