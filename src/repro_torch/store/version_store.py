"""VersionStore — the paper's system: commit and checkout over a storage graph.

Tracks a *version graph* (derivation DAG from commits and branches) and a
*storage graph* (what is physically stored: full objects and deltas).  The
on-disk store is the JAX package's: the same ``meta.msgpack`` and the same
object keys and bytes, so a store committed by either package opens and
checks out bit-identically in the other.

Commit path: a new version is stored as a delta against its first parent's
payload when that is smaller than storing it whole; the changed-block masks
run on ``device``.

Repack path: ``build_cost_graph`` measures the Δ/Φ matrix around the
derivation DAG (cached per content fingerprint in the metadata, in the JAX
package's format), ``repack`` solves an
:class:`~repro_torch.core.spec.OptimizeSpec` over it with
:func:`~repro_torch.core.problems.optimize` on the store's ``device`` (the
spec's ``backend="torch"`` selects on the card through the segment kernels),
rewrites storage to match and garbage-collects the orphaned objects.  Given
the same history and spec it writes the same objects and metadata as the JAX
package.

Checkout path: every checkout routes through the
:class:`~repro_torch.store.materializer.Materializer` — a planner that
compiles one or many requested vids into a topologically ordered decode plan
(shared storage-chain prefixes decoded once), executed on ``device`` through
a byte-budgeted LRU cache of FlatTrees validated per entry against a
fingerprint (per decode chain by default, see the materializer).  Checked-out
tensors are shared with the cache: copy before writing into one.

``device`` defaults to the card (``"cuda"``); without a CUDA device the store
raises rather than carrying on on the CPU.  Pass ``device="cpu"`` to run the
plain PyTorch versions of the kernels.

Concurrency: single writer, many readers.  Checkouts may run from several
threads; the cache takes its own lock, and access-count bumps, vid
allocation and metadata writes are guarded by the store lock.

Access counts are flushed to the metadata file every ``access_flush_every``
checkouts and on ``close``, so counts survive a reload.

``fsck`` checks the storage graph, objects, refs and recorded constraints
(:func:`~repro_torch.analysis.fsck.fsck_store`).  A ``tradeoff_monitor``
(:class:`~repro_torch.obs.tradeoff.TradeoffMonitor`), when attached, samples
the (C, R) tradeoff after every commit and repack.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from ..core import OptimizeSpec, StorageSolution, VersionGraph, optimize
from ..kernels import resolve_device
from ..obs.tracer import span as _span
from . import wire
from .delta import (
    FlatTree,
    RecreationCostModel,
    encode_delta,
    encode_full,
    flatten_payload,
)
from .materializer import Materializer
from .materializer import storage_fingerprint as _storage_graph_fp
from .objectstore import ObjectStore

@dataclasses.dataclass
class VersionMeta:
    vid: int
    parents: List[int]                  # derivation parents (version graph)
    message: str
    created_at: float
    raw_bytes: int                      # uncompressed payload size
    # physical storage: either a full object or a delta from `stored_base`
    stored_base: Optional[int] = None   # None => materialized
    object_key: str = ""
    stored_bytes: int = 0
    phi: float = 0.0                    # recreation cost of this edge
    access_count: int = 0
    content_fp: str = ""                # sha256 of the full (uncompressed) payload


class _PayloadProvider:
    """Lazy edge-payload encoder backing ``repack``.

    Maps ``(src, dst)`` to ``(encoded_payload, stats)`` — a full encoding for
    ``src == 0``, a delta otherwise — materializing checkouts and encodings
    on first use only, so ``repack`` encodes just the n−1 edges the solver
    chose, not every measured candidate pair.  Checkouts go through the
    store's shared materialization cache; every encoding is memoised in host
    memory for the provider's lifetime (one repack).
    """

    def __init__(self, store: "VersionStore") -> None:
        self._store = store
        self._memo: Dict[Tuple[int, int], Tuple[bytes, Dict]] = {}

    def flat(self, vid: int) -> FlatTree:
        return self._store._checkout_flat(vid)

    def full_payload(self, vid: int) -> bytes:
        return self[(0, vid)][0]

    def __getitem__(self, key: Tuple[int, int]) -> Tuple[bytes, Dict]:
        if key not in self._memo:
            src, dst = key
            if src == 0:
                self._memo[key] = (encode_full(self.flat(dst)), {})
            else:
                # one batched plan: the pair's shared chain prefix is decoded
                # once even when the cache can't hold it (tiny/zero budgets)
                src_t, dst_t = self._store.materializer.checkout_shared(
                    [src, dst]
                )
                self._memo[key] = encode_delta(
                    src_t, dst_t, device=self._store.device
                )
        return self._memo[key]


class VersionStore:
    def __init__(
        self,
        root: str | Path,
        *,
        device: Union[str, torch.device] = "cuda",
        cost_model: Optional[RecreationCostModel] = None,
        delta_hops: int = 3,
        cache_budget_bytes: int = 256 << 20,
        access_flush_every: int = 64,
        prefetch_hot_k: int = 8,
        fuse_chains: bool = True,
        cache_invalidation: str = "chain",
    ) -> None:
        self.device = resolve_device(device)
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.objects = ObjectStore(self.root)
        self.cost_model = cost_model or RecreationCostModel()
        self.delta_hops = delta_hops
        self.versions: Dict[int, VersionMeta] = {}
        self._next_vid = 1
        # guards hot state shared with reader threads: access counts, vid
        # allocation, and metadata writes
        self._lock = threading.RLock()
        # measured Δ entries: (src, dst) -> {sfp, dfp, delta, payload_len,
        # changed_blocks}; persisted in the metadata so repack only
        # re-measures pairs whose endpoints changed
        self._edge_cache: Dict[Tuple[int, int], Dict[str, Any]] = {}
        self.last_measured_edges = 0
        # named refs (branches mutable, tags immutable) plus the current
        # branch; owned by the Repository facade, persisted with the metadata
        self.refs: Dict[str, Any] = {"branches": {}, "tags": {}, "head": "main"}
        self.materializer = Materializer(
            self,
            budget_bytes=cache_budget_bytes,
            fuse_chains=fuse_chains,
            invalidation=cache_invalidation,
        )
        self.access_flush_every = access_flush_every
        self.prefetch_hot_k = prefetch_hot_k
        self._unflushed_accesses = 0
        self._storage_fp: Optional[str] = None
        # record of the last repack's spec and outcome, persisted with the
        # metadata (fsck re-validates its constraint bounds)
        self.last_repack: Optional[Dict[str, Any]] = None
        # optional live (C, R) sampler (repro_torch.obs.tradeoff.TradeoffMonitor):
        # when attached, commit/repack notify it.  Sampling is O(n) per
        # event, so the service tier attaches it — not store-building loops.
        self.tradeoff_monitor: Optional[Any] = None
        self._meta_path = self.root / "meta.msgpack"
        if self._meta_path.exists():
            self._load_meta()

    # ------------------------------------------------------------- commits
    def commit(
        self,
        payload: Any,
        *,
        parents: Sequence[int] = (),
        message: str = "",
        update_branch: Optional[str] = None,
    ) -> int:
        """Add a version; returns its id.  ``payload`` is nested dicts,
        lists and tuples of tensors or numpy arrays.

        ``update_branch`` points the named branch ref at the new version in
        the same atomic metadata write as the commit itself."""
        with _span("store.commit") as csp:
            flat = flatten_payload(payload)
            raw = sum(t.nbytes for t in flat.values())
            with self._lock:
                vid = self._next_vid
                self._next_vid += 1

            full_payload = encode_full(flat)
            stored_base = None
            best_obj = full_payload
            best_stats = None
            if parents:
                base_flat = self._checkout_flat(parents[0])
                delta_payload, stats = encode_delta(
                    base_flat, flat, device=self.device
                )
                if len(delta_payload) < len(full_payload):
                    stored_base = parents[0]
                    best_obj = delta_payload
                    best_stats = stats
            key, stored = self.objects.put(best_obj)
            if stored_base is None:
                phi = self.cost_model.phi_full(stored, raw)
            else:
                phi = self.cost_model.phi_delta(
                    stored, len(best_obj), best_stats["changed_blocks"]
                )
            with self._lock:
                self.versions[vid] = VersionMeta(
                    vid=vid,
                    parents=list(parents),
                    message=message,
                    created_at=time.time(),
                    raw_bytes=raw,
                    stored_base=stored_base,
                    object_key=key,
                    stored_bytes=stored,
                    phi=phi,
                    content_fp=hashlib.sha256(full_payload).hexdigest(),
                )
                # a commit only *appends* a (vid, stored_base, object_key)
                # triple: the whole-graph fingerprint rotates, every existing
                # decode chain is untouched
                self._storage_fp = None
                if update_branch is not None:
                    self.refs["branches"][update_branch] = vid
                self._save_meta()
            if csp:
                csp.set(
                    vid=vid,
                    raw_bytes=raw,
                    stored_bytes=stored,
                    encoding="full" if stored_base is None else "delta",
                )
        mon = self.tradeoff_monitor
        if mon is not None:
            mon.on_commit(vid)
        return vid

    # ------------------------------------------------------------ checkout
    def storage_fingerprint(self) -> str:
        """Hash of every (vid, stored_base, object_key) triple — the
        whole-graph cache epoch used by ``cache_invalidation="global"``.
        Changes on commit, never within a read-only workload."""
        with self._lock:
            if self._storage_fp is None:
                self._storage_fp = _storage_graph_fp(self.versions)
            return self._storage_fp

    def chain_fingerprint(self, vid: int) -> str:
        """Fingerprint of ``vid``'s decode chain: a rolling hash over the
        ``(vid, stored_base, object_key)`` triples from ``vid`` down to its
        full object — the append-aware cache tag.  A commit adds triples but
        never rewrites existing ones, so every existing chain fingerprint
        survives commits.  Recomputed per call (out-of-band metadata edits
        are caught), bounded (a corrupted cycle raises), and taken under the
        store lock (a reader never sees a half-mutated graph)."""
        with self._lock:
            h = hashlib.sha256()
            v: Optional[int] = vid
            hops = 0
            while v is not None:
                meta = self.versions[v]
                h.update(
                    f"{v}:{meta.stored_base}:{meta.object_key};".encode()
                )
                v = meta.stored_base
                hops += 1
                if hops > len(self.versions):
                    raise RuntimeError("storage graph cycle")
            return h.hexdigest()

    def checkout(self, vid: int) -> FlatTree:
        """Recreate a version through the materialization layer."""
        return self.checkout_many([vid])[0]

    def checkout_many(self, vids: Sequence[int]) -> List[FlatTree]:
        """Batch checkout: one plan, shared chain prefixes decoded once.

        Bit-identical to ``[checkout(v) for v in vids]``.  Each returned
        tree is the caller's own to write into (see
        :meth:`Materializer.checkout_many`).
        """
        return self._counted_checkout(vids, self.materializer.checkout_many)

    def _counted_checkout(self, vids: Sequence[int], fetch) -> List[FlatTree]:
        """``fetch(vids)``, then the access counts of a served checkout."""
        out = fetch(vids)
        # bump only after success: a KeyError/cycle abort must not inflate
        # the recorded workload
        with self._lock:
            for vid in vids:
                self.versions[vid].access_count += 1
            self._unflushed_accesses += len(vids)
            if self._unflushed_accesses >= self.access_flush_every:
                self.flush_access_counts()
        return out

    def _checkout_flat(self, vid: int) -> FlatTree:
        """Internal read-only checkout: no access-count bump, same
        cache/planner path, tensors shared with the cache."""
        return self.materializer.checkout_shared([vid])[0]

    def flush_access_counts(self) -> None:
        """Persist access counts accumulated since the last metadata write."""
        with self._lock:
            if self._unflushed_accesses:
                self._save_meta()

    def close(self) -> None:
        """Flush pending metadata (access counts).  Safe to call twice."""
        self.flush_access_counts()

    def recreation_cost(self, vid: int) -> float:
        """Modelled Φ along the current storage chain."""
        total = 0.0
        v: Optional[int] = vid
        hops = 0
        while v is not None:
            meta = self.versions[v]
            total += meta.phi
            v = meta.stored_base
            hops += 1
            if hops > len(self.versions):
                raise RuntimeError("storage graph cycle")
        return total

    def storage_bytes(self) -> int:
        return sum(m.stored_bytes for m in self.versions.values())

    # -------------------------------------------------------------- repack
    def build_cost_graph(
        self, *, extra_edges: bool = True
    ) -> Tuple[VersionGraph, _PayloadProvider]:
        """Measure the Δ/Φ matrices over version-graph-adjacent pairs (plus
        pairs within ``delta_hops``) and return (graph, payload provider).

        This is the paper's "revealing entries in the matrix" step: all-pairs
        is infeasible, so we measure around the derivation structure.
        Measured entries are cached in the metadata keyed by the endpoints'
        content fingerprints; unchanged entries are served from the cache
        without touching payloads.  ``last_measured_edges`` records how many
        entries were (re)measured by the call.
        """
        n = len(self.versions)
        g = VersionGraph(n, directed=True)
        provider = _PayloadProvider(self)
        codec = self.objects.codec
        measured = 0

        # legacy metas (pre-fingerprint) get their fingerprint backfilled once
        for vid, meta in self.versions.items():
            if not meta.content_fp:
                meta.content_fp = hashlib.sha256(
                    provider.full_payload(vid)
                ).hexdigest()

        # adjacency of the derivation DAG (undirected, for the hop ball)
        adj: Dict[int, set] = {v: set() for v in self.versions}
        for v, meta in self.versions.items():
            for p in meta.parents:
                adj[v].add(p)
                adj[p].add(v)

        done: set = set()
        for vid, meta in self.versions.items():
            fp = meta.content_fp
            ent = self._edge_cache.get((0, vid))
            if ent is None or ent["dfp"] != fp:
                full_payload = provider.full_payload(vid)
                ent = {
                    "sfp": "",
                    "dfp": fp,
                    "delta": codec.compressed_size(full_payload),
                    "payload_len": len(full_payload),
                    "changed_blocks": 0,
                }
                self._edge_cache[(0, vid)] = ent
                measured += 1
            g.set_materialization(
                vid, ent["delta"],
                self.cost_model.phi_full(ent["delta"], meta.raw_bytes),
            )
            # hop ball
            ball = {vid}
            frontier = {vid}
            hops = self.delta_hops if extra_edges else 1
            for _ in range(hops):
                frontier = {y for x in frontier for y in adj[x]} - ball
                ball |= frontier
            for other in sorted(ball - {vid}):
                if (other, vid) in done:
                    continue
                done.add((other, vid))
                sfp = self.versions[other].content_fp
                ent = self._edge_cache.get((other, vid))
                if ent is None or ent["sfp"] != sfp or ent["dfp"] != fp:
                    payload, stats = provider[(other, vid)]
                    ent = {
                        "sfp": sfp,
                        "dfp": fp,
                        "delta": codec.compressed_size(payload),
                        "payload_len": len(payload),
                        "changed_blocks": stats["changed_blocks"],
                    }
                    self._edge_cache[(other, vid)] = ent
                    measured += 1
                g.set_delta(
                    other, vid, ent["delta"],
                    self.cost_model.phi_delta(
                        ent["delta"], ent["payload_len"], ent["changed_blocks"]
                    ),
                )
        self.last_measured_edges = measured
        if measured:
            self._save_meta()  # persist new measurements for the next call
        return g, provider

    def access_weights(self) -> Dict[int, float]:
        """Normalized access-frequency weights (Laplace-smoothed so an
        unaccessed version still counts) — the workload signal for
        ``repack(use_access_frequencies=True)``."""
        total = sum(m.access_count + 1 for m in self.versions.values())
        return {
            v: (m.access_count + 1) / total for v, m in self.versions.items()
        }

    def repack(
        self, spec: OptimizeSpec, *, use_access_frequencies: bool = False
    ) -> Dict[str, Any]:
        """Re-optimize the storage graph against an
        :class:`~repro_torch.core.spec.OptimizeSpec` and rewrite physical storage
        to match.

        ``use_access_frequencies=True`` routes the recorded access counts
        into the spec's ``workload`` field; the spec must name a
        workload-aware grid point (Problems 3 or 5 — LMG), anything else
        raises instead of silently dropping the weights.

        The solver runs on the store's ``device``: a spec's default
        ``backend="torch"`` selects there (the CUDA kernels on a card, their
        plain versions on the CPU); only ``backend="numpy"`` runs on the host.

        Returns before/after stats, ``gc_freed_bytes`` (orphaned object
        bytes reclaimed by the gc pass — repack never leaves dangling
        objects behind), and an ``optimize`` block recording the problem,
        solver, and backend actually used.
        """
        if not isinstance(spec, OptimizeSpec):
            raise TypeError(
                f"repack() takes an OptimizeSpec "
                f"(repro_torch.core.OptimizeSpec.problem(...)), got "
                f"{type(spec).__name__}"
            )
        if not self.versions:
            # nothing to repack: solvers need ≥1 version and the stats below
            # take max() over the version set
            zero = {"storage_bytes": 0, "sum_recreation_s": 0.0,
                    "max_recreation_s": 0.0}
            return {"before": dict(zero), "after": dict(zero),
                    "gc_freed_bytes": 0}
        if use_access_frequencies:
            if not spec.supports_workload():
                raise ValueError(
                    f"use_access_frequencies=True needs a workload-aware "
                    f"spec (Problem 3 or 5 — LMG); got {spec.describe()!r}. "
                    f"The chosen solver would silently ignore the recorded "
                    f"access counts."
                )
            spec = spec.with_workload(self.access_weights())
        with _span("store.repack", spec=spec.describe()) as rsp:
            before = {
                "storage_bytes": self.storage_bytes(),
                "sum_recreation_s": sum(
                    self.recreation_cost(v) for v in self.versions
                ),
                "max_recreation_s": max(
                    self.recreation_cost(v) for v in self.versions
                ),
            }
            with _span("store.measure") as msp:
                g, cache = self.build_cost_graph()
                if msp:
                    msp.set(
                        versions=len(self.versions),
                        measured_edges=self.last_measured_edges,
                    )
            result = optimize(g, spec, device=self.device)
            with _span("store.apply_solution"):
                self._apply_solution(result.solution, cache)
            after = {
                "storage_bytes": self.storage_bytes(),
                "sum_recreation_s": sum(
                    self.recreation_cost(v) for v in self.versions
                ),
                "max_recreation_s": max(
                    self.recreation_cost(v) for v in self.versions
                ),
            }
            with _span("store.gc") as gsp:
                freed = self.gc()
                if gsp:
                    gsp.set(freed_bytes=freed)
            if rsp:
                rsp.set(
                    solver=result.solver,
                    backend=result.backend_used,
                    storage_bytes_before=before["storage_bytes"],
                    storage_bytes_after=after["storage_bytes"],
                )
        self.last_repack = {
            "describe": spec.describe(),
            "problem": result.problem,
            "solver": result.solver,
            "backend": result.backend_used,
            "objective": spec.objective.metric,
            "objective_value": float(result.objective_value),
            "constraints": [
                {"metric": c.metric, "bound": float(c.bound)}
                for c in spec.constraints
            ],
            "timestamp": time.time(),
        }
        self._save_meta()
        if use_access_frequencies:
            # warm the cache with the hottest versions under the *new*
            # storage graph so the first post-repack hit is already served
            # from memory
            hot = sorted(
                self.versions,
                key=lambda v: self.versions[v].access_count,
                reverse=True,
            )[: self.prefetch_hot_k]
            self.materializer.prefetch(hot)
        mon = self.tradeoff_monitor
        if mon is not None:
            mon.on_repack()
        return {
            "before": before,
            "after": after,
            "gc_freed_bytes": freed,
            "optimize": {
                "problem": result.problem,
                "solver": result.solver,
                "backend": result.backend_used,
                "objective_value": result.objective_value,
                "wall_time_s": round(result.wall_time_s, 6),
            },
        }

    def _apply_solution(self, sol: StorageSolution, cache: _PayloadProvider) -> None:
        # phase 1: encode every chosen edge against the *old* storage graph
        # (the provider checkouts must not observe a half-rewritten graph)
        encoded: Dict[int, Tuple[int, bytes, Optional[Dict]]] = {}
        for vid, parent in sol.parent.items():
            payload, stats = cache[(parent, vid)]
            encoded[vid] = (parent, payload, stats)
        # phase 2: rewrite objects and metadata atomically w.r.t. checkouts
        with self._lock:
            for vid, (parent, payload, stats) in encoded.items():
                meta = self.versions[vid]
                key, stored = self.objects.put(payload)
                if parent == 0:
                    meta.stored_base = None
                    meta.phi = self.cost_model.phi_full(stored, meta.raw_bytes)
                else:
                    meta.stored_base = parent
                    meta.phi = self.cost_model.phi_delta(
                        stored, len(payload), stats["changed_blocks"]
                    )
                meta.object_key = key
                meta.stored_bytes = stored
            # storage graph rewritten: new epoch, every chain fingerprint is
            # dead — repack keeps the wholesale purge (append-aware
            # invalidation only spares *commits* the purge)
            self._storage_fp = None
        self.materializer.cache.purge()

    def gc(self) -> int:
        """Drop objects not referenced by any version; returns bytes freed."""
        live = {m.object_key for m in self.versions.values()}
        freed = 0
        for key in list(self.objects.keys()):
            if key not in live:
                freed += self.objects.stored_size(key)
                self.objects.delete(key)
        return freed

    # ---------------------------------------------------------------- fsck
    def fsck(self, **kwargs: Any):
        """Integrity-check the storage graph; returns an analysis
        :class:`~repro_torch.analysis.findings.Report` (see
        :func:`repro_torch.analysis.fsck.fsck_store` for the checks and
        kwargs)."""
        from ..analysis.fsck import fsck_store  # local: analysis -> store

        return fsck_store(self, **kwargs)

    # ------------------------------------------------------------ metadata
    def save_refs(self) -> None:
        """Persist the ``refs`` dict (branches/tags/head) with the metadata."""
        self._save_meta()

    def _save_meta(self) -> None:
        with self._lock:
            self._save_meta_locked()

    def _save_meta_locked(self) -> None:
        blob = wire.packb(
            {
                "next_vid": self._next_vid,
                "versions": {
                    str(v): dataclasses.asdict(m) for v, m in self.versions.items()
                },
                "edge_cache": {
                    f"{a},{b}": ent for (a, b), ent in self._edge_cache.items()
                },
                "refs": {
                    "branches": {
                        name: vid for name, vid in self.refs["branches"].items()
                    },
                    "tags": {name: vid for name, vid in self.refs["tags"].items()},
                    "head": self.refs["head"],
                },
                "last_repack": self.last_repack,
            }
        )
        fd, tmp = tempfile.mkstemp(dir=str(self.root))
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(blob)
            os.replace(tmp, self._meta_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        self._unflushed_accesses = 0  # any metadata write persists counts

    def _load_meta(self) -> None:
        obj = wire.unpackb(self._meta_path.read_bytes())
        self._next_vid = obj["next_vid"]
        self.versions = {
            int(v): VersionMeta(**m) for v, m in obj["versions"].items()
        }
        self._edge_cache = {}
        for key, ent in obj.get("edge_cache", {}).items():
            a, b = key.split(",")
            self._edge_cache[(int(a), int(b))] = ent
        refs = obj.get("refs") or {}
        self.refs = {
            "branches": {
                str(k): int(v) for k, v in (refs.get("branches") or {}).items()
            },
            "tags": {str(k): int(v) for k, v in (refs.get("tags") or {}).items()},
            "head": str(refs.get("head", "main")),
        }
        self.last_repack = obj.get("last_repack") or None
        self._storage_fp = None  # metadata replaced: recompute lazily

    def log(self) -> List[VersionMeta]:
        return [self.versions[v] for v in sorted(self.versions)]
