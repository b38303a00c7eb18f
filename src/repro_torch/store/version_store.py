"""VersionStore — the paper's system: commit and checkout over a storage graph.

Tracks a *version graph* (derivation DAG from commits and branches) and a
*storage graph* (what is physically stored: full objects and deltas).  The
on-disk store is the JAX package's: the same ``meta.msgpack`` and the same
object keys and bytes, so a store committed by either package opens and
checks out bit-identically in the other.  Metadata this slice does not use
(``edge_cache``, ``last_repack``) is carried through untouched.

Commit path: a new version is stored as a delta against its first parent's
payload when that is smaller than storing it whole; the changed-block masks
run on ``device``.

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

Storage-graph re-optimization (``build_cost_graph``, ``repack``) and
``fsck`` need the paper's solvers and the analysis package, which the port
does not hold yet; they raise ``NotImplementedError``.
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

_NOT_PORTED = (
    "{} is not ported yet: it needs {}, which a later slice of the port "
    "brings; the JAX package's repro.store opens the same root meanwhile"
)
_SOLVER_SLICE = (
    "the paper's storage-graph solvers (repro.core) and the device solver "
    "backend over the segment_ops kernels (the next slice)"
)
_FSCK_SLICE = "the analysis package (the slice with the service tier)"


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


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The device the store computes on; a CUDA device must exist."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the store runs its kernels on a CUDA device and none is "
            "available; pass device='cpu' to run the plain PyTorch versions"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device}")
    return device


class VersionStore:
    def __init__(
        self,
        root: str | Path,
        *,
        device: Union[str, torch.device] = "cuda",
        cost_model: Optional[RecreationCostModel] = None,
        cache_budget_bytes: int = 256 << 20,
        access_flush_every: int = 64,
        fuse_chains: bool = True,
        cache_invalidation: str = "chain",
    ) -> None:
        self.device = resolve_device(device)
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.objects = ObjectStore(self.root)
        self.cost_model = cost_model or RecreationCostModel()
        self.versions: Dict[int, VersionMeta] = {}
        self._next_vid = 1
        # guards hot state shared with reader threads: access counts, vid
        # allocation, and metadata writes
        self._lock = threading.RLock()
        # measured Δ entries of the JAX package's repack, persisted in the
        # metadata; carried through untouched
        self._edge_cache: Dict[Tuple[int, int], Dict[str, Any]] = {}
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
        self._unflushed_accesses = 0
        self._storage_fp: Optional[str] = None
        # the JAX package's record of its last repack; carried through
        self.last_repack: Optional[Dict[str, Any]] = None
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

        Bit-identical to ``[checkout(v) for v in vids]``.  Returned tensors
        are shared with the cache; copy before writing into one.
        """
        out = self.materializer.checkout_many(vids)
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
        """Internal checkout: no access-count bump, same cache/planner path."""
        return self.materializer.checkout(vid)

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

    # ------------------------------------------------- not in this slice yet
    def build_cost_graph(self, **kwargs: Any):
        raise NotImplementedError(
            _NOT_PORTED.format("VersionStore.build_cost_graph", _SOLVER_SLICE)
        )

    def repack(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        raise NotImplementedError(
            _NOT_PORTED.format("VersionStore.repack", _SOLVER_SLICE)
        )

    def fsck(self, **kwargs: Any):
        raise NotImplementedError(
            _NOT_PORTED.format("VersionStore.fsck", _FSCK_SLICE)
        )

    def gc(self) -> int:
        """Drop objects not referenced by any version; returns bytes freed."""
        live = {m.object_key for m in self.versions.values()}
        freed = 0
        for key in list(self.objects.keys()):
            if key not in live:
                freed += self.objects.stored_size(key)
                self.objects.delete(key)
        return freed

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
