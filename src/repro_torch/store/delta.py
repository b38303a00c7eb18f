"""Tree-level delta codec over the CUDA block kernels.

Encodes a *version payload* (nested dicts, lists and tuples of tensors or
numpy arrays) either fully or as a delta against a base payload:

* leaves present in both with identical shape/dtype → **block-sparse delta**
  (changed-block indices + packed 4 KiB blocks, from the mask/compact path);
* new / reshaped leaves → stored whole;
* deleted leaves → tombstones.

The wire format is msgpack (:mod:`.wire`), byte-identical to the JAX
package's, so stores written by either package open in the other; the object
store compresses.  The codec also returns the *measured* Δ (serialized bytes)
and a Φ estimate from :class:`RecreationCostModel`.

A FlatTree maps '/'-joined leaf paths to CPU tensors.  Kernels run on
``device`` (the card unless the caller asks for ``"cpu"``): leaves are
uploaded, blocked, diffed or patched there, and results come back to the
host together.

Blocked-layout + chain-fusion contract
--------------------------------------
A leaf's bytes are viewed as ``(num_blocks, 8, 128)`` int32 blocks
(:func:`repro_torch.kernels.ops.to_blocks`).  A sparse wire entry stores the
*new content* of each changed block plus its row index, with ``_compact``'s
padding trimmed before serialization; padding is reintroduced at decode
time as ``idx = -1`` slots.  Because entries carry content (not XOR), a
K-step chain composes by **last-writer-wins per block row**, which
:func:`apply_delta_chains` exploits: the chain's packed deltas are flattened
*in chain order* into one padded stack and applied in one fused launch,
bit-identical to K sequential :func:`apply_delta` calls.  Per-leaf slot
counts are bucketed to powers of two (min 8) and leaves with equal
``(num_blocks, slot_bucket)`` are batched into one launch.  A leaf's chain
segment restarts at any mid-chain full rewrite (shape/dtype change) and ends
at a tombstone; only the segments between those events reach the kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, FrozenSet, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..kernels import ops
from ..kernels.ref import BLOCK_BYTES, BLOCK_SHAPE
from ..obs.tracer import start as _trace_start
from . import wire
from .convert import tensor_from_numpy, torch_dtype, wire_dtype

FlatTree = Dict[str, torch.Tensor]
# device-resident companion of a FlatTree: blocked form + layout meta per
# leaf (only leaves that went through the block pipeline appear)
BlockedLeaf = Tuple[torch.Tensor, "ops.BlockMeta"]
BlockedTree = Dict[str, BlockedLeaf]
Device = Union[str, torch.device]

_SLOT_BUCKET_MIN = 8


def flatten_payload(tree: Any) -> FlatTree:
    """Flatten a payload to {path: CPU tensor} with '/'-joined keys.

    Dict keys are visited in sorted order and ``None`` holds no leaf, as
    ``jax.tree_util`` does: the key order reaches the wire bytes and hence
    the object keys, which must equal the JAX package's."""
    flat: FlatTree = {}
    _flatten(tree, (), flat)
    return flat


def _flatten(node: Any, path: Tuple[str, ...], out: FlatTree) -> None:
    if isinstance(node, dict):
        for k in sorted(node):
            _flatten(node[k], path + (str(k),), out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _flatten(v, path + (str(i),), out)
    elif isinstance(node, torch.Tensor):
        wire_dtype(node.dtype)  # refuse what the wire cannot name
        out["/".join(path)] = node.detach().cpu()
    elif isinstance(node, (np.ndarray, np.generic)):
        out["/".join(path)] = tensor_from_numpy(node)
    elif node is not None:
        raise TypeError(
            f"payload leaf {'/'.join(path)!r} is a {type(node).__name__}; "
            f"leaves must be tensors or numpy arrays"
        )


# --------------------------------------------------------------------- wire
def _tensor_bytes(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _arr_to_wire(t: torch.Tensor) -> Dict:
    return {
        "dtype": wire_dtype(t.dtype),
        "shape": list(t.shape),
        "data": _tensor_bytes(t),
    }


def _arr_from_wire(d: Dict) -> torch.Tensor:
    dtype = torch_dtype(d["dtype"])
    raw = torch.from_numpy(np.frombuffer(d["data"], np.uint8).copy())
    return raw.view(dtype).reshape(d["shape"])


def encode_full(flat: FlatTree) -> bytes:
    # sorted-key serialization: the content fingerprint (sha256 of these
    # bytes) must not depend on dict insertion order, which differs between
    # the commit path (flatten order) and checkout results
    return wire.packb(
        {"kind": "full",
         "leaves": {k: _arr_to_wire(flat[k]) for k in sorted(flat)}}
    )


def decode_full(payload: bytes) -> FlatTree:
    obj = wire.unpackb(payload)
    if obj["kind"] != "full":
        raise ValueError(f"expected a full payload, got {obj['kind']!r}")
    return {k: _arr_from_wire(v) for k, v in obj["leaves"].items()}


def encode_delta(
    base: FlatTree, new: FlatTree, *, device: Device = "cuda"
) -> Tuple[bytes, Dict]:
    """Delta payload turning `base` into `new`, plus stats for Φ modelling.
    The changed-block masks run on ``device``."""
    device = torch.device(device)
    sparse, full, stats = {}, {}, {"changed_blocks": 0, "total_blocks": 0, "full_leaves": 0}
    tombstones = [k for k in base if k not in new]
    for key, arr in new.items():
        b = base.get(key)
        if b is None or b.shape != arr.shape or b.dtype != arr.dtype:
            full[key] = _arr_to_wire(arr)
            stats["full_leaves"] += 1
            continue
        bb, meta = ops.to_blocks(b.to(device))
        nb, _ = ops.to_blocks(arr.to(device))
        idx, blocks, n = ops.sparse_encode(bb, nb)
        stats["changed_blocks"] += n
        stats["total_blocks"] += int(bb.shape[0])
        if n == 0:
            sparse[key] = {"idx": b"", "blocks": b"", "n": 0}
            continue
        # trim padding before serialization (padding is a device-side artifact)
        sparse[key] = {
            "idx": _tensor_bytes(idx[:n].cpu()),
            "blocks": _tensor_bytes(blocks[:n].cpu()),
            "n": int(n),
        }
    payload = wire.packb(
        {"kind": "delta", "sparse": sparse, "full": full, "tombstones": tombstones}
    )
    return payload, stats


# ------------------------------------------------------------- wire decode
@dataclasses.dataclass(frozen=True)
class SparseLeafDelta:
    """One leaf's packed sparse delta, trimmed (no padding slots)."""

    idx: torch.Tensor     # (n,) int32 changed block rows, on the CPU
    blocks: torch.Tensor  # (n, 8, 128) int32 packed new block content
    n: int


@dataclasses.dataclass(frozen=True)
class DeltaWire:
    """A decoded delta payload: msgpack unpacked once, arrays ready for
    upload (the decode path of the fused chain pipeline)."""

    sparse: Dict[str, SparseLeafDelta]
    full: Dict[str, Dict]          # raw wire dicts, decoded lazily
    tombstones: FrozenSet[str]


def _int32_from(raw: bytes) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(raw, np.int32).copy())


def decode_delta_wire(payload: bytes) -> DeltaWire:
    """Unpack a delta payload into :class:`DeltaWire` (no block application)."""
    obj = wire.unpackb(payload)
    if obj["kind"] != "delta":
        raise ValueError(f"expected a delta payload, got {obj['kind']!r}")
    sparse: Dict[str, SparseLeafDelta] = {}
    for key, d in obj["sparse"].items():
        n = int(d["n"])
        if n == 0:
            sparse[key] = SparseLeafDelta(
                torch.empty((0,), dtype=torch.int32),
                torch.empty((0,) + BLOCK_SHAPE, dtype=torch.int32),
                0,
            )
            continue
        idx = _int32_from(d["idx"])
        blocks = _int32_from(d["blocks"]).reshape((-1,) + BLOCK_SHAPE)
        sparse[key] = SparseLeafDelta(idx, blocks, n)
    return DeltaWire(sparse, obj["full"], frozenset(obj["tombstones"]))


def _to_host(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """Bring device results to the host together: every copy is queued
    before a single synchronisation, not one blocking copy per leaf.  CPU
    results are already there."""
    if not tensors or not tensors[0].is_cuda:
        return tensors
    host = [
        torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors
    ]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    torch.cuda.current_stream(tensors[0].device).synchronize()
    return host


def apply_delta(
    base: FlatTree,
    payload: Union[bytes, DeltaWire],
    *,
    device: Device = "cuda",
) -> FlatTree:
    """Stepwise (one-hop) delta application: the reference recreation path.

    Unchanged leaves pass through by reference; each changed leaf pays one
    upload, ``to_blocks``/``sparse_apply``/``from_blocks`` on ``device``, and
    the results come back together.  Chains should use
    :func:`apply_delta_chain`, which is bit-identical and fused.
    """
    device = torch.device(device)
    dw = decode_delta_wire(payload) if isinstance(payload, bytes) else payload
    out: FlatTree = {}
    pending: Dict[str, torch.Tensor] = {}
    for key, arr in base.items():
        if key in dw.tombstones:
            continue
        d = dw.sparse.get(key)
        if d is None or d.n == 0:
            out[key] = arr
            continue
        bb, meta = ops.to_blocks(arr.to(device))
        rec = ops.sparse_apply(bb, d.blocks.to(device), d.idx.to(device))
        pending[key] = ops.from_blocks(rec, meta)
    if pending:
        # patched leaves follow the untouched ones in sorted key order, as
        # the JAX package's device_get of its dict returns them: checkout key
        # order reaches the tombstone list of the next delta's wire bytes
        keys = sorted(pending)
        out.update(zip(keys, _to_host([pending[k] for k in keys])))
    for key, wire_dict in dw.full.items():
        out[key] = _arr_from_wire(wire_dict)
    return out


# ----------------------------------------------------- fused chain pipeline
def _slot_bucket(n: int) -> int:
    """Pad per-leaf chain slot counts to powers of two (min 8), so that
    leaves of one block count share a launch across chains of different
    depth and sparsity."""
    cap = _SLOT_BUCKET_MIN
    while cap < n:
        cap *= 2
    return cap


@dataclasses.dataclass
class _LeafProgram:
    """Per-leaf chain plan: an origin value plus the sparse segments applied
    after it (segments restart at mid-chain full rewrites)."""

    req: int                       # request index in the batch
    key: str
    origin_step: Optional[int]     # None → base tree; else wires[i].full
    segments: List[SparseLeafDelta]


def _resolve_leaf_programs(
    base: FlatTree, wires: Sequence[DeltaWire]
) -> Dict[str, Tuple[Optional[int], List[SparseLeafDelta]]]:
    """Fold a chain's per-step leaf events into one program per final leaf.

    Walks steps in order: tombstones kill a leaf, full rewrites restart its
    chain segment (later sparse deltas apply on the rewritten value), sparse
    deltas append to the current segment.  The result maps every leaf of the
    chain's *final* tree to ``(origin_step, segments)``.
    """
    state: Dict[str, Tuple[Optional[int], List[SparseLeafDelta]]] = {
        k: (None, []) for k in base
    }
    for i, w in enumerate(wires):
        for k in w.tombstones:
            state.pop(k, None)
        for k, d in w.sparse.items():
            if d.n == 0:
                continue
            st = state.get(k)
            if st is None:
                raise ValueError(
                    f"corrupt chain: step {i} carries a sparse delta for "
                    f"leaf {k!r} absent from the running tree"
                )
            st[1].append(d)
        for k in w.full:
            state[k] = (i, [])
    return state


def apply_delta_chains(
    requests: Sequence[
        Tuple[FlatTree, Sequence[Union[bytes, DeltaWire]], Optional[BlockedTree]]
    ],
    *,
    stats: Optional[Dict[str, int]] = None,
    device: Device = "cuda",
) -> List[Tuple[FlatTree, BlockedTree]]:
    """Apply one delta chain per request, fused and batched across requests.

    Each request is ``(base_tree, chain_payloads, base_blocked)``;
    ``base_blocked`` optionally carries the base's blocked leaves on
    ``device`` so repeatedly-edited leaves skip the upload and
    ``to_blocks``.  Leaves are grouped by ``(num_blocks, slot_bucket)``
    across *all* requests and each group runs as one
    :func:`repro_torch.kernels.ops.chain_apply_batched` launch.

    Returns ``[(tree, blocked)]`` per request, bit-identical to folding
    :func:`apply_delta` over each chain.  ``stats`` (optional) is bumped
    with ``launches`` / ``fused_slots`` for observability.
    """
    device = torch.device(device)
    # explicit-lifetime span (no context entry): nothing below opens child
    # spans, and the single end() keeps the launch loop unindented
    _sp = _trace_start("delta.apply_chains", requests=len(requests))
    # the caller's stats dict accumulates across calls; snapshot so the span
    # attributes only this call's launches
    _launch0 = (stats or {}).get("launches", 0)
    _slots0 = (stats or {}).get("fused_slots", 0)
    wire_chains: List[List[DeltaWire]] = []
    outs: List[FlatTree] = []
    blocked_outs: List[BlockedTree] = []
    units: List[_LeafProgram] = []
    for ri, (base, payloads, _) in enumerate(requests):
        wires = [
            decode_delta_wire(p) if isinstance(p, bytes) else p
            for p in payloads
        ]
        wire_chains.append(wires)
        out: FlatTree = {}
        outs.append(out)
        blocked_outs.append({})
        for key, (origin_step, segs) in _resolve_leaf_programs(
            base, wires
        ).items():
            if not segs:
                # untouched leaf (reference passthrough) or plain full decode
                out[key] = (
                    base[key]
                    if origin_step is None
                    else _arr_from_wire(wires[origin_step].full[key])
                )
                continue
            units.append(_LeafProgram(ri, key, origin_step, segs))

    # shape-bucketed grouping: one fused launch per (num_blocks, slot_bucket)
    groups: Dict[Tuple[int, int], List[_LeafProgram]] = {}
    origins: Dict[Tuple[int, str], Tuple[torch.Tensor, "ops.BlockMeta"]] = {}
    for u in units:
        base, _, base_blocked = requests[u.req]
        if u.origin_step is None:
            pre = (base_blocked or {}).get(u.key)
            if pre is not None:
                origin_blocks, meta = pre
            else:
                origin_blocks, meta = ops.to_blocks(base[u.key].to(device))
        else:
            arr = _arr_from_wire(wire_chains[u.req][u.origin_step].full[u.key])
            origin_blocks, meta = ops.to_blocks(arr.to(device))
        origins[(u.req, u.key)] = (origin_blocks, meta)
        total = sum(s.n for s in u.segments)
        groups.setdefault((meta.num_blocks, _slot_bucket(total)), []).append(u)

    # launch every group first, keeping results on the device; the host
    # copies happen once at the end, together
    host_fetch: List[Tuple[int, str, torch.Tensor]] = []
    for (nb, cap), members in groups.items():
        idx_pad = torch.full((len(members), cap), -1, dtype=torch.int32)
        blk_pad = torch.zeros((len(members), cap) + BLOCK_SHAPE, dtype=torch.int32)
        for li, u in enumerate(members):
            at = 0
            for seg in u.segments:  # chain order: later slots win
                idx_pad[li, at : at + seg.n] = seg.idx
                blk_pad[li, at : at + seg.n] = seg.blocks
                at += seg.n
        idx_dev, blk_dev = idx_pad.to(device), blk_pad.to(device)
        if len(members) == 1:
            u = members[0]
            ob, meta = origins[(u.req, u.key)]
            recs = [ops.chain_apply(ob, blk_dev[0], idx_dev[0])]
        else:
            stack = torch.stack([origins[(u.req, u.key)][0] for u in members])
            recs = ops.chain_apply_batched(stack, blk_dev, idx_dev)
        if stats is not None:
            stats["launches"] = stats.get("launches", 0) + 1
            stats["fused_slots"] = (
                stats.get("fused_slots", 0) + len(members) * cap
            )
        for u, rec in zip(members, recs):
            meta = origins[(u.req, u.key)][1]
            blocked_outs[u.req][u.key] = (rec, meta)
            host_fetch.append((u.req, u.key, ops.from_blocks(rec, meta)))
    if host_fetch:
        fetched = _to_host([dev for _, _, dev in host_fetch])
        for (req, key, _), arr in zip(host_fetch, fetched):
            outs[req][key] = arr
    if _sp:
        if stats is not None:
            _sp.set(
                launches=stats.get("launches", 0) - _launch0,
                fused_slots=stats.get("fused_slots", 0) - _slots0,
            )
        else:
            _sp.set(launches=len(groups))
        _sp.set(leaves=len(units))
    _sp.end()
    return list(zip(outs, blocked_outs))


def apply_delta_chain(
    base: FlatTree,
    payloads: Sequence[Union[bytes, DeltaWire]],
    *,
    base_blocked: Optional[BlockedTree] = None,
    device: Device = "cuda",
) -> FlatTree:
    """Fused K-step chain application (single chain): bit-identical to
    ``functools.reduce(apply_delta, payloads, base)`` in one launch per
    leaf-shape group."""
    return apply_delta_chains(
        [(base, payloads, base_blocked)], device=device
    )[0][0]


# ----------------------------------------------------------------- Φ model
@dataclasses.dataclass(frozen=True)
class RecreationCostModel:
    """Maps a stored object to an estimated recreation cost in seconds.

    Distinct from Δ (bytes at rest): reading is charged at storage bandwidth,
    decompression and block application at their own rates — so compact,
    compute-heavy deltas genuinely trade Φ against Δ (paper Scenario 3).
    """

    read_gbps: float = 2.0          # storage/network read bandwidth
    decompress_gbps: float = 1.0    # zstd decode rate
    apply_gbps: float = 8.0         # on-device block scatter rate
    seek_s: float = 0.005           # per-object latency

    def phi(self, stored_bytes: int, raw_bytes: int, applied_bytes: int) -> float:
        return (
            self.seek_s
            + stored_bytes / (self.read_gbps * 1e9)
            + raw_bytes / (self.decompress_gbps * 1e9)
            + applied_bytes / (self.apply_gbps * 1e9)
        )

    def phi_full(self, stored_bytes: int, raw_bytes: int) -> float:
        return self.phi(stored_bytes, raw_bytes, 0)

    def phi_delta(self, stored_bytes: int, raw_bytes: int, changed_blocks: int) -> float:
        return self.phi(stored_bytes, raw_bytes, changed_blocks * BLOCK_BYTES)
