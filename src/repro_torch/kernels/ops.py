"""The delta-path operations the store uses, over the block layout.

Converts tensors of any supported dtype and shape to and from the canonical
``(num_blocks, 8, 128)`` int32 block layout, and exposes the delta
operations:

* :func:`to_blocks` / :func:`from_blocks`: byte-preserving layout conversion
  (a ``uint8`` view, zero padding to 4 KiB, an ``int32`` view); the bytes
  equal the JAX package's for every dtype;
* :func:`xor_encode` / :func:`xor_apply`: the paper's XOR delta variant
  (CUDA kernel; self-inverse, so both are one XOR);
* :func:`block_hashes`: a per-block content hash, a dedup hint (CUDA
  kernel);
* :func:`sparse_encode`: changed-block mask (CUDA kernel), then compaction to
  ``(idx, blocks)`` in plain PyTorch (the JAX package leaves it to XLA);
* :func:`sparse_apply`, :func:`chain_apply`, :func:`chain_apply_batched`:
  the one-hop scatter and the fused chain (CUDA kernels).

Each operation runs where its tensors lie: CPU tensors take the plain
versions, CUDA tensors the kernels.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional, Tuple

import torch

from .block_diff import block_hash, changed_block_mask, hash_coefficients
from .chain_apply import chain_delta_apply, chain_delta_apply_batched
from .ref import BLOCK_BYTES, BLOCK_SHAPE
from .sparse_apply import sparse_delta_apply
from .xor_delta import xor_delta


@dataclasses.dataclass(frozen=True)
class BlockMeta:
    """Everything needed to reverse :func:`to_blocks`."""

    dtype: torch.dtype
    shape: Tuple[int, ...]
    nbytes: int
    num_blocks: int


def to_blocks(x: torch.Tensor) -> Tuple[torch.Tensor, BlockMeta]:
    """View a tensor's bytes as (num_blocks, 8, 128) int32, zero-padded.

    Shares ``x``'s memory when its size is a multiple of 4 KiB and it is
    contiguous and 16-byte aligned; copies otherwise."""
    nbytes = x.numel() * x.element_size()
    flat_u8 = x.contiguous().reshape(-1).view(torch.uint8)
    pad = (-nbytes) % BLOCK_BYTES
    if pad or flat_u8.data_ptr() % 16:
        buf = flat_u8.new_zeros(nbytes + pad)
        buf[:nbytes] = flat_u8
        flat_u8 = buf
    num_blocks = (nbytes + pad) // BLOCK_BYTES
    blocks = flat_u8.view(torch.int32).reshape((num_blocks,) + BLOCK_SHAPE)
    return blocks, BlockMeta(x.dtype, tuple(x.shape), nbytes, num_blocks)


def from_blocks(blocks: torch.Tensor, meta: BlockMeta) -> torch.Tensor:
    """Inverse of :func:`to_blocks` (a view of ``blocks``' memory)."""
    flat_u8 = blocks.reshape(-1).view(torch.uint8)[: meta.nbytes]
    return flat_u8.view(meta.dtype).reshape(meta.shape)


# ------------------------------------------------------------------ XOR delta
def xor_encode(base_blocks: torch.Tensor, new_blocks: torch.Tensor) -> torch.Tensor:
    return xor_delta(base_blocks, new_blocks)


def xor_apply(base_blocks: torch.Tensor, delta_blocks: torch.Tensor) -> torch.Tensor:
    return xor_delta(base_blocks, delta_blocks)


# ---------------------------------------------------------------- block hash
# one copy of the multiplier table per device, made on first use under a
# lock (the service's reader threads may hash concurrently), so no call pays
# a host-to-device copy of it
_COEF: Dict[torch.device, torch.Tensor] = {}
_coef_lock = threading.Lock()


def _coefficients(device: torch.device) -> torch.Tensor:
    with _coef_lock:
        coef = _COEF.get(device)
        if coef is None:
            coef = _COEF[device] = torch.from_numpy(hash_coefficients()).to(device)
        return coef


def block_hashes(blocks: torch.Tensor) -> torch.Tensor:
    """(num_blocks,) int32 content hash of each 4 KiB block."""
    return block_hash(blocks, _coefficients(blocks.device))[:, 0]


# --------------------------------------------------------- block-sparse delta
def _round_capacity(k: int) -> int:
    cap = 8
    while cap < k:
        cap *= 2
    return cap


def _compact(mask: torch.Tensor, new_blocks: torch.Tensor, capacity: int):
    """Pack changed block rows into (idx[capacity], blocks[capacity]).

    Padding slots are *collision-free by construction*: they point at the
    first unchanged row (where new == base, so a redundant write is a no-op),
    or, when every row changed, at row 0 carrying row 0's new content (a
    redundant write of correct data).  Rows past ``capacity`` are dropped,
    and the returned count is the *true* number of changed rows: when it
    exceeds ``capacity`` the packed delta is incomplete and callers must
    check (``sparse_encode`` raises).
    """
    m = mask[:, 0].to(torch.int32)
    nb = m.shape[0]
    order = torch.cumsum(m, 0, dtype=torch.int32) - 1  # slot per changed row
    keep = (m == 1) & (order < capacity)  # JAX's mode="drop" past capacity
    pad_row = torch.argmin(m).to(torch.int32)  # first unchanged row (0 if none)
    idx = torch.full((capacity,), -1, dtype=torch.int32, device=m.device)
    rows = torch.arange(nb, dtype=torch.int32, device=m.device)
    idx[order[keep]] = rows[keep]
    idx = torch.where(idx >= 0, idx, pad_row)
    gathered = new_blocks[idx]
    return idx, gathered, m.sum(dtype=torch.int32)


def sparse_encode(
    base_blocks: torch.Tensor,
    new_blocks: torch.Tensor,
    *,
    capacity: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Return (idx, packed_blocks, n_changed) for the block-sparse delta.

    With ``capacity=None`` the exact changed count is read back (one
    device-to-host sync, which both sizes the capacity and is the count) and
    capacity grows to fit.  An explicit ``capacity`` must cover the changed
    count: an undersized one would silently drop changed blocks in
    ``_compact``, so this raises instead.
    """
    mask = changed_block_mask(base_blocks, new_blocks)
    if capacity is None:
        n = int(mask.sum())
        capacity = _round_capacity(max(1, n))
        idx, blocks, _ = _compact(mask, new_blocks, capacity)
        return idx, blocks, n
    idx, blocks, n_dev = _compact(mask, new_blocks, capacity)
    n = int(n_dev)
    if n > capacity:
        raise ValueError(
            f"sparse_encode capacity overflow: {n} changed blocks exceed "
            f"capacity={capacity}; pass capacity>={_round_capacity(n)} (or "
            f"capacity=None to size automatically)"
        )
    return idx, blocks, n


def sparse_apply(
    base_blocks: torch.Tensor, packed_blocks: torch.Tensor, idx: torch.Tensor
) -> torch.Tensor:
    return sparse_delta_apply(base_blocks, packed_blocks, idx)


def chain_apply(
    base_blocks: torch.Tensor, packed_blocks: torch.Tensor, idx: torch.Tensor
) -> torch.Tensor:
    """Fused K-step chain application (see :mod:`.chain_apply`): ``idx`` /
    ``packed_blocks`` stack K packed sparse deltas in chain order, flat or
    ``(K, capacity)``-shaped, padding ``idx < 0``."""
    return chain_delta_apply(base_blocks, packed_blocks, idx)


def chain_apply_batched(
    base_stack: torch.Tensor, packed_blocks: torch.Tensor, idx: torch.Tensor
) -> torch.Tensor:
    """Fused chain application for L same-sized leaves in one launch."""
    return chain_delta_apply_batched(base_stack, packed_blocks, idx)
