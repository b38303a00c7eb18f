"""Plain PyTorch versions of the delta-path kernels.

Everything operates on the canonical *block layout*: a tensor's backing bytes
are viewed as ``(num_blocks, 8, 128)`` int32, one 4 KiB storage block per
row.  The shape is kept from the JAX package (where a block is one TPU VMEM
tile) so that wire bytes match; on the GPU a block is simply 1024 words.

These functions are what the kernel wrappers run for CPU tensors, and what
``chip_smoke.py`` holds each CUDA kernel against on the card.  None of them
writes into its arguments.
"""

from __future__ import annotations

import torch

BLOCK_SHAPE = (8, 128)
BLOCK_ELEMS = BLOCK_SHAPE[0] * BLOCK_SHAPE[1]
BLOCK_BYTES = BLOCK_ELEMS * 4


def changed_block_mask_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(num_blocks, 1) int32 mask: 1 where a block differs anywhere."""
    return (a != b).flatten(1).any(dim=1).to(torch.int32)[:, None]


def sparse_delta_apply_ref(
    base: torch.Tensor, blocks: torch.Tensor, idx: torch.Tensor
) -> torch.Tensor:
    """Scatter packed delta blocks into a copy of ``base``.

    base   : (num_blocks, 8, 128) int32
    blocks : (k, 8, 128) int32 packed changed blocks
    idx    : (k,) int32 destination block rows; ``idx < 0`` and
             ``idx >= num_blocks`` are dropped (padding)

    Where two slots name one row the later slot wins, as the JAX reference's
    in-order scatter does; the result does not depend on the backend's
    handling of duplicate indices.
    """
    nb = base.shape[0]
    out = base.clone()
    valid = (idx >= 0) & (idx < nb)
    rows = idx[valid].long()
    if rows.numel() == 0:
        return out
    src = blocks[valid]
    slot = torch.arange(rows.numel(), device=rows.device)
    winner = torch.full((nb,), -1, dtype=torch.long, device=rows.device)
    winner.scatter_reduce_(0, rows, slot, reduce="amax")
    keep = winner[rows] == slot
    out[rows[keep]] = src[keep]
    return out


def chain_delta_apply_ref(
    base: torch.Tensor, blocks: torch.Tensor, idx: torch.Tensor
) -> torch.Tensor:
    """Apply a whole chain of packed deltas in chain order.

    base   : (num_blocks, 8, 128) int32
    blocks : (K, capacity, 8, 128) int32 (or flat (S, 8, 128))
    idx    : (K, capacity) int32 (or flat (S,)); negative = padding

    The sparse deltas carry new block *content*, so composition is
    last-writer-wins per row, and the flat slot order is the chain order:
    one last-writer-wins scatter of the flattened stack equals applying the
    K steps one after another (the JAX reference's stepwise fold).
    """
    return sparse_delta_apply_ref(
        base, blocks.reshape((-1,) + BLOCK_SHAPE), idx.reshape(-1)
    )
