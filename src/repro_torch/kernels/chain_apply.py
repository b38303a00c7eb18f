"""Fused delta-*chain* application: a whole-chain checkout in one pass.

Replaces ``_chain_call`` (the XLA fold ``_fold_dest`` plus the Pallas
``_chain_kernel``) of ``src/repro/kernels/chain_apply.py``, reached there from
``chain_delta_apply`` and ``chain_delta_apply_batched``.  The CUDA kernels are
``delta_chain_winner`` and ``delta_chain_copy`` in ``csrc/delta_kernels.cu``,
where their bound and design are noted.

The chain's sparse deltas carry new block *content*, so composition is
last-writer-wins per row, and flattening the ``(K, capacity)`` stack in chain
order makes the last writer of a row the largest flat slot id that names it.
The first launch takes that maximum per row with ``atomicMax`` into a winner
array; the second copies each slot that won its row into ``base.clone()``.
Padding (``idx < 0``) and out-of-range rows are skipped.

``chain_delta_apply_batched`` runs L same-sized leaves in one pair of launches
by offsetting each leaf's rows by ``leaf * num_blocks`` into one row space.
"""

from __future__ import annotations

import torch

from . import check_blocks, check_launchable, count_launch, is_cpu, launch
from .ref import BLOCK_SHAPE, chain_delta_apply_ref

_INT32_MAX = 2**31 - 1


def _chain_call(
    base: torch.Tensor, blocks: torch.Tensor, idx: torch.Tensor
) -> torch.Tensor:
    """base (R, 8, 128), blocks (S, 8, 128), idx (S,): CPU → plain version;
    CUDA → winner + copy launches.  Returns a new tensor."""
    if is_cpu(base, blocks, idx):
        return chain_delta_apply_ref(base, blocks, idx)
    nrows, s = base.shape[0], idx.shape[0]
    if nrows > _INT32_MAX or s > _INT32_MAX:
        raise ValueError(f"chain too large for int32 rows/slots: {nrows}, {s}")
    check_launchable(base=base, blocks=blocks, idx=idx)
    out = base.clone()
    winner = torch.full((nrows,), -1, dtype=torch.int32, device=base.device)
    launch(
        "delta_chain_winner", base.device,
        idx.data_ptr(), winner.data_ptr(), s, nrows,
    )
    launch(
        "delta_chain_copy", base.device,
        blocks.data_ptr(), idx.data_ptr(), winner.data_ptr(), out.data_ptr(),
        s, nrows,
    )
    return out


def chain_delta_apply(
    base: torch.Tensor, blocks: torch.Tensor, idx: torch.Tensor
) -> torch.Tensor:
    """Apply a whole K-step sparse-delta chain to one blocked leaf.

    base   : (num_blocks, 8, 128) int32
    blocks : (K, capacity, 8, 128) or flat (S, 8, 128) int32 packed content
    idx    : (K, capacity) or flat (S,) int32 block rows, -1 = padding;
             flat order IS chain order (step 0 first): later slots win.
    """
    check_blocks("base", base)
    check_blocks("blocks", blocks)
    if base.dim() != 3:
        raise ValueError("base must be (num_blocks, 8, 128)")
    if idx.dtype != torch.int32:
        raise ValueError(f"idx must be int32, got {idx.dtype}")
    idx = idx.reshape(-1)
    blocks = blocks.reshape((-1,) + BLOCK_SHAPE)
    if idx.shape[0] != blocks.shape[0]:
        raise ValueError(
            f"{idx.shape[0]} indices for {blocks.shape[0]} blocks"
        )
    if idx.shape[0] == 0:
        return base.clone()
    out = _chain_call(base, blocks, idx)
    if out.is_cuda:
        count_launch(chain_delta_apply)
    return out


def chain_delta_apply_batched(
    bases: torch.Tensor, blocks: torch.Tensor, idx: torch.Tensor
) -> torch.Tensor:
    """Apply L independent delta chains to L same-sized leaves in one launch.

    bases  : (L, num_blocks, 8, 128) int32
    blocks : (L, S, 8, 128) int32, each leaf's chain flattened and padded to S
    idx    : (L, S) int32 block rows within the leaf, -1 = padding
    """
    check_blocks("bases", bases)
    check_blocks("blocks", blocks)
    if bases.dim() != 4 or blocks.dim() != 4 or idx.dim() != 2:
        raise ValueError("expected bases (L, nb, 8, 128), blocks (L, S, 8, 128), idx (L, S)")
    if idx.dtype != torch.int32:
        raise ValueError(f"idx must be int32, got {idx.dtype}")
    l, nb = bases.shape[0], bases.shape[1]
    s = idx.shape[1]
    if tuple(blocks.shape[:2]) != (l, s) or idx.shape[0] != l:
        raise ValueError(
            f"blocks {tuple(blocks.shape[:2])} / idx {tuple(idx.shape)} do "
            f"not match {l} leaves"
        )
    if s == 0 or l == 0:
        return bases.clone()
    # rows are disjoint across leaves, so each row keeps its own chain order;
    # a row outside its leaf is padding, never another leaf's row
    offs = torch.arange(l, dtype=torch.int32, device=idx.device)[:, None] * nb
    valid = (idx >= 0) & (idx < nb)
    idx_flat = torch.where(valid, idx + offs, torch.full_like(idx, -1))
    out = _chain_call(
        bases.reshape((l * nb,) + BLOCK_SHAPE),
        blocks.reshape((l * s,) + BLOCK_SHAPE),
        idx_flat.reshape(-1),
    )
    if out.is_cuda:
        count_launch(chain_delta_apply_batched)
    return out.reshape(bases.shape)


chain_delta_apply.launches = 0
chain_delta_apply_batched.launches = 0
