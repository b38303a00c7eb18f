"""Block-sparse delta apply: one hop of a checkout.

Replaces the Pallas kernel ``sparse_delta_apply`` (``_apply_kernel``) of
``src/repro/kernels/sparse_apply.py``; the CUDA kernel is
``delta_sparse_scatter`` in ``csrc/delta_kernels.cu``, where its bound and
design are noted.  The Pallas kernel aliased the base into its output; here
the output is a fresh ``base.clone()`` and the scatter writes only into it,
so a caller's base (a cached tree, a blocked memo) never changes.
"""

from __future__ import annotations

import torch

from . import check_blocks, check_launchable, count_launch, is_cpu, launch
from .ref import sparse_delta_apply_ref


def sparse_delta_apply(
    base: torch.Tensor, blocks: torch.Tensor, idx: torch.Tensor
) -> torch.Tensor:
    """Return ``base`` with ``blocks[k]`` written to row ``idx[k]``.

    base   : (num_blocks, 8, 128) int32
    blocks : (k, 8, 128) int32
    idx    : (k,) int32; ``idx < 0`` and ``idx >= num_blocks`` are padding

    Rows named twice must carry the same content (``_compact``'s padding
    does): the kernel writes slots in no fixed order.
    """
    check_blocks("base", base)
    check_blocks("blocks", blocks)
    if base.dim() != 3 or blocks.dim() != 3:
        raise ValueError("base and blocks must be (n, 8, 128)")
    if idx.dtype != torch.int32 or tuple(idx.shape) != (blocks.shape[0],):
        raise ValueError(
            f"idx must be int32 of shape ({blocks.shape[0]},), got "
            f"{idx.dtype} {tuple(idx.shape)}"
        )
    if is_cpu(base, blocks, idx):
        return sparse_delta_apply_ref(base, blocks, idx)
    check_launchable(base=base, blocks=blocks, idx=idx)
    out = base.clone()
    k = blocks.shape[0]
    if k:
        launch(
            "delta_sparse_scatter", base.device,
            blocks.data_ptr(), idx.data_ptr(), out.data_ptr(), k, base.shape[0],
        )
        count_launch(sparse_delta_apply)
    return out


sparse_delta_apply.launches = 0
