"""Changed-block mask: which 4 KiB blocks of a new tensor differ from its base.

Feeds the store's block-sparse delta encoder (commit path).  Replaces the
Pallas kernel ``changed_block_mask`` (``_mask_kernel``) of
``src/repro/kernels/block_diff.py``; the CUDA kernel is
``delta_changed_block_mask`` in ``csrc/delta_kernels.cu``, where its bound
and design are noted.
"""

from __future__ import annotations

import torch

from . import check_blocks, check_launchable, is_cpu, launch
from .ref import changed_block_mask_ref


def changed_block_mask(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(num_blocks, 1) int32 mask of blocks where ``a`` and ``b`` differ."""
    check_blocks("a", a)
    check_blocks("b", b)
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"shape mismatch: {tuple(a.shape)} vs {tuple(b.shape)}")
    if is_cpu(a, b):
        return changed_block_mask_ref(a, b)
    check_launchable(a=a, b=b)
    nb = a.shape[0]
    out = torch.empty((nb, 1), dtype=torch.int32, device=a.device)
    if nb:
        launch(
            "delta_changed_block_mask", a.device,
            a.data_ptr(), b.data_ptr(), out.data_ptr(), nb,
        )
        changed_block_mask.launches += 1
    return out


changed_block_mask.launches = 0
