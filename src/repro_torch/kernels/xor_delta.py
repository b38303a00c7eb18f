"""XOR delta: ``a ^ b`` over the block layout (the paper's XOR delta variant).

Self-inverse (``a ^ (a ^ b) == b``), so encode and apply share it
(:func:`~repro_torch.kernels.ops.xor_encode` / ``xor_apply``).  Replaces the
Pallas kernel ``xor_delta`` (``_xor_kernel``) of
``src/repro/kernels/xor_delta.py``; the CUDA kernel is ``block_xor_delta`` in
``csrc/block_kernels.cu``, where its bound and design are noted.  The Pallas
kernel aliased ``a`` into its output; here the output is a new tensor and
neither argument changes.
"""

from __future__ import annotations

import torch

from . import check_blocks, check_launchable, count_launch, is_cpu, launch
from .ref import xor_delta_ref


def xor_delta(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a ^ b`` over two equal-shaped int32 ``(num_blocks, 8, 128)`` block
    arrays, as a new tensor."""
    check_blocks("a", a)
    check_blocks("b", b)
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"shape mismatch: {tuple(a.shape)} vs {tuple(b.shape)}")
    if is_cpu(a, b):
        return xor_delta_ref(a, b)
    check_launchable(a=a, b=b)
    out = torch.empty_like(a)
    if a.numel():
        launch(
            "block_xor_delta", a.device,
            a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel() // 4,
        )
        count_launch(xor_delta)
    return out


xor_delta.launches = 0
