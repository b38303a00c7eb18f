"""Changed-block detection and block content hashing over the block layout.

* :func:`changed_block_mask` — which 4 KiB blocks of a new tensor differ
  from its base; feeds the store's block-sparse delta encoder (commit
  path).  Replaces the Pallas kernel ``changed_block_mask``
  (``_mask_kernel``) of ``src/repro/kernels/block_diff.py``; the CUDA kernel
  is ``delta_changed_block_mask`` in ``csrc/delta_kernels.cu``.
* :func:`block_hash` — a position-weighted multiplicative hash per block,
  a dedup hint.  Replaces the Pallas kernel ``block_hash``
  (``_hash_kernel``) of the same file; the CUDA kernel is ``block_hash`` in
  ``csrc/block_kernels.cu``.  :func:`hash_coefficients` is a numpy copy of
  the JAX package's multiplier table, bit for bit.

Each CUDA source notes its kernels' bounds and design.
"""

from __future__ import annotations

import numpy as np
import torch

from . import check_blocks, check_launchable, count_launch, is_cpu, launch
from .ref import block_hash_ref, changed_block_mask_ref


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
        count_launch(changed_block_mask)
    return out


changed_block_mask.launches = 0


def hash_coefficients(seed: int = 0x9E3779B9) -> np.ndarray:
    """Deterministic odd per-position multipliers for the block hash: an
    (8, 128) int32 table (numpy's legacy ``RandomState`` stream, as in the
    JAX package)."""
    rng = np.random.RandomState(seed & 0x7FFFFFFF)
    coef = rng.randint(0, 2**31, size=(8, 128), dtype=np.int64)
    coef = (coef * 2 + 1).astype(np.int64)  # odd => position-bijective
    return coef.astype(np.uint32).view(np.int32).reshape(8, 128)


def block_hash(x: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """(num_blocks, 1) int32 hash per 4 KiB block: Σ x[s,l]·coef[s,l] with
    int32 wraparound; ``coef`` is an (8, 128) int32 multiplier table."""
    check_blocks("x", x)
    if x.dim() != 3:
        raise ValueError(f"x must be (num_blocks, 8, 128), got {tuple(x.shape)}")
    if coef.dtype != torch.int32 or tuple(coef.shape) != tuple(x.shape[1:]):
        raise ValueError(
            f"coef must be int32 (8, 128), got {coef.dtype} {tuple(coef.shape)}"
        )
    if is_cpu(x, coef):
        return block_hash_ref(x, coef)
    check_launchable(x=x, coef=coef)
    nb = x.shape[0]
    out = torch.empty((nb, 1), dtype=torch.int32, device=x.device)
    if nb:
        launch(
            "block_hash", x.device,
            x.data_ptr(), coef.data_ptr(), out.data_ptr(), nb,
        )
        count_launch(block_hash)
    return out


block_hash.launches = 0
