"""Forward GQA flash attention: the prefill's attention.

Replaces the Pallas kernel ``flash_attention`` (``_flash_kernel``) of
``src/repro/kernels/flash_attention.py``; the CUDA kernel is
``attention_flash_fwd`` in ``csrc/attention_kernels.cu``, where its bound and
design are noted (a persistent, warp-specialised kernel: TMA loads, wgmma
products).  The JAX kernel's ``block_q`` / ``block_k`` were tile sizes for
the TPU's VMEM; the CUDA kernel picks its own tiles, so on the card they
only have to divide the sequences as in JAX, and the plain version (CPU
tensors) takes ``block_k`` as its key-block size.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import count_launch, is_cpu, launch
from .ref import flash_attention_ref

DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_K = 512
#: head dims the CUDA kernel is built for (every dense config, full and reduced)
HEAD_DIMS = (32, 64, 128)
#: query heads per KV head the CUDA kernel takes: a consumer warpgroup's 64
#: rows hold whole positions, all g heads of each
MAX_GROUP = 64


def kernel_takes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether the CUDA kernel takes these inputs: hd in :data:`HEAD_DIMS`, at
    most :data:`MAX_GROUP` query heads per KV head and, where the tensors lie
    on a CUDA device, bf16.  The head-dim and group conditions hold on every
    device, so a CPU run routes a shape as the card would; the dtype
    condition does not, so an f32 CPU run keeps its route."""
    if q.shape[-1] not in HEAD_DIMS or q.shape[2] // k.shape[2] > MAX_GROUP:
        return False
    return q.device.type != "cuda" or q.dtype == k.dtype == v.dtype == torch.bfloat16


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd will need an output computed from ``tensors``: grad
    mode is on and one of them requires grad.  The kernel has no backward,
    so it must not run then."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def flash_attention(
    q: torch.Tensor,   # (B, Sq, H, hd)
    k: torch.Tensor,   # (B, Sk, KV, hd)
    v: torch.Tensor,   # (B, Sk, KV, hd)
    *,
    causal: bool = True,
    softmax_scale: Optional[float] = None,
    block_q: int = DEFAULT_BLOCK_Q,
    block_k: int = DEFAULT_BLOCK_K,
) -> torch.Tensor:
    """Attention of ``q`` over ``k`` / ``v``; query head ``h`` reads KV head
    ``h // (H // KV)``.  ``causal`` masks keys past the query's position
    (positions count from 0 in both).  Returns (B, Sq, H, hd) in q's dtype.

    CPU tensors take :func:`~.ref.flash_attention_ref`; CUDA tensors launch
    the kernel, which has no backward, so an input that requires grad under
    grad mode raises (bf16, hd in :data:`HEAD_DIMS`, H / KV at most
    :data:`MAX_GROUP`, the head dim contiguous, 16-byte strides and start,
    as TMA reads them) or raise.
    """
    B, Sq, H, hd = q.shape
    _, Sk, KV, hd_v = v.shape
    if k.shape != v.shape or k.shape[0] != B or H % KV or hd != k.shape[-1] or hd_v != hd:
        raise ValueError(
            "flash attention needs q (B, Sq, H, hd) and k, v (B, Sk, KV, hd) "
            f"with H a multiple of KV, got {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}"
        )
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(hd)
    block_q = min(block_q, Sq)
    block_k = min(block_k, Sk)
    if Sq % block_q or Sk % block_k:
        raise ValueError(f"block_q {block_q} / block_k {block_k} must divide Sq {Sq} / Sk {Sk}")
    if is_cpu(q, k, v):
        return flash_attention_ref(q, k, v, causal=causal, softmax_scale=scale,
                                   block_k=block_k)
    if needs_grad(q, k, v):
        raise ValueError(
            "the CUDA flash kernel is forward-only and its output would carry no "
            "gradient: under autograd, attention takes the chunked softmax "
            "(models.attention._full_attention)"
        )
    if not kernel_takes(q, k, v):
        raise ValueError(
            f"the CUDA kernel takes bf16 with hd in {HEAD_DIMS} and at most "
            f"{MAX_GROUP} query heads per KV head, got {q.dtype}/{k.dtype}/{v.dtype} "
            f"hd {hd}, H {H}, KV {KV}"
        )
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(
                f"{name} must have a contiguous head dim, strides that are "
                f"multiples of 8 and a 16-byte aligned start, got strides "
                f"{t.stride()}"
            )
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    # the persistent kernel's CTAs take their work tiles from this counter
    next_tile = torch.zeros(1, dtype=torch.int32, device=q.device)
    launch(
        "attention_flash_fwd", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), next_tile.data_ptr(),
        B, Sq, Sk, H, KV, hd,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        ctypes.c_float(scale), int(causal),
    )
    count_launch(flash_attention)
    return out


flash_attention.launches = 0


def flash_hbm_bytes(B: int, Sq: int, Sk: int, H: int, KV: int, hd: int,
                    dtype_bytes: int = 2) -> int:
    """Analytic HBM traffic of the JAX package's kernel: Q and O once; K/V
    once per ``DEFAULT_BLOCK_Q`` query block (VMEM-resident within it)."""
    q_o = 2 * B * Sq * H * hd * dtype_bytes
    kv = 2 * B * Sk * KV * hd * dtype_bytes * max(1, Sq // DEFAULT_BLOCK_Q)
    return q_o + kv
