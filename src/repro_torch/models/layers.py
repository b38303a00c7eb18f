"""Shared model building blocks: norms, RoPE, MLPs, chunked and
block-local attention.

A copy of ``repro.models.layers`` in PyTorch.

Conventions (the JAX package's):

* params are plain nested dicts of tensors (bf16 weights);
* math that affects stability (norms, softmax, rotary) runs in f32 and is
  cast back;
* every block takes and returns (B, S, D) activations;
* attention is **chunked / online-softmax** over KV chunks, so prefill
  never materialises (S, S) scores; a product of bf16 operands accumulates
  in f32 (the operands are widened, exactly, before ``einsum``);
* sliding-window attention takes the exact block-local form (block =
  window, each block attends to itself and the previous one): O(S·W), one
  block's scores at a time.

The JAX package's ``shard`` annotations are no-ops outside a mesh and have
no counterpart.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

Params = Dict[str, Any]

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


# --------------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def group_norm_heads(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float = 64e-5) -> torch.Tensor:
    """Per-head LayerNorm over head_dim (RWKV's ln_x), population variance."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale + bias).to(x.dtype)


# ---------------------------------------------------------------------- RoPE
def rope_table(positions: torch.Tensor, dim: int,
               theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for positions (any shape) -> (..., dim/2)."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device) / dim
    inv = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, hd); cos/sin: (B?, S, hd/2) broadcastable."""
    xf = x.float()
    x1, x2 = torch.chunk(xf, 2, dim=-1)
    if cos.dim() == 2:    # (S, hd/2) -> (1, S, 1, hd/2)
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    elif cos.dim() == 3:  # (B, S, hd/2) -> (B, S, 1, hd/2)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------- MLPs
def mlp_swiglu(x: torch.Tensor, p: Params) -> torch.Tensor:
    h = x @ p["w_gate"]
    u = x @ p["w_up"]
    h = F.silu(h.float()).to(x.dtype) * u
    return h @ p["w_down"]


def mlp_gelu(x: torch.Tensor, p: Params) -> torch.Tensor:
    h = x @ p["w_in"]
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return h @ p["w_out"]


# ---------------------------------------------------- chunked flash attention
def chunked_attention(
    q: torch.Tensor,          # (B, Sq, H, hd)
    k: torch.Tensor,          # (B, Sk, KV, hd)
    v: torch.Tensor,          # (B, Sk, KV, hd)
    *,
    causal: bool,
    q_offset: Union[torch.Tensor, int] = 0,   # global position of q[0]
    kv_len: Union[torch.Tensor, int, None] = None,  # valid kv entries (caches)
    chunk: int = 1024,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """Online-softmax attention, scanning KV in chunks of ``chunk``.

    Supports GQA (H a multiple of KV) and ragged caches via ``kv_len``.
    Returns (B, Sq, H, hd) in q.dtype.  ``Sq == 1`` (decode) takes one
    unchunked softmax over the cache.
    """
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    hd_v = v.shape[-1]
    g = H // KV
    dev = q.device
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(hd)
    # the bf16 operand, widened exactly: f32 products of bf16 values
    qh = (q.float() * scale).to(q.dtype).float().reshape(B, Sq, KV, g, hd)
    limit = torch.broadcast_to(
        torch.as_tensor(Sk if kv_len is None else kv_len, device=dev), (B,))

    if Sq == 1:
        # decode: one unchunked softmax over the cache
        s = torch.einsum("bqkgd,bckd->bqkgc", qh, k.float())
        k_pos = torch.arange(Sk, device=dev)
        mask = k_pos[None, :] < limit[:, None]
        if causal:
            q_pos = torch.as_tensor(q_offset, device=dev) + torch.zeros(
                (Sq,), dtype=torch.int64, device=dev)
            mask = mask[:, None, :] & (k_pos[None, None, :] <= q_pos[None, :, None])
        else:
            mask = mask[:, None, :]
        s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bqkgc,bckd->bqkgd", p.to(q.dtype).float(), v.float())
        return o.reshape(B, Sq, H, hd_v).to(q.dtype)

    n_chunks = -(-Sk // chunk)
    pad = n_chunks * chunk - Sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    q_pos = (torch.as_tensor(q_offset, device=dev)
             + torch.arange(Sq, device=dev))[None, :]             # (1, Sq)

    m = torch.full((B, Sq, KV, g), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Sq, KV, g), dtype=torch.float32, device=dev)
    o = torch.zeros((B, Sq, KV, g, hd_v), dtype=torch.float32, device=dev)
    for ci in range(n_chunks):
        kb = k[:, ci * chunk:(ci + 1) * chunk].float()
        vb = v[:, ci * chunk:(ci + 1) * chunk].float()
        s = torch.einsum("bqkgd,bckd->bqkgc", qh, kb)   # (B, Sq, KV, g, chunk)
        k_pos = ci * chunk + torch.arange(chunk, device=dev)
        mask = (k_pos[None, :] < limit[:, None])[:, None, :]        # (B, 1, chunk)
        if causal:
            mask = mask & (k_pos[None, None, :] <= q_pos[:, :, None])
        s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bqkgc,bckd->bqkgd", p.to(q.dtype).float(), vb)
        o = o * corr[..., None] + pv
        m = m_new
    o = o / torch.clamp(l[..., None], min=1e-30)
    return o.reshape(B, Sq, H, hd_v).to(q.dtype)


def block_local_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, window: int,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """Exact sliding-window causal attention, O(S·W).

    Queries in block i attend to keys in blocks {i-1, i} with the mask
    ``q_pos - window < k_pos <= q_pos``: a causal sliding window of width
    ``window`` when blocks are window-sized.  The JAX package computes every
    block's (W, 2W) scores at once; here one block's at a time (the same
    products and softmax), so that the f32 scores of one block are the
    largest buffer.
    """
    B, S, H, hd = q.shape
    KV = k.shape[2]
    g = H // KV
    W = window
    dev = q.device
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(hd)
    nb = -(-S // W)
    pad = nb * W - S
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    # the bf16 operand, widened exactly
    qb = (q.float() * scale).to(q.dtype).float().reshape(B, nb, W, KV, g, hd)
    kb = k.reshape(B, nb, W, KV, hd)
    vb = v.reshape(B, nb, W, KV, hd)
    q_pos = torch.arange(W, device=dev)[:, None]          # within-block query pos
    k_pos = torch.arange(2 * W, device=dev)[None, :] - W   # relative to block start
    mask = (k_pos <= q_pos) & (k_pos > q_pos - W)          # (W, 2W)
    out = torch.empty((B, nb, W, H, hd), dtype=q.dtype, device=dev)
    for n in range(nb):
        # block 0's previous block is zeros, masked: keys at negative positions
        k_prev = kb[:, n - 1] if n else torch.zeros_like(kb[:, 0])
        v_prev = vb[:, n - 1] if n else torch.zeros_like(vb[:, 0])
        k2 = torch.cat([k_prev, kb[:, n]], dim=1).float()  # (B, 2W, KV, hd)
        v2 = torch.cat([v_prev, vb[:, n]], dim=1).float()
        s = torch.einsum("bqkgd,bckd->bqkgc", qb[:, n], k2)
        m = mask if n else mask & (k_pos >= 0)
        s = torch.where(m[None, :, None, None, :], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bqkgc,bckd->bqkgd", p.to(q.dtype).float(), v2)
        out[:, n] = o.reshape(B, W, H, hd).to(q.dtype)
    return out.reshape(B, nb * W, H, hd)[:, :S]
