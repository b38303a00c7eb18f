"""Attention blocks: GQA (with qk-norm and an optional sliding window) and
MLA (DeepSeek), as ``repro.models.attention`` has them.

Each block has three paths sharing its parameters:

* ``forward(cfg, p, x)``              — teacher forcing (no cache);
* ``prefill(cfg, p, x, cache)``       — fills the decode cache;
* ``decode(cfg, p, x, cache, pos)``   — one token against the cache.

Cache layouts:

* GQA: ``{"k": (B, S_max, KV, hd), "v": ...}``; with a window W, a ring of
  ``min(W, S_max)`` slots that holds position p at slot p % W;
* MLA: the full cache ``{"k": (B, S_max, H, nd + rd), "v": (B, S_max, H,
  vd)}``, or with ``mla_compressed_cache`` the latent ``{"ckv": (B, S_max,
  kv_lora + rope_dim)}``, whose decode attends in the latent space with the
  up-projections absorbed into the query and the output.

Unlike the JAX package, which returns a new cache, prefill and decode write
into the caller's cache in place (it is the engine's own buffer) and return
it.  MLA never takes the flash kernel: the JAX package calls the chunked
softmax directly there (q's head dim, nd + rd, differs from v's).

The windowed prefill lays the ring out as decode writes it, position p at
slot p % W.  The JAX package's prefill keeps the last W keys from slot 0,
which its decode agrees with only when S <= W or S % W == 0 (ROADMAP Queue
3); at those lengths both caches are equal.  Cross-attention (``cross_kv``,
the enc-dec family's) takes q from ``x`` and the K/V it is handed, and
always the chunked softmax, as the JAX package's does.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ..configs.base import ModelConfig
from ..kernels.flash_attention import flash_attention, kernel_takes, needs_grad
from .layers import (
    Params,
    apply_rope,
    block_local_attention,
    chunked_attention,
    rms_norm,
    rope_table,
)


def _full_attention(q, k, v, *, causal: bool):
    """Dense attention: the flash kernel where the JAX package's opt-in path
    takes it (uniform head dims, sequences that are multiples of 128, more
    than one query) and the kernel takes the shape (``kernel_takes``: its
    head dims and group sizes, bf16 on the card), the chunked online softmax
    otherwise.  The flash kernel has no backward (nor has the JAX package's),
    so wherever autograd will need the output (grad mode on and q, k or v
    requiring grad: training) the route is the chunked softmax, the JAX
    package's own training route.  The route is chosen before any launch."""
    Sq, Sk = q.shape[1], k.shape[1]
    if (not needs_grad(q, k, v) and q.shape[-1] == v.shape[-1] and Sq % 128 == 0
            and Sk % 128 == 0 and Sq > 1 and kernel_takes(q, k, v)):
        bq = 512 if Sq % 512 == 0 else 128
        bk = 512 if Sk % 512 == 0 else 128
        return flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk)
    return chunked_attention(q, k, v, causal=causal)


def gqa_project_qkv(cfg: ModelConfig, p: Params, x: torch.Tensor, positions):
    B, S, D = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = (x @ p["wq"].reshape(D, H * hd)).reshape(B, S, H, hd)
    k = (x @ p["wk"].reshape(D, KV * hd)).reshape(B, S, KV, hd)
    v = (x @ p["wv"].reshape(D, KV * hd)).reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    cos, sin = rope_table(positions, hd, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _out_proj(cfg: ModelConfig, p: Params, o: torch.Tensor) -> torch.Tensor:
    B, S, H, hd = o.shape
    return o.reshape(B, S, H * hd) @ p["wo"].reshape(H * hd, -1)


def gqa_forward(cfg: ModelConfig, p: Params, x: torch.Tensor, *, window: int = 0,
                positions=None, cross_kv=None, causal: bool = True) -> torch.Tensor:
    if cross_kv is not None:
        # cross-attention: q from x (no rotary phase, no qk-norm), k and v
        # handed in (the encoder's); always the chunked softmax, as in JAX
        B, S, D = x.shape
        H, hd = cfg.n_heads, cfg.resolved_head_dim
        q = (x @ p["wq"].reshape(D, H * hd)).reshape(B, S, H, hd)
        k, v = cross_kv
        return _out_proj(cfg, p, chunked_attention(q, k, v, causal=False))
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    q, k, v = gqa_project_qkv(cfg, p, x, positions)
    if window:
        o = block_local_attention(q, k, v, window=window)
    else:
        o = _full_attention(q, k, v, causal=causal)
    return _out_proj(cfg, p, o)


def gqa_init_cache(cfg: ModelConfig, batch: int, max_len: int, *, window: int = 0,
                   dtype=torch.bfloat16, device="cuda") -> Dict:
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    S = min(window, max_len) if window else max_len
    return {
        "k": torch.zeros((batch, S, KV, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, S, KV, hd), dtype=dtype, device=device),
    }


def gqa_prefill(cfg: ModelConfig, p: Params, x: torch.Tensor, cache: Dict,
                *, window: int = 0) -> Tuple[torch.Tensor, Dict]:
    S = x.shape[1]
    q, k, v = gqa_project_qkv(cfg, p, x, torch.arange(S, device=x.device))
    if window:
        o = block_local_attention(q, k, v, window=window)
        W = cache["k"].shape[1]
        # the last min(S, W) positions, position p at slot p % W; the slots
        # past S (a prompt shorter than the ring) hold zeros
        n = min(S, W)
        slots = torch.arange(S - n, S, device=x.device) % W
        for name, t in (("k", k), ("v", v)):
            cache[name][:, n:] = 0
            cache[name][:, slots] = t[:, S - n:]
    else:
        o = _full_attention(q, k, v, causal=True)
        cache["k"][:, :S] = k
        cache["v"][:, :S] = v
    return _out_proj(cfg, p, o), cache


def gqa_decode(cfg: ModelConfig, p: Params, x: torch.Tensor, cache: Dict,
               pos: int, *, window: int = 0) -> Tuple[torch.Tensor, Dict]:
    """x: (B, 1, D); pos: the current position (tokens before this one)."""
    positions = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    q, k, v = gqa_project_qkv(cfg, p, x, positions)
    # the ring holds the last W tokens (slot pos % W); the rotary phases were
    # applied at absolute positions, so one softmax over the ring is exact
    slot = pos % cache["k"].shape[1] if window else pos
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    kv_len = min(pos + 1, cache["k"].shape[1])
    o = chunked_attention(q, cache["k"], cache["v"], causal=False, kv_len=kv_len)
    return _out_proj(cfg, p, o), cache


# ===================================================================== MLA ==
def _mla_dims(cfg: ModelConfig):
    return (cfg.n_heads, cfg.q_lora_rank, cfg.kv_lora_rank,
            cfg.qk_rope_head_dim, cfg.qk_nope_head_dim, cfg.v_head_dim)


def _mla_scale(cfg: ModelConfig) -> float:
    return 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)


def mla_project_q(cfg: ModelConfig, p: Params, x: torch.Tensor, positions):
    """(q_nope (B, S, H, nd), q_rope (B, S, H, rd)), the rotary part rotated."""
    B, S, _ = x.shape
    H, qr, kvr, rd, nd, vd = _mla_dims(cfg)
    cq = rms_norm(x @ p["wq_a"], p["q_norm"], cfg.norm_eps)
    q = (cq @ p["wq_b"].reshape(qr, H * (nd + rd))).reshape(B, S, H, nd + rd)
    cos, sin = rope_table(positions, rd, cfg.rope_theta)
    return q[..., :nd], apply_rope(q[..., nd:], cos, sin)


def _mla_latent(cfg: ModelConfig, p: Params, x: torch.Tensor, positions):
    """(ckv (B, S, kvr) normed, k_rope (B, S, rd) rotated): what the
    compressed cache holds, and what the full form expands."""
    H, qr, kvr, rd, nd, vd = _mla_dims(cfg)
    ckv_full = x @ p["wkv_a"]                               # (B, S, kvr + rd)
    ckv = rms_norm(ckv_full[..., :kvr], p["kv_norm"], cfg.norm_eps)
    cos, sin = rope_table(positions, rd, cfg.rope_theta)
    # one rotary key shared across the heads
    k_rope = apply_rope(ckv_full[..., None, kvr:], cos, sin)[..., 0, :]
    return ckv, k_rope


def mla_project_kv(cfg: ModelConfig, p: Params, x: torch.Tensor, positions):
    """(k (B, S, H, nd + rd), v (B, S, H, vd)): the expanded (full) form."""
    B, S, _ = x.shape
    H, qr, kvr, rd, nd, vd = _mla_dims(cfg)
    ckv, k_rope = _mla_latent(cfg, p, x, positions)
    kv = (ckv @ p["wkv_b"].reshape(kvr, H * (nd + vd))).reshape(B, S, H, nd + vd)
    k_nope, v = kv[..., :nd], kv[..., nd:]
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, rd)], dim=-1)
    return k, v


def _mla_attend_full(cfg: ModelConfig, p: Params, x: torch.Tensor, positions):
    """Causal attention of ``x`` over itself; also returns its (k, v)."""
    q_nope, q_rope = mla_project_q(cfg, p, x, positions)
    k, v = mla_project_kv(cfg, p, x, positions)
    q = torch.cat([q_nope, q_rope], dim=-1)
    o = chunked_attention(q, k, v, causal=True, softmax_scale=_mla_scale(cfg))
    return _out_proj(cfg, p, o), k, v


def mla_forward(cfg: ModelConfig, p: Params, x: torch.Tensor,
                positions=None) -> torch.Tensor:
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    return _mla_attend_full(cfg, p, x, positions)[0]


def mla_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, device="cuda") -> Dict:
    H, qr, kvr, rd, nd, vd = _mla_dims(cfg)
    if cfg.mla_compressed_cache:
        return {"ckv": torch.zeros((batch, max_len, kvr + rd), dtype=dtype, device=device)}
    return {
        "k": torch.zeros((batch, max_len, H, nd + rd), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_len, H, vd), dtype=dtype, device=device),
    }


def mla_prefill(cfg: ModelConfig, p: Params, x: torch.Tensor,
                cache: Dict) -> Tuple[torch.Tensor, Dict]:
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    out, k, v = _mla_attend_full(cfg, p, x, positions)
    if cfg.mla_compressed_cache:
        ckv, k_rope = _mla_latent(cfg, p, x, positions)
        cache["ckv"][:, :S] = torch.cat([ckv, k_rope], dim=-1)
    else:
        cache["k"][:, :S] = k
        cache["v"][:, :S] = v
    return out, cache


def mla_decode(cfg: ModelConfig, p: Params, x: torch.Tensor, cache: Dict,
               pos: int) -> Tuple[torch.Tensor, Dict]:
    """x: (B, 1, D); pos: the current position (tokens in the cache)."""
    H, qr, kvr, rd, nd, vd = _mla_dims(cfg)
    positions = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    q_nope, q_rope = mla_project_q(cfg, p, x, positions)
    if cfg.mla_compressed_cache:
        # absorbed-weight decode: attend in the kvr-wide latent space, in f32
        ckv, k_rope = _mla_latent(cfg, p, x, positions)
        cache["ckv"][:, pos] = torch.cat([ckv, k_rope], dim=-1)[:, 0]
        wkv_b = p["wkv_b"].reshape(kvr, H, nd + vd)
        w_k_nope, w_v = wkv_b[..., :nd], wkv_b[..., nd:]
        # fold W^UK into q: q_lat (B, 1, H, kvr), a bf16 product
        q_lat = torch.einsum("bshk,rhk->bshr", q_nope, w_k_nope)
        ck = cache["ckv"].float()                           # (B, S_max, kvr + rd)
        scores = (
            torch.einsum("bshr,btr->bsht", q_lat.float(), ck[..., :kvr])
            + torch.einsum("bshk,btk->bsht", q_rope.float(), ck[..., kvr:])
        ) / math.sqrt(nd + rd)
        t_pos = torch.arange(ck.shape[1], device=x.device)
        scores = torch.where(t_pos <= pos, scores, -1e30)
        w = torch.softmax(scores, dim=-1)
        o_lat = torch.einsum("bsht,btr->bshr", w, ck[..., :kvr])    # (B, 1, H, kvr)
        o = torch.einsum("bshr,rhv->bshv", o_lat, w_v.float()).to(x.dtype)
    else:
        k, v = mla_project_kv(cfg, p, x, positions)
        cache["k"][:, pos] = k[:, 0]
        cache["v"][:, pos] = v[:, 0]
        q = torch.cat([q_nope, q_rope], dim=-1)
        o = chunked_attention(q, cache["k"], cache["v"], causal=False, kv_len=pos + 1,
                              softmax_scale=_mla_scale(cfg))
    return _out_proj(cfg, p, o), cache
