"""GQA attention (with qk-norm), as ``repro.models.attention`` has it.

Three paths share the parameters:

* ``gqa_forward(cfg, p, x)``              — teacher forcing (no cache);
* ``gqa_prefill(cfg, p, x, cache)``       — fills the decode cache;
* ``gqa_decode(cfg, p, x, cache, pos)``   — one token against the cache.

Cache layout: ``{"k": (B, S_max, KV, hd), "v": ...}``.  Unlike the JAX
package, which returns a new cache, prefill and decode write into the
caller's cache in place (it is the engine's own buffer) and return it.

The sliding window (``window``), cross-attention (``cross_kv``) and MLA wait
for the hybrid, enc-dec and MoE/MLA families (ROADMAP Queue 1) and raise.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..configs.base import ModelConfig
from ..kernels.flash_attention import flash_attention, kernel_takes, needs_grad
from .layers import Params, apply_rope, chunked_attention, rms_norm, rope_table

_LATER = "waits for the {} family (ROADMAP Queue 1, other model families)"


def _no_window(window: int) -> None:
    if window:
        raise NotImplementedError("sliding-window attention " + _LATER.format("hybrid"))


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
    _no_window(window)
    if cross_kv is not None:
        raise NotImplementedError("cross-attention " + _LATER.format("enc-dec"))
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    q, k, v = gqa_project_qkv(cfg, p, x, positions)
    return _out_proj(cfg, p, _full_attention(q, k, v, causal=causal))


def gqa_init_cache(cfg: ModelConfig, batch: int, max_len: int, *, window: int = 0,
                   dtype=torch.bfloat16, device="cuda") -> Dict:
    _no_window(window)
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros((batch, max_len, KV, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_len, KV, hd), dtype=dtype, device=device),
    }


def gqa_prefill(cfg: ModelConfig, p: Params, x: torch.Tensor, cache: Dict,
                *, window: int = 0) -> Tuple[torch.Tensor, Dict]:
    _no_window(window)
    S = x.shape[1]
    q, k, v = gqa_project_qkv(cfg, p, x, torch.arange(S, device=x.device))
    o = _full_attention(q, k, v, causal=True)
    cache["k"][:, :S] = k
    cache["v"][:, :S] = v
    return _out_proj(cfg, p, o), cache


def gqa_decode(cfg: ModelConfig, p: Params, x: torch.Tensor, cache: Dict,
               pos: int, *, window: int = 0) -> Tuple[torch.Tensor, Dict]:
    """x: (B, 1, D); pos: the current position (tokens in the cache)."""
    _no_window(window)
    positions = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    q, k, v = gqa_project_qkv(cfg, p, x, positions)
    cache["k"][:, pos] = k[:, 0]
    cache["v"][:, pos] = v[:, 0]
    o = chunked_attention(q, cache["k"], cache["v"], causal=False, kv_len=pos + 1)
    return _out_proj(cfg, p, o), cache
