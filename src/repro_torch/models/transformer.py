"""Decoder LM spine, as ``repro.models.transformer`` has it, for dense
attention blocks.

Layers are partitioned into **segments**: maximal runs of a repeating unit.
Each segment stacks its parameters over the repeat axis, exactly as the JAX
package's parameter tree does (``params["segments"][i][j][name]`` has the
repeat count first); where JAX scans a segment, the port loops over the
stack index in Python.  There is no remat (the port has no training step
yet).

Block kinds: ``attn`` (GQA) with a dense MLP.  ``mla``, ``rglru``, ``rwkv``
and MoE MLPs wait for their families (ROADMAP Queue 1) and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..kernels import resolve_device
from . import attention as attn_lib
from .layers import Params, mlp_gelu, mlp_swiglu, rms_norm


# ------------------------------------------------------------------ segments
@dataclasses.dataclass(frozen=True)
class Segment:
    unit: Tuple[Tuple[str, bool], ...]  # ((kind, uses_moe), ...)
    repeats: int


def segments(cfg: ModelConfig) -> List[Segment]:
    units = [
        (kind, cfg.layer_uses_moe(i)) for i, kind in enumerate(cfg.blocks())
    ]
    segs: List[Segment] = []
    P = len(cfg.layer_pattern)
    i = 0
    n = len(units)
    while i < n:
        if P > 1 and i + P <= n:
            pat = tuple(units[i : i + P])
            r = 1
            while i + (r + 1) * P <= n and tuple(units[i + r * P : i + (r + 1) * P]) == pat:
                r += 1
            segs.append(Segment(unit=pat, repeats=r))
            i += r * P
            continue
        # maximal run of a single identical unit
        u = units[i]
        r = 1
        while i + r < n and units[i + r] == u:
            r += 1
        segs.append(Segment(unit=(u,), repeats=r))
        i += r
    return segs


def _check_kind(cfg: ModelConfig, kind: str, use_moe: bool) -> None:
    if kind != "attn" or use_moe:
        what = "MoE MLPs" if use_moe else f"{kind!r} blocks"
        raise NotImplementedError(
            f"{cfg.name}: {what} wait for their model family (ROADMAP Queue 1, "
            "other model families); the port runs attention blocks with a dense MLP"
        )


# ---------------------------------------------------------------- block init
def _nrm(gen: torch.Generator, shape, std, device, dtype=torch.bfloat16) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, dtype=torch.float32, device=device) * std).to(dtype)


def block_init(cfg: ModelConfig, kind: str, use_moe: bool, generator: torch.Generator,
               *, repeats: Optional[int] = None, device="cuda") -> Params:
    """One block's parameters (the shapes, stds and dtypes of the JAX
    package's ``block_init``), or ``repeats`` of them stacked on a leading
    axis, drawn on ``device`` from ``generator`` (a generator of that
    device)."""
    _check_kind(cfg, kind, use_moe)
    D, H, KV = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    std = 0.02
    out_std = std / max(1, cfg.n_layers) ** 0.5
    lead = () if repeats is None else (repeats,)

    def nrm(shape, s):
        return _nrm(generator, lead + shape, s, device)

    def zeros(shape):
        return torch.zeros(lead + shape, dtype=torch.bfloat16, device=device)

    p: Params = {"norm1": zeros((D,))}
    p.update(
        wq=nrm((D, H, hd), std),
        wk=nrm((D, KV, hd), std),
        wv=nrm((D, KV, hd), std),
        wo=nrm((H, hd, D), out_std),
    )
    if cfg.qk_norm:
        p["q_norm"] = zeros((hd,))
        p["k_norm"] = zeros((hd,))
    p["norm2"] = zeros((D,))
    F = cfg.d_ff
    if cfg.mlp_kind == "swiglu":
        p["mlp"] = {
            "w_gate": nrm((D, F), std),
            "w_up": nrm((D, F), std),
            "w_down": nrm((F, D), out_std),
        }
    else:
        p["mlp"] = {
            "w_in": nrm((D, F), std),
            "w_out": nrm((F, D), out_std),
        }
    return p


# --------------------------------------------------------------- block apply
def block_apply(
    cfg: ModelConfig,
    kind: str,
    use_moe: bool,
    p: Params,
    x: torch.Tensor,
    *,
    mode: str,                      # train | prefill | decode
    cache: Optional[Dict] = None,
    pos: int = 0,
    window: int = 0,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    _check_kind(cfg, kind, use_moe)
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    new_cache: Optional[Dict] = None
    w = window or cfg.attn_window
    if mode == "train":
        a = attn_lib.gqa_forward(cfg, p, h, window=w)
    elif mode == "prefill":
        a, new_cache = attn_lib.gqa_prefill(cfg, p, h, cache, window=w)
    else:
        a, new_cache = attn_lib.gqa_decode(cfg, p, h, cache, pos, window=w)
    x = x + a
    h2 = rms_norm(x, p["norm2"], cfg.norm_eps)
    mlp = mlp_swiglu if cfg.mlp_kind == "swiglu" else mlp_gelu
    return x + mlp(h2, p["mlp"]), new_cache


def block_cache_init(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     *, window: int = 0, device="cuda") -> Dict:
    _check_kind(cfg, kind, False)
    w = window or (cfg.attn_window if len(cfg.layer_pattern) > 1 else 0)
    return attn_lib.gqa_init_cache(cfg, batch, max_len, window=w, device=device)


# ------------------------------------------------------------------- the LM
def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda") -> Params:
    """The JAX package's parameter tree (``embed``, ``final_norm``,
    ``lm_head`` unless tied, ``segments``), drawn on ``device`` from
    ``generator``, which must be a generator of that device.  The shapes,
    stds and dtypes are JAX's; the random stream is not."""
    device = resolve_device(device)
    D, V = cfg.d_model, cfg.padded_vocab
    p: Params = {
        "embed": _nrm(generator, (V, D), 0.02, device),
        "final_norm": torch.zeros((D,), dtype=torch.bfloat16, device=device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = _nrm(generator, (D, V), 0.02, device)
    p["segments"] = [
        [block_init(cfg, kind, use_moe, generator, repeats=seg.repeats, device=device)
         for kind, use_moe in seg.unit]
        for seg in segments(cfg)
    ]
    return p


def _layer(tree: Any, r: int) -> Any:
    """Layer ``r`` of a stacked tree (views: writes reach the stack)."""
    if isinstance(tree, dict):
        return {k: _layer(v, r) for k, v in tree.items()}
    return tree[r]


def _run_segments(cfg: ModelConfig, params: Params, x: torch.Tensor, *,
                  mode: str, caches=None, pos: int = 0):
    for si, seg in enumerate(segments(cfg)):
        p_seg = params["segments"][si]
        c_seg = caches[si] if caches is not None else None
        for r in range(seg.repeats):
            for j, (kind, use_moe) in enumerate(seg.unit):
                x, _ = block_apply(
                    cfg, kind, use_moe, _layer(p_seg[j], r), x, mode=mode,
                    cache=_layer(c_seg[j], r) if c_seg is not None else None,
                    pos=pos,
                )
    return x, caches


def embed_tokens(cfg: ModelConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens].to(torch.bfloat16)


def lm_logits(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head.to(x.dtype)


def forward_hidden(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
                   inputs_embeds: Optional[torch.Tensor] = None):
    """Final hidden states (B, S, D) and an empty aux dict (no MTP head)."""
    x = inputs_embeds if inputs_embeds is not None else embed_tokens(cfg, params, tokens)
    x, _ = _run_segments(cfg, params, x, mode="train")
    return x, {}


def forward_train(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
                  inputs_embeds: Optional[torch.Tensor] = None):
    """Teacher-forcing logits (B, S, V) and aux; tokens (B, S) integer."""
    x, _ = forward_hidden(cfg, params, tokens, inputs_embeds=inputs_embeds)
    return lm_logits(cfg, params, x), {}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda") -> list:
    """Per segment, per unit position, the cache stacked over the repeats."""
    device = resolve_device(device)
    caches = []
    for seg in segments(cfg):
        seg_caches = []
        for (kind, _moe) in seg.unit:
            one = block_cache_init(cfg, kind, batch, max_len, device=device)
            seg_caches.append({
                k: torch.zeros((seg.repeats,) + tuple(t.shape), dtype=t.dtype, device=device)
                for k, t in one.items()
            })
        caches.append(seg_caches)
    return caches


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor, cache: list,
            *, inputs_embeds: Optional[torch.Tensor] = None):
    """Logits (B, 1, V) of the last prompt position; fills ``cache`` in place
    and returns it."""
    x = inputs_embeds if inputs_embeds is not None else embed_tokens(cfg, params, tokens)
    x, cache = _run_segments(cfg, params, x, mode="prefill", caches=cache)
    return lm_logits(cfg, params, x[:, -1:]), cache


def decode_step(cfg: ModelConfig, params: Params, token: torch.Tensor, cache: list,
                pos: int):
    """token (B, 1); pos the current write position.  Writes the cache in
    place and returns (logits (B, 1, V), cache)."""
    x = embed_tokens(cfg, params, token)
    x, cache = _run_segments(cfg, params, x, mode="decode", caches=cache, pos=pos)
    return lm_logits(cfg, params, x), cache
