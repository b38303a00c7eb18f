"""Encoder-decoder backbone (SeamlessM4T-medium), as ``repro.models.encdec``
has it.

The modality frontend is a stub: the batch's ``frames`` (B, S_enc, d_model)
are precomputed audio-frame embeddings and go straight into the encoder.
The encoder is a non-causal GQA stack; the decoder a causal stack whose
layers also attend over the encoder's output (cross-attention).  Where the
JAX package scans the stacked layers, the port loops over the stack index
in Python.  Under autograd (training) each encoder layer and each decoder
layer of ``mode="train"`` runs inside ``torch.utils.checkpoint``, as the
JAX package's scans run ``jax.checkpoint``-ed bodies: only each layer's
input is kept and the layer is recomputed in the backward pass, whatever
``REPRO_REMAT_POLICY`` says (the JAX package's stacks do not read it).  A
decoder layer computes its cross-attention K/V from ``enc_out`` inside the
checkpoint, so the encoder's output gets the sum of the 12 layers'
gradients and no layer keeps its K/V.  Attention under autograd takes the
chunked softmax (``attention._full_attention``), the flash kernel never;
serving runs under ``no_grad`` and no layer is rematerialised.  The family
trains through ``training.make_train_step`` on batches that carry frames;
``launch.train`` refuses it, as the JAX package's driver, whose pipeline
makes tokens only, cannot train it either.

The cache is the JAX package's ``{"self": {"k", "v"}, "enc_out"}``: the
decoder's self-attention cache, stacked over the layers, and the encoder's
output.  As in the JAX package, each decoder layer recomputes the
cross-attention K/V from ``enc_out`` at every decode step, though the JAX
module's docstring speaks of a once-computed cross K/V (ROADMAP Queue 3).

Prefill writes the self cache in place and returns the encoder's output as
``enc_out``, as long as the frames, as the JAX package's does: decode
attends over exactly that.  The cache's ``enc_out`` buffer (``enc_len``
rows) only gives the cache the JAX package's tree and shapes; no call reads
it.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..kernels import resolve_device
from . import attention as attn_lib
from .layers import Params, mlp_gelu, mlp_swiglu, rms_norm
from .transformer import _draw, _unstack, embed_tokens, lm_logits

BF16 = torch.bfloat16


# --------------------------------------------------------------------- init
def _attn_spec(cfg: ModelConfig, layers: int) -> Dict[str, Any]:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    out_std = 0.02 / max(1, cfg.n_layers) ** 0.5
    return {"wq": ((layers, D, H, hd), 0.02, BF16), "wk": ((layers, D, KV, hd), 0.02, BF16),
            "wv": ((layers, D, KV, hd), 0.02, BF16), "wo": ((layers, H, hd, D), out_std, BF16)}


def _mlp_spec(cfg: ModelConfig, layers: int) -> Dict[str, Any]:
    D, F = cfg.d_model, cfg.d_ff
    if cfg.mlp_kind == "swiglu":
        return {"w_gate": ((layers, D, F), 0.02, BF16), "w_up": ((layers, D, F), 0.02, BF16),
                "w_down": ((layers, F, D), 0.02, BF16)}
    return {"w_in": ((layers, D, F), 0.02, BF16), "w_out": ((layers, F, D), 0.02, BF16)}


def param_spec_encdec(cfg: ModelConfig) -> Params:
    """The parameter tree as ``(shape, init, dtype)`` leaves (see
    ``transformer.block_spec``): the JAX package's ``init_params_encdec``
    tree, with its stds (every MLP weight 0.02, ``wo`` 0.02 / sqrt of the
    decoder's depth in both stacks) and zero norm scales, all bf16."""
    D, V, L, E = cfg.d_model, cfg.padded_vocab, cfg.n_layers, cfg.enc_layers
    zeros = lambda *shape: (shape, None, BF16)
    return {
        "embed": ((V, D), 0.02, BF16),
        "final_norm": zeros(D),
        "lm_head": ((D, V), 0.02, BF16),
        "enc": {"attn": _attn_spec(cfg, E), "mlp": _mlp_spec(cfg, E),
                "norm1": zeros(E, D), "norm2": zeros(E, D), "final_norm": zeros(D)},
        "dec": {"self": _attn_spec(cfg, L), "cross": _attn_spec(cfg, L),
                "mlp": _mlp_spec(cfg, L),
                "norm1": zeros(L, D), "norm2": zeros(L, D), "norm3": zeros(L, D)},
    }


def init_params_encdec(cfg: ModelConfig, generator: torch.Generator,
                       device="cuda") -> Params:
    """The JAX package's parameter tree (:func:`param_spec_encdec`), drawn on
    ``device`` from ``generator``, a generator of that device.  The shapes,
    stds and dtypes are JAX's; the random stream is not."""
    return _draw(param_spec_encdec(cfg), generator, resolve_device(device))


# ------------------------------------------------------------------ forward
_ATTN_AXES = {"wq": ("embed", "heads", None), "wk": ("embed", "kv_heads", None),
              "wv": ("embed", "kv_heads", None), "wo": ("heads", None, "embed")}
_MLP_AXES_SW = {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
                "w_down": ("mlp", "embed")}
_MLP_AXES_GE = {"w_in": ("embed", "mlp"), "w_out": ("mlp", "embed")}


def param_axes_encdec(cfg: ModelConfig, params: Params) -> Any:
    """The logical axes of the enc-dec parameter tree, the JAX package's."""
    st = lambda d: {k: ("stack",) + v for k, v in d.items()}  # noqa: E731
    mlp_axes = _MLP_AXES_SW if cfg.mlp_kind == "swiglu" else _MLP_AXES_GE
    return {
        "embed": ("vocab", "embed"),
        "final_norm": (None,),
        "lm_head": ("embed", "vocab"),
        "enc": {
            "attn": st(_ATTN_AXES), "mlp": st(mlp_axes),
            "norm1": ("stack", None), "norm2": ("stack", None),
            "final_norm": (None,),
        },
        "dec": {
            "self": st(_ATTN_AXES), "cross": st(_ATTN_AXES), "mlp": st(mlp_axes),
            "norm1": ("stack", None), "norm2": ("stack", None),
            "norm3": ("stack", None),
        },
    }


def cache_axes_encdec(cfg: ModelConfig, cache: Dict) -> Any:
    """The logical axes of the enc-dec cache, the JAX package's."""
    kv = ("stack", "batch", "kv_seq", "kv_heads", None)
    return {"self": {"k": kv, "v": kv}, "enc_out": ("batch", "seq", "act_embed")}


def _mlp(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    return (mlp_swiglu if cfg.mlp_kind == "swiglu" else mlp_gelu)(x, p)


def _enc_layer(cfg: ModelConfig, attn_p: Params, mlp_p: Params, n1: torch.Tensor,
               n2: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, n1, cfg.norm_eps)
    x = x + attn_lib.gqa_forward(cfg, attn_p, h, causal=False)
    h = rms_norm(x, n2, cfg.norm_eps)
    return x + _mlp(cfg, mlp_p, h)


def encode(cfg: ModelConfig, params: Params, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, S_enc, D), the stub frontend's output, cast to bf16.  The
    self-attention is non-causal dense attention: the flash kernel where
    ``_full_attention`` takes it (S_enc a multiple of 128, no autograd).
    Under autograd each layer is rematerialised."""
    enc = params["enc"]
    x = frames.to(BF16)
    L = cfg.enc_layers
    remat = torch.is_grad_enabled()
    for attn_p, mlp_p, n1, n2 in zip(_unstack(enc["attn"], L), _unstack(enc["mlp"], L),
                                     enc["norm1"], enc["norm2"]):
        if remat:
            x = checkpoint(_enc_layer, cfg, attn_p, mlp_p, n1, n2, x, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = _enc_layer(cfg, attn_p, mlp_p, n1, n2, x)
    return rms_norm(x, enc["final_norm"], cfg.norm_eps)


def _cross_kv(cfg: ModelConfig, cross_p: Params, enc_out: torch.Tensor):
    """The cross-attention's K and V (B, S_enc, KV, hd) from the encoder's
    output: no rotary phase, no qk-norm."""
    B, S, D = enc_out.shape
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    k = (enc_out @ cross_p["wk"].reshape(D, KV * hd)).reshape(B, S, KV, hd)
    v = (enc_out @ cross_p["wv"].reshape(D, KV * hd)).reshape(B, S, KV, hd)
    return k, v


def _dec_layer(cfg: ModelConfig, self_p: Params, cross_p: Params, mlp_p: Params,
               n1: torch.Tensor, n2: torch.Tensor, n3: torch.Tensor, x: torch.Tensor,
               enc_out: torch.Tensor, mode: str = "train", cache=None,
               pos: int = 0) -> torch.Tensor:
    h = rms_norm(x, n1, cfg.norm_eps)
    if mode == "train":
        a = attn_lib.gqa_forward(cfg, self_p, h)
    elif mode == "prefill":
        a, _ = attn_lib.gqa_prefill(cfg, self_p, h, cache)
    else:
        a, _ = attn_lib.gqa_decode(cfg, self_p, h, cache, pos)
    x = x + a
    h = rms_norm(x, n2, cfg.norm_eps)
    x = x + attn_lib.gqa_forward(cfg, cross_p, h, cross_kv=_cross_kv(cfg, cross_p, enc_out))
    h = rms_norm(x, n3, cfg.norm_eps)
    return x + _mlp(cfg, mlp_p, h)


def _decoder(cfg: ModelConfig, params: Params, x: torch.Tensor, enc_out: torch.Tensor, *,
             mode: str, caches=None, pos: int = 0) -> torch.Tensor:
    """The decoder stack over ``x`` (B, S, D); ``mode`` train | prefill |
    decode.  Prefill and decode write the self cache ``caches`` (stacked
    over the layers) in place; training under autograd rematerialises each
    layer, its cross K/V included."""
    dec, L = params["dec"], cfg.n_layers
    layer_caches = _unstack(caches, L) if caches is not None else [None] * L
    remat = mode == "train" and torch.is_grad_enabled()
    for self_p, cross_p, mlp_p, n1, n2, n3, cache in zip(
            _unstack(dec["self"], L), _unstack(dec["cross"], L), _unstack(dec["mlp"], L),
            dec["norm1"], dec["norm2"], dec["norm3"], layer_caches):
        if remat:
            x = checkpoint(_dec_layer, cfg, self_p, cross_p, mlp_p, n1, n2, n3, x, enc_out,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _dec_layer(cfg, self_p, cross_p, mlp_p, n1, n2, n3, x, enc_out, mode, cache,
                           pos)
    return x


def forward_hidden_encdec(cfg: ModelConfig, params: Params, frames: torch.Tensor,
                          tokens: torch.Tensor):
    """Final decoder hidden states (B, S, D) and an empty aux."""
    enc_out = encode(cfg, params, frames)
    x = embed_tokens(cfg, params, tokens)
    return _decoder(cfg, params, x, enc_out, mode="train"), {}


def forward_train_encdec(cfg: ModelConfig, params: Params, frames: torch.Tensor,
                         tokens: torch.Tensor):
    """Teacher-forcing logits (B, S, V) and an empty aux."""
    x, _ = forward_hidden_encdec(cfg, params, frames, tokens)
    return lm_logits(cfg, params, x), {}


# -------------------------------------------------------------------- cache
def init_cache_encdec(cfg: ModelConfig, batch: int, max_len: int, enc_len: int,
                      device="cuda") -> Dict:
    device = resolve_device(device)
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    shape = (cfg.n_layers, batch, max_len, KV, hd)
    return {
        "self": {"k": torch.zeros(shape, dtype=BF16, device=device),
                 "v": torch.zeros(shape, dtype=BF16, device=device)},
        "enc_out": torch.zeros((batch, enc_len, cfg.d_model), dtype=BF16, device=device),
    }


def prefill_encdec(cfg: ModelConfig, params: Params, frames: torch.Tensor,
                   tokens: torch.Tensor, cache: Dict):
    """Logits (B, 1, V) of the last prompt position.  Writes the self cache
    in place; returns the logits and ``{"self", "enc_out"}``, ``enc_out``
    the encoder's output (B, S_enc, D)."""
    enc_out = encode(cfg, params, frames)
    x = embed_tokens(cfg, params, tokens)
    x = _decoder(cfg, params, x, enc_out, mode="prefill", caches=cache["self"])
    return lm_logits(cfg, params, x[:, -1:]), {"self": cache["self"], "enc_out": enc_out}


def decode_step_encdec(cfg: ModelConfig, params: Params, token: torch.Tensor, cache: Dict,
                       pos: int):
    """token (B, 1); pos the current write position.  Attends over
    ``cache["enc_out"]`` (what prefill returned) and writes the self cache in
    place; returns (logits (B, 1, V), cache)."""
    x = embed_tokens(cfg, params, token)
    x = _decoder(cfg, params, x, cache["enc_out"], mode="decode", caches=cache["self"],
                 pos=pos)
    return lm_logits(cfg, params, x), cache
