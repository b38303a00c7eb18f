"""Arch registry: one ModelBundle API, as ``repro.models.registry`` has it.

``get_model(cfg)`` returns a bundle of plain functions that the server and
the trainer share.  Batches:

* LM families: ``{"tokens": (B, S) integer}`` (and optionally
  ``"inputs_embeds"`` (B, S, D));
* enc-dec (audio): ``{"frames": (B, S_enc, D), "tokens": (B, S) integer}``.

The port runs decoder configs of ``attn`` (GQA, windowed or not), ``mla``,
``rglru`` and ``rwkv`` blocks, with a dense MLP or an MoE
(``moe_impl="dispatch"``, or the expert-parallel ``"ep"`` under a
``logical_sharding`` mesh), and the encoder-decoder family (:mod:`.encdec`).
``param_axes`` / ``cache_axes`` give a parameter or cache tree's logical
sharding axes (``repro_torch.distributed.sharding``), the JAX package's.

``count_params`` derives N (total and active) analytically from the config,
a copy of the JAX package's, with its two miscounts (ROADMAP Queue 3): it
counts DeepSeek's MTP block as a GQA block though it is an MLA block, and
leaves out RWKV-6's twelve D-vectors a layer (``mu_x``, the five rows of
``mu_rkvwg``, ``w0``, ``u``, ``ln_x_scale``, ``ln_x_bias``, ``ffn_mu_k``,
``ffn_mu_r``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from ..configs.base import ModelConfig
from . import encdec as ed
from . import transformer as tf


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ModelConfig
    init: Callable[..., Any]             # (generator, device="cuda") -> params
    param_axes: Callable[[Any], Any]     # params -> logical axes tree
    train_logits: Callable[..., Any]     # (params, batch) -> (logits, aux)
    train_hidden: Callable[..., Any]     # (params, batch) -> (hidden, aux)
    head: Callable[..., Any]             # (params, hidden) -> logits
    init_cache: Callable[..., Any]       # (batch, max_len, [enc_len,] device="cuda") -> cache
    cache_axes: Callable[[Any], Any]     # cache -> logical axes tree
    prefill: Callable[..., Any]          # (params, batch, cache) -> (logits, cache)
    decode_step: Callable[..., Any]      # (params, token, cache, pos) -> ...


def get_model(cfg: ModelConfig) -> ModelBundle:
    """The bundle of ``cfg``.  The enc-dec bundle's ``init_cache`` takes
    ``enc_len``, the rows of the cache's ``enc_out`` entry, ``max_len`` by
    default."""
    if cfg.is_encdec:
        return ModelBundle(
            cfg=cfg,
            init=lambda generator, device="cuda": ed.init_params_encdec(cfg, generator, device),
            param_axes=lambda p: ed.param_axes_encdec(cfg, p),
            train_logits=lambda p, batch: ed.forward_train_encdec(
                cfg, p, batch["frames"], batch["tokens"]),
            train_hidden=lambda p, batch: ed.forward_hidden_encdec(
                cfg, p, batch["frames"], batch["tokens"]),
            head=lambda p, h: tf.lm_logits(cfg, p, h),
            init_cache=lambda batch, max_len, enc_len=None, device="cuda": ed.init_cache_encdec(
                cfg, batch, max_len, enc_len or max_len, device),
            cache_axes=lambda c: ed.cache_axes_encdec(cfg, c),
            prefill=lambda p, batch, cache: ed.prefill_encdec(
                cfg, p, batch["frames"], batch["tokens"], cache),
            decode_step=lambda p, tok, cache, pos: ed.decode_step_encdec(
                cfg, p, tok, cache, pos),
        )
    for seg in tf.segments(cfg):
        for kind, _ in seg.unit:
            tf.check_kind(kind)
    return ModelBundle(
        cfg=cfg,
        init=lambda generator, device="cuda": tf.init_params(cfg, generator, device),
        param_axes=lambda p: tf.param_axes(cfg, p),
        train_logits=lambda p, batch: tf.forward_train(
            cfg, p, batch["tokens"], inputs_embeds=batch.get("inputs_embeds")),
        train_hidden=lambda p, batch: tf.forward_hidden(
            cfg, p, batch["tokens"], inputs_embeds=batch.get("inputs_embeds")),
        head=lambda p, h: tf.lm_logits(cfg, p, h),
        init_cache=lambda batch, max_len, device="cuda": tf.init_cache(
            cfg, batch, max_len, device),
        cache_axes=lambda c: tf.cache_axes(cfg, c),
        prefill=lambda p, batch, cache: tf.prefill(
            cfg, p, batch["tokens"], cache, inputs_embeds=batch.get("inputs_embeds")),
        decode_step=lambda p, tok, cache, pos: tf.decode_step(cfg, p, tok, cache, pos),
    )


# --------------------------------------------------------------- param count
def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    D, V, H, KV = cfg.d_model, cfg.vocab, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    total = V * D  # embedding
    if not cfg.tie_embeddings:
        total += D * V

    def attn_p() -> int:
        return D * H * hd + 2 * D * KV * hd + H * hd * D

    def mla_p() -> int:
        qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
        rd, nd, vd = cfg.qk_rope_head_dim, cfg.qk_nope_head_dim, cfg.v_head_dim
        return (D * qr + qr * H * (nd + rd) + D * (kvr + rd)
                + kvr * H * (nd + vd) + H * vd * D)

    def mlp_p() -> int:
        return (3 if cfg.mlp_kind == "swiglu" else 2) * D * cfg.d_ff

    def moe_p(active: bool) -> int:
        E, K, Fe = cfg.n_experts, cfg.top_k, cfg.expert_d_ff
        routed = (K if active else E) * 3 * D * Fe
        shared = cfg.n_shared_experts * 3 * D * Fe
        return D * E + routed + shared

    def rglru_p() -> int:
        W = cfg.lru_width
        return 3 * D * W + cfg.conv_width * W + 5 * W

    def rwkv_p() -> int:
        sl, dl = cfg.rwkv_shift_lora, cfg.rwkv_decay_lora
        time = 5 * D * D + D * 5 * sl + 5 * sl * D + D * dl + dl * D
        ffn = 2 * D * cfg.d_ff + D * D
        return time + ffn

    for i, kind in enumerate(cfg.blocks()):
        if kind == "attn":
            total += attn_p()
        elif kind == "mla":
            total += mla_p()
        elif kind == "rglru":
            total += rglru_p()
        elif kind == "rwkv":
            total += rwkv_p()
            continue  # rwkv includes its ffn
        if cfg.layer_uses_moe(i):
            total += moe_p(active_only)
        else:
            total += mlp_p()
    if cfg.is_encdec:
        total += cfg.enc_layers * (attn_p() + mlp_p())
        total += cfg.n_layers * attn_p()  # cross-attention stacks
    if cfg.mtp:
        total += 2 * D * D + attn_p() + mlp_p()
    return int(total)
