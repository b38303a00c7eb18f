"""Decoder LM spine, as ``repro.models.transformer`` has it: GQA, MLA,
RG-LRU and RWKV-6 blocks.

Layers are partitioned into **segments**: maximal runs of a repeating unit
(e.g. RecurrentGemma's (rglru, rglru, attn) triple, DeepSeek's 3 dense + 58
MoE split).  Each segment stacks its
parameters over the repeat axis, exactly as the JAX package's parameter tree
does (``params["segments"][i][j][name]`` has the repeat count first); where
JAX scans a segment, the port loops over the stack index in Python.  In
training (``mode="train"`` under autograd) each layer runs inside
``torch.utils.checkpoint``, the JAX package's default ``full`` remat policy:
only each layer's input is kept, and the layer is recomputed in the backward
pass.  An MoE layer routes again in its recompute, on the same input, and so
takes the same experts; the checkpoint compares shapes only, so the tests
hold the gradients bit for bit against a run without remat, and the chip
smoke run compares each recompute's routes with its forward's.  The
recurrent layers train under the same checkpoint: an ``rglru`` or ``rwkv``
layer starts from a zero state and writes none (``models.recurrent``), so
its recompute is a pure function of its input and parameters, and
RecurrentGemma's windowed ``attn`` layers train through
``gqa_forward(window=)``, the block-local softmax, as the JAX package's
training does.  ``REPRO_REMAT_POLICY``, read at each train-mode call as
the JAX package reads it when it traces, picks what the checkpoint keeps:
``dots`` also saves the outputs of the contractions with no batch dimension
(:func:`dots_policy`, JAX's ``dots_with_no_batch_dims_saveable``: the
products against a weight, which reach ``aten.mm`` through ``matmul``'s
fold, but for the one whose output the backward never reads), so the
backward recomputes only the rest; any other value is the whole-layer
``full``.  The saved products are the ones the recompute would make, so the
gradients are the same bits either way.

Block kinds: ``attn`` (GQA, with ``cfg.attn_window`` a sliding window),
``mla`` (DeepSeek) and ``rglru`` (Griffin), each paired with an MLP or an
MoE (``cfg.layer_uses_moe``), and ``rwkv`` (RWKV-6), which carries its own
channel mix.  With ``cfg.mtp`` the tree has DeepSeek's
multi-token-prediction head (``mtp``), whose hidden states the forward pass
returns in its aux; its block runs outside the per-layer remat, as in the
JAX package.  Under ``cfg.moe_impl == "ep"`` an MoE layer runs the
expert-parallel block (:mod:`.moe_ep`), which needs an active
``logical_sharding(mesh)`` and without one runs the dispatch.

:func:`param_axes` and :func:`cache_axes` give the parameter and cache trees'
logical axes (``repro_torch.distributed.sharding``), the JAX package's.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..configs.base import ModelConfig
from ..kernels import resolve_device
from ..tree import tree_map
from . import attention as attn_lib
from . import moe as moe_lib
from . import moe_ep as moe_ep_lib
from . import recurrent as rec_lib
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


def check_kind(kind: str) -> None:
    """Raise ``ValueError`` for an unknown block kind."""
    if kind not in ("attn", "mla", "rglru", "rwkv"):
        raise ValueError(kind)


# ---------------------------------------------------------------- block init
DRAW_CHUNK = 1 << 26  # elements drawn at a time: a leaf's f32 draw stays small


def _nrm(gen: torch.Generator, shape, std, device, dtype=torch.bfloat16) -> torch.Tensor:
    """Normal(0, std) in ``dtype``, drawn in f32 ``DRAW_CHUNK`` elements at a
    time, so that a leaf of billions of elements (DeepSeek's stacked experts)
    never holds an f32 copy of itself; a smaller leaf is one draw."""
    out = torch.empty(shape, dtype=dtype, device=device)
    flat = out.view(-1)
    for i in range(0, flat.numel(), DRAW_CHUNK):
        n = min(DRAW_CHUNK, flat.numel() - i)
        flat[i:i + n] = (torch.randn(n, generator=gen, dtype=torch.float32, device=device)
                         * std).to(dtype)
    return out


def block_spec(cfg: ModelConfig, kind: str, use_moe: bool,
               *, repeats: Optional[int] = None) -> Dict[str, Any]:
    """One block's parameters as ``name -> (shape, init, dtype)``; ``repeats``
    of them stacked on a leading axis.  ``init`` is a std (normal), None
    (zeros: the norm scales, biases), ``"ones"`` or ``"uniform"`` (U(0, 1):
    the RG-LRU's Λ).  The shapes, inits and dtypes are those of the JAX
    package's ``block_init``: bf16, but for the MoE router's and the
    recurrent blocks' vectors, f32."""
    check_kind(kind)
    D, H, KV = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    std = 0.02
    out_std = std / max(1, cfg.n_layers) ** 0.5
    lead = () if repeats is None else (repeats,)
    bf16 = torch.bfloat16

    def leaf(shape, s=None, dtype=bf16):
        return (lead + tuple(shape), s, dtype)

    spec: Dict[str, Any] = {"norm1": leaf((D,))}
    f32 = torch.float32
    if kind == "rwkv":  # no separate MLP: the channel mix is part of the block
        sl, dl = cfg.rwkv_shift_lora, cfg.rwkv_decay_lora
        spec.update(
            norm2=leaf((D,)),
            mu_x=leaf((D,), std, f32), mu_rkvwg=leaf((5, D), std, f32),
            shift_w1=leaf((D, 5 * sl), std), shift_w2=leaf((5, sl, D), std),
            w_r=leaf((D, D), std), w_k=leaf((D, D), std), w_v=leaf((D, D), std),
            w_g=leaf((D, D), std), w_o=leaf((D, D), out_std),
            w0=leaf((D,), std, f32), decay_w1=leaf((D, dl), std), decay_w2=leaf((dl, D), std),
            u=leaf((D,), std, f32), ln_x_scale=leaf((D,), "ones", f32),
            ln_x_bias=leaf((D,), None, f32),
            ffn_mu_k=leaf((D,), std, f32), ffn_mu_r=leaf((D,), std, f32),
            ffn_k=leaf((D, cfg.d_ff), std), ffn_v=leaf((cfg.d_ff, D), std),
            ffn_r=leaf((D, D), std),
        )
        return spec
    if kind == "rglru":
        W, K = cfg.lru_width, cfg.conv_width
        spec.update(
            w_rec_in=leaf((D, W), std), w_gate_in=leaf((D, W), std), w_out=leaf((W, D), std),
            conv_w=leaf((K, W), std),
            a_gate=leaf((W,), std, f32), a_gate_bias=leaf((W,), None, f32),
            i_gate=leaf((W,), std, f32), i_gate_bias=leaf((W,), None, f32),
            **{"lambda": leaf((W,), "uniform", f32)},
        )
    elif kind == "attn":
        spec.update(wq=leaf((D, H, hd), std), wk=leaf((D, KV, hd), std),
                    wv=leaf((D, KV, hd), std), wo=leaf((H, hd, D), out_std))
        if cfg.qk_norm:
            spec["q_norm"] = leaf((hd,))
            spec["k_norm"] = leaf((hd,))
    else:  # mla
        qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
        rd, nd, vd = cfg.qk_rope_head_dim, cfg.qk_nope_head_dim, cfg.v_head_dim
        spec.update(
            wq_a=leaf((D, qr), std), q_norm=leaf((qr,)), wq_b=leaf((qr, H, nd + rd), std),
            wkv_a=leaf((D, kvr + rd), std), kv_norm=leaf((kvr,)),
            wkv_b=leaf((kvr, H, nd + vd), std), wo=leaf((H, vd, D), out_std),
        )
    spec["norm2"] = leaf((D,))
    if use_moe:
        E, Fe = cfg.n_experts, cfg.expert_d_ff
        spec["moe"] = {
            "router": leaf((D, E), std, torch.float32),
            "w_gate": leaf((E, D, Fe), std),
            "w_up": leaf((E, D, Fe), std),
            "w_down": leaf((E, Fe, D), out_std),
        }
        if cfg.n_shared_experts:
            Fs = Fe * cfg.n_shared_experts
            spec["moe"].update(shared_w_gate=leaf((D, Fs), std),
                               shared_w_up=leaf((D, Fs), std),
                               shared_w_down=leaf((Fs, D), std))
        return spec
    F = cfg.d_ff
    if cfg.mlp_kind == "swiglu":
        spec["mlp"] = {"w_gate": leaf((D, F), std), "w_up": leaf((D, F), std),
                       "w_down": leaf((F, D), out_std)}
    else:
        spec["mlp"] = {"w_in": leaf((D, F), std), "w_out": leaf((F, D), out_std)}
    return spec


def _spec_map(fn, spec: Any) -> Any:
    """``fn`` applied to every ``(shape, init, dtype)`` leaf of a spec, in its
    insertion order (the order the leaves are drawn in)."""
    if isinstance(spec, dict):
        return {k: _spec_map(fn, v) for k, v in spec.items()}
    if isinstance(spec, list):
        return [_spec_map(fn, v) for v in spec]
    return fn(*spec)


def _draw_leaf(shape, init, dtype, generator: torch.Generator, device) -> torch.Tensor:
    if init is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if init == "uniform":
        return torch.rand(shape, generator=generator, dtype=dtype, device=device)
    return _nrm(generator, shape, init, device, dtype)


def _draw(spec: Any, generator: torch.Generator, device) -> Any:
    """A spec's leaves drawn on ``device`` (:func:`block_spec`'s inits)."""
    return _spec_map(lambda shape, init, dtype: _draw_leaf(shape, init, dtype, generator,
                                                           device), spec)


def block_init(cfg: ModelConfig, kind: str, use_moe: bool, generator: torch.Generator,
               *, repeats: Optional[int] = None, device="cuda") -> Params:
    """One block's parameters (:func:`block_spec`), or ``repeats`` of them
    stacked on a leading axis, drawn on ``device`` from ``generator`` (a
    generator of that device)."""
    return _draw(block_spec(cfg, kind, use_moe, repeats=repeats), generator, device)


_AXES_BY_NAME = {
    "norm1": (None,), "norm2": (None,), "q_norm": (None,), "k_norm": (None,),
    "kv_norm": (None,),
    "wq": ("embed", "heads", None), "wk": ("embed", "kv_heads", None),
    "wv": ("embed", "kv_heads", None), "wo": ("heads", None, "embed"),
    "wq_a": ("embed", None), "wq_b": (None, "heads", None),
    "wkv_a": ("embed", None), "wkv_b": (None, "heads", None),
    "w_rec_in": ("embed", "lru"), "w_gate_in": ("embed", "lru"),
    "w_out": ("lru", "embed"), "conv_w": (None, "lru"),
    "a_gate": ("lru",), "a_gate_bias": ("lru",), "i_gate": ("lru",),
    "i_gate_bias": ("lru",), "lambda": ("lru",),
    "mu_x": (None,), "mu_rkvwg": (None, None),
    "shift_w1": ("embed", None), "shift_w2": (None, None, None),
    "w_r": ("embed", None), "w_k": ("embed", None), "w_v": ("embed", None),
    "w_g": ("embed", None), "w_o": ("embed", None),
    "w0": (None,), "decay_w1": ("embed", None), "decay_w2": (None, None),
    "u": (None,), "ln_x_scale": (None,), "ln_x_bias": (None,),
    "ffn_mu_k": (None,), "ffn_mu_r": (None,),
    "ffn_k": ("embed", "mlp"), "ffn_v": ("mlp", "embed"), "ffn_r": ("embed", None),
    "mlp": {
        "w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
        "w_down": ("mlp", "embed"), "w_in": ("embed", "mlp"),
        "w_out": ("mlp", "embed"),
    },
    "moe": {
        "router": ("embed", None),
        "w_gate": ("experts", "embed", None), "w_up": ("experts", "embed", None),
        "w_down": ("experts", None, "embed"),
        "shared_w_gate": ("embed", "mlp"), "shared_w_up": ("embed", "mlp"),
        "shared_w_down": ("mlp", "embed"),
    },
}


def block_axes(p: Params, *, stacked: bool, moe_impl: str = "dispatch") -> Any:
    """Logical axes tree matching a block's params (optionally +stack dim)."""

    def of(name_path, leaf):
        table = _AXES_BY_NAME
        for name in name_path[:-1]:
            table = table[name]
        axes = table[name_path[-1]]
        if moe_impl == "ep" and name_path[0] == "moe" and axes[0] == "experts":
            # EP: experts over the (data, model) mesh; the inner dim ZeRO-3
            # shards over "pod" and is regathered inside the EP block
            axes = ("experts_ep", "expert_fsdp") + (None,) * (len(axes) - 2)
        return (("stack",) + tuple(axes)) if stacked else tuple(axes)

    out = {}
    for k, v in p.items():
        if isinstance(v, dict):
            out[k] = {k2: of((k, k2), v2) for k2, v2 in v.items()}
        else:
            out[k] = of((k,), v)
    return out


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
    check_kind(kind)
    if kind == "rwkv":  # both sublayers and their norms
        return rec_lib.rwkv_block(cfg, p, x, cache)
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    new_cache: Optional[Dict] = None
    if kind == "attn":
        w = window or cfg.attn_window
        if mode == "train":
            a = attn_lib.gqa_forward(cfg, p, h, window=w)
        elif mode == "prefill":
            a, new_cache = attn_lib.gqa_prefill(cfg, p, h, cache, window=w)
        else:
            a, new_cache = attn_lib.gqa_decode(cfg, p, h, cache, pos, window=w)
    elif kind == "rglru":
        a, new_cache = rec_lib.rglru_block(cfg, p, h, cache)
    elif mode == "train":
        a = attn_lib.mla_forward(cfg, p, h)
    elif mode == "prefill":
        a, new_cache = attn_lib.mla_prefill(cfg, p, h, cache)
    else:
        a, new_cache = attn_lib.mla_decode(cfg, p, h, cache, pos)
    x = x + a
    h2 = rms_norm(x, p["norm2"], cfg.norm_eps)
    if use_moe:
        moe_fn = moe_ep_lib.moe_block_ep if cfg.moe_impl == "ep" else moe_lib.moe_block
        return x + moe_fn(cfg, p["moe"], h2), new_cache
    mlp = mlp_swiglu if cfg.mlp_kind == "swiglu" else mlp_gelu
    return x + mlp(h2, p["mlp"]), new_cache


def block_cache_init(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     *, window: int = 0, device="cuda") -> Dict:
    check_kind(kind)
    if kind == "mla":
        return attn_lib.mla_init_cache(cfg, batch, max_len, device=device)
    if kind == "rglru":
        return rec_lib.rglru_init_state(cfg, batch, device=device)
    if kind == "rwkv":
        return rec_lib.rwkv_init_state(cfg, batch, device=device)
    w = window or (cfg.attn_window if len(cfg.layer_pattern) > 1 else 0)
    return attn_lib.gqa_init_cache(cfg, batch, max_len, window=w, device=device)


# ------------------------------------------------------------------- the LM
def param_spec(cfg: ModelConfig) -> Params:
    """The parameter tree as ``(shape, init, dtype)`` leaves
    (:func:`block_spec`): ``embed``, ``final_norm``, ``lm_head`` unless tied, ``segments``,
    and with ``cfg.mtp`` the MTP head, ``mtp: {proj (2D, D), block}``, whose
    block is of the last layer's kind with a dense MLP."""
    D, V = cfg.d_model, cfg.padded_vocab
    bf16 = torch.bfloat16
    spec: Params = {"embed": ((V, D), 0.02, bf16), "final_norm": ((D,), None, bf16)}
    if not cfg.tie_embeddings:
        spec["lm_head"] = ((D, V), 0.02, bf16)
    spec["segments"] = [
        [block_spec(cfg, kind, use_moe, repeats=seg.repeats) for kind, use_moe in seg.unit]
        for seg in segments(cfg)
    ]
    if cfg.mtp:
        spec["mtp"] = {"proj": ((2 * D, D), 0.02, bf16),
                       "block": block_spec(cfg, cfg.blocks()[-1], False)}
    return spec


def param_shapes(cfg: ModelConfig, dtype: Optional[torch.dtype] = None) -> Params:
    """The parameter tree as ``(shape, dtype)`` leaves, from the shapes
    alone (a restore template that allocates nothing): each leaf's own dtype
    (bf16; the MoE router f32), or ``dtype`` for every leaf (the optimizer
    moments, f32)."""
    return _spec_map(lambda shape, init, own: (shape, dtype or own), param_spec(cfg))


def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda") -> Params:
    """The JAX package's parameter tree (:func:`param_spec`), drawn on
    ``device`` from ``generator``, which must be a generator of that device.
    The shapes, stds and dtypes are JAX's; the random stream is not."""
    return _draw(param_spec(cfg), generator, resolve_device(device))


def param_axes(cfg: ModelConfig, params: Params) -> Any:
    """The logical axes of ``params`` (tensors, or any tree of its
    structure), the JAX package's ``param_axes``."""
    axes: Dict[str, Any] = {
        "embed": ("vocab", "embed"),
        "final_norm": (None,),
    }
    if "lm_head" in params:
        axes["lm_head"] = ("embed", "vocab")
    axes["segments"] = [
        [block_axes(sub, stacked=True, moe_impl=cfg.moe_impl) for sub in seg]
        for seg in params["segments"]
    ]
    if "mtp" in params:
        axes["mtp"] = {
            "proj": ("embed", None),
            "block": block_axes(params["mtp"]["block"], stacked=False,
                                moe_impl=cfg.moe_impl),
        }
    return axes


def _unstack(tree: Any, repeats: int) -> List[Any]:
    """The ``repeats`` layers of a stacked tree (parameters or caches), as
    views made by one ``unbind`` a leaf: writes reach the stack, and under
    autograd the layers' gradients are stacked into the leaf's once, where a
    view per layer would add a zero-filled full-size gradient for each
    layer."""
    if isinstance(tree, dict):
        per_key = {k: _unstack(v, repeats) for k, v in tree.items()}
        return [{k: v[r] for k, v in per_key.items()} for r in range(repeats)]
    return list(torch.unbind(tree))


def _train_block(cfg: ModelConfig, kind: str, use_moe: bool, p: Params,
                 x: torch.Tensor) -> torch.Tensor:
    return block_apply(cfg, kind, use_moe, p, x, mode="train")[0]


#: the products ``dots`` may save: contractions with no batch dimension.
#: The batched ones (the chunked and block-local softmax, the WKV, the MoE's
#: expert stacks and combine) reach ``aten.bmm`` and are recomputed, as JAX
#: recomputes its ``dot_general`` s with batch dimensions.
NO_BATCH_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def unread_products(p: Params) -> frozenset:
    """The weights (by ``data_ptr``) of a layer's products whose outputs its
    backward never reads: the MLP's (or the shared expert's) output
    product, which only the residual add reads.  JAX keeps a saveable value
    only where the backward needs it, and neither package recomputes these."""
    mlp, moe = p.get("mlp") or {}, p.get("moe") or {}
    weights = (mlp.get("w_down"), mlp.get("w_out"), moe.get("shared_w_down"))
    return frozenset(w.data_ptr() for w in weights if w is not None)


def dots_policy(unread: frozenset, ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """Selective-checkpoint policy of ``REPRO_REMAT_POLICY=dots``: save each
    no-batch product that the backward reads (its weight is the last
    operand), recompute everything else."""
    if op in NO_BATCH_PRODUCTS and args[-1].data_ptr() not in unread:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_kwargs(p: Params) -> dict:
    """The checkpoint's arguments for layer ``p`` under the current
    ``REPRO_REMAT_POLICY``: ``dots`` adds its selective context; any other
    value is ``full``."""
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if os.environ.get("REPRO_REMAT_POLICY", "full") == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts,
            functools.partial(dots_policy, unread_products(p)))
    return kw


def _run_segments(cfg: ModelConfig, params: Params, x: torch.Tensor, *,
                  mode: str, caches=None, pos: int = 0):
    remat = mode == "train" and torch.is_grad_enabled()
    for si, seg in enumerate(segments(cfg)):
        p_units = [_unstack(p, seg.repeats) for p in params["segments"][si]]
        c_units = ([_unstack(c, seg.repeats) for c in caches[si]] if caches is not None
                   else None)
        for r in range(seg.repeats):
            for j, (kind, use_moe) in enumerate(seg.unit):
                if remat:
                    p = p_units[j][r]
                    x = checkpoint(_train_block, cfg, kind, use_moe, p, x, **remat_kwargs(p))
                    continue
                x, _ = block_apply(
                    cfg, kind, use_moe, p_units[j][r], x, mode=mode,
                    cache=c_units[j][r] if c_units is not None else None,
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
    """Final hidden states (B, S, D) and aux: with an MTP head,
    ``mtp_hidden`` (B, S - 1, D), the head's hidden states for token t + 2
    from (h_t, emb(token_{t+1}))."""
    x = inputs_embeds if inputs_embeds is not None else embed_tokens(cfg, params, tokens)
    x, _ = _run_segments(cfg, params, x, mode="train")
    aux = {}
    if cfg.mtp and "mtp" in params:
        emb_next = embed_tokens(cfg, params, tokens)[:, 1:]
        h_mtp = torch.cat([x[:, :-1], emb_next], dim=-1) @ params["mtp"]["proj"]
        h_mtp, _ = block_apply(cfg, cfg.blocks()[-1], False, params["mtp"]["block"], h_mtp,
                               mode="train")
        aux["mtp_hidden"] = h_mtp
    return x, aux


def forward_train(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
                  inputs_embeds: Optional[torch.Tensor] = None):
    """Teacher-forcing logits (B, S, V) and aux (``mtp_logits`` with an MTP
    head); tokens (B, S) integer."""
    x, aux_h = forward_hidden(cfg, params, tokens, inputs_embeds=inputs_embeds)
    aux = {}
    if "mtp_hidden" in aux_h:
        aux["mtp_logits"] = lm_logits(cfg, params, aux_h["mtp_hidden"])
    return lm_logits(cfg, params, x), aux


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda") -> list:
    """Per segment, per unit position, the cache stacked over the repeats."""
    device = resolve_device(device)
    caches = []
    for seg in segments(cfg):
        seg_caches = []
        for (kind, _moe) in seg.unit:
            one = block_cache_init(cfg, kind, batch, max_len, device=device)
            seg_caches.append(tree_map(
                lambda t: torch.zeros((seg.repeats,) + tuple(t.shape), dtype=t.dtype,
                                      device=device), one))
        caches.append(seg_caches)
    return caches


def cache_axes(cfg: ModelConfig, cache: list) -> Any:
    """Logical axes for the decode cache, the JAX package's: KV tensors
    shard over batch (and kv heads where divisible); recurrent states over
    batch only.  A leaf is named by its last dict key and its rank."""

    def walk(node: Any, last: Optional[str]) -> Any:
        if isinstance(node, dict):
            return {k: walk(v, str(k)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, last) for v in node)
        if node is None:
            return None
        nd = len(node.shape)
        if last in ("k", "v") and nd == 5:       # (stack, B, S, KV, hd)
            axes = ("stack", "batch", "kv_seq", "kv_heads", None)
        elif last == "ckv" and nd == 4:          # (stack, B, S, latent)
            axes = ("stack", "batch", "kv_seq", None)
        else:                                     # recurrent states
            axes = tuple(["stack", "batch"] + [None] * (nd - 2))
        return axes[:nd]

    return walk(cache, None)


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
