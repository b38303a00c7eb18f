"""Mixture-of-Experts with scatter-based dispatch, as ``repro.models.moe``
has it.

Position-in-expert comes from a cumsum over a (tokens, E) one-hot, tokens
are scattered into per-expert capacity buffers, the experts run as one
stacked SwiGLU, and the results gather back with the routing weights.
Capacity overflow drops routes (a dropping MoE, ``capacity_factor``
configurable); a dropped route falls through via the residual connection.

Shapes (per layer):
  x        (B, S, D)
  router   (D, E), f32
  experts  w_gate/w_up (E, D, F), w_down (E, F, D)
  buffers  (E, B, C+1, D) with C = ceil(S·top_k·cf / E), slot C the
           overflow bin                           [B = dispatch groups]

The JAX package lays the buffers out (B, E, C+1, D) and slices the overflow
bin off before the experts; the port keeps the experts first, so that the
stacked SwiGLU is three batched matmuls over the experts with no copy, and
runs the experts over the bin too: what lands there is masked out at the
combine, exactly as JAX's zeroed bin is.  The expert-parallel form
(``moe_impl="ep"``) is :mod:`.moe_ep`.  The JAX package's ``shard``
annotations are not threaded into the port's models: ``shard`` exists
(``repro_torch.distributed.sharding``), and only a DTensor forward would
read it.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .layers import Params, mlp_swiglu


def capacity(cfg: ModelConfig, seq: int) -> int:
    c = math.ceil(seq * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(1, c)


def router_logits(p: Params, x: torch.Tensor) -> torch.Tensor:
    """(B, S, E) f32: bf16 ``x`` against the f32 router, an f32 product (JAX
    promotes the mixed einsum to f32)."""
    return x.float() @ p["router"].float()


def route(cfg: ModelConfig, logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top-k routes of every token: weights (B, S, K) f32, normalised
    with the 1e-9 floor, and experts (B, S, K) int64, by falling gate.

    ``jax.lax.top_k`` breaks ties toward the lower index; ``torch.topk`` does
    not promise an order among equal values, so the port takes the first K of
    a stable descending sort, which keeps equal gates in index order."""
    gates = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[..., :cfg.top_k], top_e[..., :cfg.top_k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return top_w, top_e


def positions(top_e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """(B, S, K) position of each route in its expert's buffer: the routes
    to that expert from earlier tokens of the row, plus those from earlier
    choices of the same token.  (PyTorch's integer cumsum is int64, where
    JAX's is int32; the values are equal.)"""
    k_onehot = F.one_hot(top_e, n_experts)                  # (B, S, K, E)
    sel = k_onehot.sum(dim=2)                               # (B, S, E)
    pos_base = torch.cumsum(sel, dim=1) - sel               # tokens before s, per e
    intra = torch.cumsum(k_onehot, dim=2) - k_onehot        # earlier choices of s
    return (torch.gather(pos_base, 2, top_e)
            + torch.gather(intra, 3, top_e[..., None])[..., 0])


def _expert_ffn(blocks: torch.Tensor, p: Params) -> torch.Tensor:
    """blocks (E, N, D) -> (E, N, D): each expert's SwiGLU over its rows."""
    h = torch.bmm(blocks, p["w_gate"])
    u = torch.bmm(blocks, p["w_up"])
    h = F.silu(h.float()).to(blocks.dtype) * u
    return torch.bmm(h, p["w_down"])


def _shared(p: Params, x: torch.Tensor) -> torch.Tensor:
    return mlp_swiglu(x, {"w_gate": p["shared_w_gate"], "w_up": p["shared_w_up"],
                          "w_down": p["shared_w_down"]})


def _combine(out_buf: torch.Tensor, top_e, b_idx, slot, keep,
             top_w: torch.Tensor) -> torch.Tensor:
    """Gather each route's expert output (B, S, K, D), zero the dropped ones
    (those in the overflow bin), and sum over the K routes at their weights.

    Under autograd the bin gets an exactly zero cotangent through the mask,
    so the duplicate writes into it pass none back to ``x``, as JAX's sliced
    off bin passes none."""
    gathered = out_buf[top_e, b_idx, slot]                  # (B, S, K, D)
    gathered = torch.where(keep[..., None], gathered,
                           torch.zeros((), dtype=out_buf.dtype, device=out_buf.device))
    # a bf16 contraction over K: exact f32 products, an f32 sum, one rounding
    return torch.einsum("bskd,bsk->bsd", gathered.float(), top_w.float()).to(out_buf.dtype)


def moe_block(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = capacity(cfg, S)

    # ---- routing ----------------------------------------------------------
    top_w, top_e = route(cfg, router_logits(p, x))
    top_w = top_w.to(x.dtype)
    pos = positions(top_e, E)
    keep = pos < C
    slot = torch.where(keep, pos, C)                        # C = overflow bin

    # ---- dispatch: scatter tokens into (E, B, C+1, D) ----------------------
    # Below capacity every (expert, row, slot) is written by one route; only
    # the overflow bin takes several, whose winner is left to the device
    # (``index_put_`` without accumulate) and which the combine masks out.
    b_idx = torch.arange(B, device=x.device)[:, None, None].expand(B, S, K)
    buf = torch.zeros((E, B, C + 1, D), dtype=x.dtype, device=x.device)
    buf.index_put_((top_e, b_idx, slot), x[:, :, None, :].expand(B, S, K, D))

    # ---- expert compute ----------------------------------------------------
    out_buf = _expert_ffn(buf.view(E, B * (C + 1), D), p).view(E, B, C + 1, D)

    y = _combine(out_buf, top_e, b_idx, slot, keep, top_w)

    # ---- shared experts (DeepSeek) -----------------------------------------
    if cfg.n_shared_experts:
        y = y + _shared(p, x)
    return y


def moe_block_plain(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """``sum_k w_k · FFN_{e_k}(x)`` for every token, with no capacity: for
    each expert, its routed tokens are gathered, run through its SwiGLU and
    added back at their weights.  The same routes and roundings as
    :func:`moe_block` below capacity, and none of its dispatch (positions,
    slots, buffers): the yardstick its tests and the chip run hold it
    against."""
    B, S, D = x.shape
    top_w, top_e = route(cfg, router_logits(p, x))
    top_w = top_w.to(x.dtype)
    xf = x.reshape(B * S, D)
    acc = torch.zeros((B * S, D), dtype=torch.float32, device=x.device)
    flat_e, flat_w = top_e.reshape(B * S, -1), top_w.reshape(B * S, -1)
    for e in range(cfg.n_experts):
        tok, k = torch.nonzero(flat_e == e, as_tuple=True)
        if tok.numel():
            w = {name: p[name][e] for name in ("w_gate", "w_up", "w_down")}
            out = mlp_swiglu(xf[tok], w)
            acc.index_add_(0, tok, out.float() * flat_w[tok, k].float()[:, None])
    y = acc.to(x.dtype).reshape(B, S, D)
    if cfg.n_shared_experts:
        y = y + _shared(p, x)
    return y


def aux_load_balance_loss(cfg: ModelConfig, logits_f32: torch.Tensor,
                          top_e: torch.Tensor) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss (for the train loop)."""
    E = cfg.n_experts
    gates = torch.softmax(logits_f32, dim=-1)
    me = gates.mean(dim=(0, 1))
    ce = F.one_hot(top_e[..., 0], E).float().mean(dim=(0, 1))
    return E * torch.sum(me * ce)
