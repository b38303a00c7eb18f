"""Expert-parallel MoE over all-to-all, as ``repro.models.moe_ep`` has it:
experts stationary, tokens move.

Layout, over the active ``logical_sharding`` mesh (axes among "pod",
"data", "model", in that order):

* the MoE's input ``x`` (B, S, D) arrives whole on every rank (the port's
  model runs replicated outside the MoE); each rank takes its block at its
  mesh coordinate, batch over ("pod", "data") and sequence over "model", so
  all ranks hold distinct tokens;
* expert weights are split E -> the EP axes, ("data", "model") when E
  divides data x model, else ("model",) (:func:`ep_axes_for`); with a
  "pod" axis outside the EP group their inner dim is also split over "pod"
  at rest and all-gathered per layer;
* local routing -> per-expert staging (E, c_loc, D) -> ``all_to_all`` over
  the EP group -> the local experts' SwiGLU -> ``all_to_all`` back -> local
  combine -> an all-gather of every rank's block, so each rank returns the
  whole ``y``, the global array the JAX package's ``shard_map`` returns.

EP rank r is the rank at row-major index r over the EP axes (the first axis
outermost, as JAX indexes a tuple of axes) and owns experts
``[r * e_loc, (r + 1) * e_loc)``.  ``B`` must divide by the data-parallel
size and ``S`` by the model axis, as ``shard_map`` requires; so decode
(S = 1) on a mesh whose model axis is larger than 1 raises.

The arithmetic is the JAX module's, which differs from :mod:`.moe`'s
dispatch: the router is cast to ``x``'s dtype before the product, so the
logits are a bf16 product turned into f32 (:func:`router_logits`); the
routes are :func:`moe.route`'s (a stable sort, so ``jax.lax.top_k``'s tie
order; the 1e-9 floor), cast to ``x``'s dtype; the capacity is counted over
a rank's tokens, ``c_loc = max(1, ceil(t_loc * K * cf / E))``; the combine
sums in f32 and rounds once to ``x``'s dtype.  With no mesh, or no axis
group that E divides, the block is the dispatch (``moe.moe_block``), the
JAX module's own rule.

The collectives are autograd functions, so ``make_train_step`` runs
``moe_impl="ep"``: an all-to-all's adjoint is the all-to-all back; the pod
all-gather's a reduce-scatter (sum).  The gradients are the global ones on
every rank: the adjoint of taking a block of a replicated tensor (``x``,
the router, a whole expert stack) all-reduces the zero-padded block
gradients over the mesh; a DTensor expert block's gradient is summed over
the mesh axes outside the EP group and "pod" (the data rows that hold the
same experts), as the JAX transpose psums an input over its unmentioned
axes; and the adjoint of the output all-gather takes the rank's block of
the cotangent, which is the same on every rank (a reduce-scatter would
count it once a rank).  Every collective the path issues is counted where
it is issued, as a kernel wrapper counts launches: ``all_to_all.calls``,
``all_gather.calls`` (the pod gather's reduce-scatter among them),
``all_reduce.calls``.  The process groups and this rank's coordinate are
resolved once a mesh.
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..distributed import sharding as shlib
from . import moe as moe_lib

Params = Dict[str, Any]
MESH_AXES = ("pod", "data", "model")


def ep_axes_for(cfg: ModelConfig, mesh) -> Optional[Tuple[str, ...]]:
    """Largest mesh-axis group the expert dim divides; None => fall back."""
    shape = shlib.mesh_shape(mesh)
    names = tuple(shape)
    dm = tuple(a for a in ("data", "model") if a in names)
    size_dm = 1
    for a in dm:
        size_dm *= shape[a]
    if dm and cfg.n_experts % size_dm == 0:
        return dm
    if "model" in names and cfg.n_experts % shape["model"] == 0:
        return ("model",)
    return None


def router_logits(p: Params, x: torch.Tensor) -> torch.Tensor:
    """(..., E) f32: ``x`` against the router cast to ``x``'s dtype, a
    product in that dtype turned into f32, as the JAX module computes it."""
    return (x @ p["router"].to(x.dtype)).float()


# ------------------------------------------------------------- collectives
def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    all_to_all.calls += 1
    x = x.contiguous()  # empty_like keeps a transposed input's strides
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n = dist.get_world_size(group)
        buf = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        all_gather.calls += 1
        dist.all_gather_into_tensor(buf, x.contiguous(), group=group)
        return torch.cat(buf.chunk(n), dim=dim)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        chunks = torch.cat(g.chunk(n, dim=ctx.dim))
        out = g.new_empty((chunks.shape[0] // n,) + tuple(chunks.shape[1:]))
        all_gather.calls += 1
        dist.reduce_scatter_tensor(out, chunks, op=dist.ReduceOp.SUM, group=ctx.group)
        return out, None, None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (n, ...); chunk i goes to group rank i, and the result's chunk j
    came from group rank j.  The adjoint is the all-to-all back."""
    return _AllToAll.apply(x, group)


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's blocks of ``x`` concatenated along ``dim`` in group-rank
    order; the adjoint reduce-scatters (sums)."""
    return _AllGather.apply(x, group, dim)


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed in place over ``group`` (the adjoint of taking a block)."""
    all_reduce.calls += 1
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


all_to_all.calls = all_gather.calls = all_reduce.calls = 0


class _TakeBlock(torch.autograd.Function):
    """This rank's block ``x[idx]`` of a tensor that every rank holds whole.
    The adjoint all-reduces the zero-padded block gradients over ``group``,
    so every rank gets the whole tensor's gradient; over a group of one
    rank it passes the gradient through."""

    @staticmethod
    def forward(ctx, x, idx, group):
        ctx.idx, ctx.group, ctx.shape = idx, group, x.shape
        return x[idx]

    @staticmethod
    def backward(ctx, g):
        if dist.get_world_size(ctx.group) == 1:
            return g, None, None
        full = g.new_zeros(ctx.shape)
        full[ctx.idx] = g
        return all_reduce(full, ctx.group), None, None


class _GatherOut(torch.autograd.Function):
    """Every rank's (b_loc, s_loc, D) block assembled into the whole
    (B, S, D) on every rank; the adjoint takes this rank's block of the
    cotangent, which is the same on every rank."""

    @staticmethod
    def forward(ctx, y, group, sizes, idx):
        ctx.idx = idx
        n_dp, n_seq = sizes
        buf = y.new_empty((n_dp * n_seq * y.shape[0],) + tuple(y.shape[1:]))
        all_gather.calls += 1
        dist.all_gather_into_tensor(buf, y.contiguous(), group=group)
        b, s, d = y.shape
        return (buf.view(n_dp, n_seq, b, s, d).permute(0, 2, 1, 3, 4)
                .reshape(n_dp * b, n_seq * s, d))

    @staticmethod
    def backward(ctx, g):
        return g[ctx.idx].contiguous(), None, None, None


def _row_major(coord: Dict[str, int], shape: Dict[str, int], axes: Sequence[str]) -> int:
    idx = 0
    for a in axes:
        idx = idx * shape[a] + coord[a]
    return idx


@dataclasses.dataclass(frozen=True)
class _Layout:
    """What :func:`moe_block_ep` needs of a mesh for one EP axis group:
    properties of the mesh, not of the call."""

    shape: Dict[str, int]
    coord: Dict[str, int]
    ep_group: Any
    mesh_group: Any
    pod_group: Any    # the pod all-gather's, when "pod" is outside the EP group
    rest_group: Any   # the axes outside the EP group and "pod", if any


_LAYOUTS: Dict[Tuple[int, Tuple[str, ...]], Tuple[Any, _Layout]] = {}


def _layout(mesh, ep: Tuple[str, ...]) -> _Layout:
    """The process groups and this rank's coordinate, resolved and checked
    once for each (mesh, EP axes)."""
    hit = _LAYOUTS.get((id(mesh), ep))
    if hit is not None and hit[0]() is mesh:
        return hit[1]
    if isinstance(mesh, shlib.AbstractMesh):
        raise ValueError("moe_block_ep runs collectives: it needs a DeviceMesh, not an "
                         "AbstractMesh")
    shape = shlib.mesh_shape(mesh)
    names = tuple(shape)
    if names != tuple(a for a in MESH_AXES if a in names):
        raise ValueError(f"moe_block_ep takes mesh axes among {MESH_AXES}, in that order, "
                         f"not {names}")
    coord_list = mesh.get_coordinate()
    if coord_list is None:
        raise ValueError("this rank is not in the mesh")
    coord = dict(zip(names, coord_list))
    rest = tuple(a for a in names if a not in ep and a != "pod")
    lay = _Layout(shape, coord, shlib.axis_group(mesh, ep), shlib.axis_group(mesh, names),
                  shlib.axis_group(mesh, "pod") if "pod" in names else None,
                  shlib.axis_group(mesh, rest) if rest else None)
    if (dist.get_rank(lay.ep_group) != _row_major(coord, shape, ep)
            or dist.get_rank(lay.mesh_group) != _row_major(coord, shape, names)):
        raise RuntimeError("the mesh's process groups do not rank their members row-major "
                           "over the mesh coordinate")
    _LAYOUTS[(id(mesh), ep)] = (weakref.ref(mesh), lay)
    return lay


def _expert_block(w: Any, idx: tuple, lay: _Layout, want: tuple) -> torch.Tensor:
    """This rank's block of an expert stack: a DTensor's local tensor (its
    placements are ``param_axes``'s; its gradient summed over the data rows
    that hold the same block), or ``idx`` of a whole tensor."""
    from torch.distributed.tensor import DTensor

    if isinstance(w, DTensor):
        local = w.to_local()
        if lay.rest_group is not None:
            local = _TakeBlock.apply(local, (), lay.rest_group)
    else:
        local = _TakeBlock.apply(w, idx, lay.mesh_group)
    if tuple(local.shape) != want:
        raise ValueError(f"an expert block of shape {tuple(local.shape)}, not {want}: a "
                         "DTensor must be placed by param_axes(moe_impl='ep')")
    return local


def moe_block_ep(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Drop-in replacement for ``moe.moe_block`` with explicit EP
    collectives over the active ``logical_sharding`` mesh.  ``x`` is the
    whole (B, S, D), the same on every rank, and so is the result.  The
    shared experts run outside, on the whole ``x``."""
    mesh = shlib.active_mesh()
    if mesh is None:
        return moe_lib.moe_block(cfg, p, x)  # no mesh: the dispatch
    ep = ep_axes_for(cfg, mesh)
    if ep is None:  # an arch whose E fits no axis: the dispatch
        return moe_lib.moe_block(cfg, p, x)
    lay = _layout(mesh, ep)
    shape, coord = lay.shape, lay.coord

    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    n_ep = 1
    for a in ep:
        n_ep *= shape[a]
    e_loc = E // n_ep
    dp = tuple(a for a in ("pod", "data") if a in shape)
    seq_ax = "model" if "model" in shape else None
    pod_fsdp = "pod" in shape and "pod" not in ep
    n_dp = 1
    for a in dp:
        n_dp *= shape[a]
    n_seq = shape["model"] if seq_ax else 1
    if B % n_dp or S % n_seq:
        raise ValueError(f"moe_block_ep: batch {B} must divide by the data-parallel size "
                         f"{n_dp} {dp} and sequence {S} by the model axis {n_seq}")
    b_loc, s_loc = B // n_dp, S // n_seq
    t_loc = b_loc * s_loc
    c_loc = max(1, math.ceil(t_loc * K * cfg.capacity_factor / E))

    ep_idx = _row_major(coord, shape, ep)
    dp_idx = _row_major(coord, shape, dp)
    s_idx = coord["model"] if seq_ax else 0
    blk = (slice(dp_idx * b_loc, (dp_idx + 1) * b_loc),
           slice(s_idx * s_loc, (s_idx + 1) * s_loc))

    xb = _TakeBlock.apply(x, blk, lay.mesh_group)               # (b_loc, s_loc, D)
    router = {"router": _TakeBlock.apply(p["router"], (), lay.mesh_group)}
    n_pod = shape["pod"] if pod_fsdp else 1
    e_sl = slice(ep_idx * e_loc, (ep_idx + 1) * e_loc)
    ws = []
    for name in ("w_gate", "w_up", "w_down"):
        inner = p[name].shape[1] // n_pod
        idx = (e_sl,)
        if pod_fsdp:  # ZeRO-3: this rank's slice of the inner dim at rest
            idx += (slice(coord["pod"] * inner, (coord["pod"] + 1) * inner),)
        w = _expert_block(p[name], idx, lay, (e_loc, inner, p[name].shape[2]))
        if pod_fsdp:  # regather this layer's experts over the pod axis
            w = all_gather(w, lay.pod_group, 1)
        ws.append(w)
    wg, wu, wd = ws

    xt = xb.reshape(t_loc, D)
    top_w, top_e = moe_lib.route(cfg, router_logits(router, xb))  # (b_loc, s_loc, K)
    top_w = top_w.to(x.dtype).reshape(t_loc, K)

    # position-in-expert over the flat (T*K) routing decisions
    flat_e = top_e.reshape(-1)                                  # (T*K,)
    onehot = F.one_hot(flat_e, E)                               # (T*K, E)
    pos = torch.cumsum(onehot, dim=0) - onehot                  # before me, per e
    slot = torch.gather(pos, 1, flat_e[:, None])[:, 0]
    keep = slot < c_loc
    slot = torch.where(keep, slot, c_loc)                       # overflow bin

    # stage tokens per destination expert: (E, c_loc + 1, D), the bin cut off
    tok_idx = torch.arange(t_loc, device=x.device).repeat_interleave(K)
    staging = x.new_zeros((E, c_loc + 1, D)).index_put((flat_e, slot), xt[tok_idx])
    staging = staging[:, :c_loc]

    # ---- tokens -> expert owners: dim 0 of the result is the sender -------
    recv = all_to_all(staging.reshape(n_ep, e_loc, c_loc, D), lay.ep_group)
    qs = recv.transpose(0, 1).reshape(e_loc, n_ep * c_loc, D)

    # ---- local expert FFN ---------------------------------------------------
    h = torch.bmm(qs, wg)
    u = torch.bmm(qs, wu)
    h = F.silu(h.float()).to(qs.dtype) * u
    out = torch.bmm(h, wd)                                      # (e_loc, n_ep*c, D)

    # ---- back to token owners: dim 0 is the expert owner ---------------------
    back = out.reshape(e_loc, n_ep, c_loc, D).transpose(0, 1)
    mine = all_to_all(back, lay.ep_group)
    out_buf = torch.cat([mine.reshape(E, c_loc, D), mine.new_zeros((E, 1, D))], dim=1)

    # ---- combine: an f32 sum over the K routes, one rounding ------------------
    gathered = out_buf[flat_e, slot]                            # (T*K, D)
    gathered = torch.where(keep[:, None], gathered,
                           torch.zeros((), dtype=gathered.dtype, device=x.device))
    y = torch.einsum("tkd,tk->td", gathered.reshape(t_loc, K, D).float(),
                     top_w.float()).to(x.dtype)
    y = _GatherOut.apply(y.reshape(b_loc, s_loc, D), lay.mesh_group, (n_dp, n_seq), blk)

    if cfg.n_shared_experts:
        y = y + moe_lib._shared(p, x)
    return y
