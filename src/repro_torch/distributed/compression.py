"""Gradient compression: blockwise int8 quantization with error feedback,
as ``repro.distributed.compression`` has it.

Gradients are quantized to int8 with a per-block f32 scale (blocks of
:data:`BLOCK` elements, the last one padded with zeros), and the
quantization residual is carried into the next step (error feedback: Seide
et al. '14, Karimireddy et al. '19).  On one card there is no wire, so, as
in the JAX package's SPMD path, the train step applies quantize then
dequantize to the gradient; it models the information loss.
:func:`compressed_psum` is the int8 all-reduce over a mesh axis.  Rounding is
half to even (``torch.round``, as ``jnp.round``), and the divisions divide
by tensors, as XLA does, never by a reciprocal.
"""

from __future__ import annotations

from typing import Any, Tuple, Union

import torch
import torch.distributed as dist

from ..tree import tree_map
from . import sharding

BLOCK = 256


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    flat = x.reshape(-1)
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / torch.full(
        (), 127.0, dtype=blocks.dtype, device=blocks.device)
    q = torch.clamp(torch.round(blocks / torch.clamp(scale, min=1e-12)), -127, 127)
    return q.to(torch.int8), scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor, shape, size: int) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)[:size]
    return flat.reshape(shape)


def quant_dequant(x: torch.Tensor) -> torch.Tensor:
    q, s = _quantize(x.to(torch.float32))
    return _dequantize(q, s, x.shape, x.numel())


@torch.no_grad()
def compress_grads(grads: Any, error_fb: Any) -> Tuple[Any, Any]:
    """Error-feedback int8 compression, leaf by leaf.

    Returns ``(compressed_grads, new_error_fb)``: g' = Q(g + e);
    e' = (g + e) - g'."""

    comp = tree_map(lambda g, e: quant_dequant(g.to(torch.float32) + e), grads, error_fb)
    new_e = tree_map(lambda g, e, c: (g.to(torch.float32) + e) - c, grads, error_fb, comp)
    return comp, new_e


def compressed_psum(x: torch.Tensor, axis_name: Union[str, Tuple[str, ...]]) -> torch.Tensor:
    """int8-on-the-wire all-reduce over mesh axis ``axis_name`` (one name or
    a tuple) of the active ``logical_sharding`` mesh, as the JAX package's
    ``compressed_psum`` inside ``shard_map``: quantize locally, take the
    largest block scale across the axis (``all_reduce(MAX)`` on the f32
    scales), renormalise the local blocks to it and round half to even into
    int32, sum them (``all_reduce(SUM)``, int32 on the wire, as JAX's
    ``psum`` of its int32 blocks), and dequantize.  Outside a mesh,
    or for an axis the mesh does not have, it raises ``ValueError`` (where
    JAX raises its unbound-axis error).  At world size 1 it equals
    :func:`quant_dequant` bit for bit."""
    mesh = sharding.active_mesh()
    if mesh is None:
        raise ValueError(f"compressed_psum over {axis_name!r} needs an active "
                         "logical_sharding(mesh)")
    group = sharding.axis_group(mesh, axis_name)
    q, s = _quantize(x.to(torch.float32))
    s_max = s.clone()
    dist.all_reduce(s_max, op=dist.ReduceOp.MAX, group=group)
    # renormalize local blocks to the shared scale so the int32 sum is exact
    q32 = torch.round(q.to(torch.float32) * (s / torch.clamp(s_max, min=1e-12))).to(torch.int32)
    dist.all_reduce(q32, op=dist.ReduceOp.SUM, group=group)
    return _dequantize(q32.to(torch.float32), s_max, x.shape, x.numel())
