"""Gradient compression: blockwise int8 quantization with error feedback,
as ``repro.distributed.compression`` has it.

Gradients are quantized to int8 with a per-block f32 scale (blocks of
:data:`BLOCK` elements, the last one padded with zeros), and the
quantization residual is carried into the next step (error feedback: Seide
et al. '14, Karimireddy et al. '19).  On one card there is no wire, so, as
in the JAX package's SPMD path, the train step applies quantize then
dequantize to the gradient; it models the information loss.  Rounding is
half to even (``torch.round``, as ``jnp.round``), and the divisions divide
by tensors, as XLA does, never by a reciprocal.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from ..tree import tree_map

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


def compressed_psum(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """The int8-on-the-wire all-reduce of the JAX package's pod path: it needs
    a device mesh, which waits for the pod and mesh tooling (ROADMAP Queue 1
    item 7)."""
    raise NotImplementedError(
        "compressed_psum needs a device mesh: it waits for the pod and mesh "
        "tooling (ROADMAP Queue 1 item 7)"
    )
