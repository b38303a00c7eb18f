"""Optimizer and LR schedules, as ``repro.training.optimizer`` has them.

AdamW with bf16 params and f32 moments; the schedules are cosine, **WSD**
(warmup-stable-decay, MiniCPM's, arXiv:2404.06395) and constant.  The state
is a plain tree (``{"mu", "nu", "step"}``), so it versions and checkpoints
through the store like everything else.

The arithmetic is the JAX package's, operation for operation, in f32: the
Python constants are rounded to f32 first, as JAX's weakly typed scalars
are, and divisions divide by a 0-d tensor (PyTorch's CUDA kernels turn a
division by a Python scalar into a product with its reciprocal).  JAX
returns new arrays from a donated state; the port updates μ, ν and the
params in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    schedule: str = "cosine"          # cosine | wsd | constant
    warmup_steps: int = 100
    total_steps: int = 10_000
    stable_frac: float = 0.8          # WSD: fraction of post-warmup at peak
    final_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def _f32(value: float, device) -> torch.Tensor:
    """A Python constant as JAX's weak f32 scalar: a 0-d f32 tensor, filled
    on ``device`` (no host copy, so no synchronisation)."""
    return torch.full((), float(np.float32(value)), dtype=torch.float32, device=device)


def learning_rate(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """The schedule's rate at ``step`` (an integer tensor), in f32."""
    s = step.to(torch.float32)
    dev = s.device
    one = _f32(1.0, dev)
    warm = torch.minimum(one, s / _f32(max(1.0, cfg.warmup_steps), dev))
    t = torch.clamp(
        (s - cfg.warmup_steps) / _f32(max(1.0, cfg.total_steps - cfg.warmup_steps), dev),
        0.0, 1.0,
    )
    if cfg.schedule == "cosine":
        frac = cfg.final_lr_frac + (1 - cfg.final_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    elif cfg.schedule == "wsd":
        # stable at peak for stable_frac, then exponential-style decay
        decay_t = torch.clamp(
            (t - cfg.stable_frac) / _f32(max(1e-6, 1 - cfg.stable_frac), dev), 0.0, 1.0)
        frac = torch.where(t < cfg.stable_frac, one,
                           torch.pow(_f32(cfg.final_lr_frac, dev), decay_t))
    else:
        frac = one
    return cfg.peak_lr * warm * frac


def init_opt_state(params: Any) -> Dict[str, Any]:
    """f32 zeros for μ and ν beside every param, and an int32 step 0."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = tree_leaves(params)[0].device
    return {
        "mu": tree_map(zeros, params),
        "nu": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


@torch.no_grad()
def adamw_update(
    cfg: OptimizerConfig, params: Any, grads: Any, opt_state: Dict[str, Any]
) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step: the global-norm clip, bias-corrected moments, decay on
    leaves of two or more dims (a stacked ``(layers, d)`` norm scale is
    decayed, as in JAX), the new param rounded to its dtype.  Updates
    ``params`` and ``opt_state``'s μ and ν in place; returns ``(params,
    new_state, {"lr", "grad_norm"})``, the metrics as 0-d device tensors."""
    step = opt_state["step"] + 1
    lr = learning_rate(cfg, step)
    dev = lr.device

    # global-norm clip (f32): the leaves' sums in JAX's leaf order
    gsq = sum(torch.sum(torch.square(g.float())) for g in tree_leaves(grads))
    gnorm = torch.sqrt(gsq)
    scale = torch.minimum(
        _f32(1.0, dev), _f32(cfg.grad_clip, dev) / torch.clamp(gnorm, min=1e-9))

    b1, b2 = cfg.b1, cfg.b2
    sf = step.to(torch.float32)
    bc1 = 1 - torch.pow(_f32(b1, dev), sf)
    bc2 = 1 - torch.pow(_f32(b2, dev), sf)

    for p, g, mu, nu in zip(tree_leaves(params), tree_leaves(grads),
                            tree_leaves(opt_state["mu"]), tree_leaves(opt_state["nu"])):
        gf = g.float() * scale
        # mu = b1 * mu + (1 - b1) * gf;  nu = b2 * nu + ((1 - b2) * gf) * gf
        mu.mul_(b1).add_(gf * (1 - b1))
        nu.mul_(b2).add_(gf.mul(1 - b2).mul_(gf))
        del gf
        # update = (mu / bc1) / (sqrt(nu / bc2) + eps)
        den = torch.div(nu, bc2).sqrt_().add_(cfg.eps)
        update = torch.div(mu, bc1).div_(den)
        del den
        pf = p.float()
        if p.ndim >= 2:  # decay matrices only
            update.add_(pf * cfg.weight_decay)
        p.copy_(pf.sub_(update.mul_(lr)))
        del update, pf
    new_state = {"mu": opt_state["mu"], "nu": opt_state["nu"], "step": step}
    return params, new_state, {"lr": lr, "grad_norm": gnorm}
