"""Train step: loss, remat, microbatching, gradient compression, as
``repro.training.train_loop`` has it.

``make_train_step`` returns an eager ``(state, batch) -> (state, metrics)``
function that updates the state in place (where JAX jits a function with a
donated state).  Features:

* causal-LM cross entropy in f32, over 512-token chunks whose logits are
  recomputed in the backward pass (:func:`chunked_cross_entropy`);
* per-layer remat inside the model (``transformer._run_segments``, and
  both stacks of ``encdec``);
* **microbatching**: gradients of ``grad_accum`` slices of the batch summed
  in f32, so peak activation memory drops by the accumulation factor; every
  entry of the batch is sliced along its batch axis (an enc-dec batch's
  ``frames`` with its ``tokens``);
* optional **int8 gradient compression with error feedback**
  (:mod:`repro_torch.distributed.compression`).

With an MTP head (DeepSeek) the loss adds ``mtp_weight`` times the chunked
CE of the head's hidden states against the tokens two ahead, with no z-loss
on that term, as the JAX package's loss does; like it, the loss has no
load-balancing term.

The step launches no hand-written kernel: attention under autograd takes the
chunked softmax, as the JAX package's training does
(``models.attention._full_attention``), MLA's included, and the MoE layers
differentiate through their dispatch (``models.moe.moe_block``), the
recurrent blocks through their scans (``models.recurrent``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..distributed.compression import compress_grads
from ..models.registry import ModelBundle
from ..tree import tree_leaves, tree_map, tree_unflatten
from .optimizer import OptimizerConfig, adamw_update, init_opt_state


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: OptimizerConfig = OptimizerConfig()
    grad_accum: int = 1
    compress_grads: bool = False
    mtp_weight: float = 0.3
    z_loss: float = 1e-4


def init_train_state(bundle: ModelBundle, generator: torch.Generator,
                     device="cuda") -> Dict[str, Any]:
    """Params drawn on ``device`` from ``generator`` (a generator of that
    device), zero moments, and no error feedback until compression asks."""
    params = bundle.init(generator, device=device)
    return {"params": params, "opt": init_opt_state(params), "error_fb": None}


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  z_loss: float = 0.0) -> torch.Tensor:
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, targets[..., None].long())[..., 0] - lse
    loss = -ll.mean()
    if z_loss:
        loss = loss + z_loss * torch.square(lse).mean()
    return loss


CE_CHUNK = 512


def _ce_chunk(head_fn, params, h: torch.Tensor, t: torch.Tensor):
    lf = head_fn(params, h).float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, t[..., None].long())[..., 0] - lse
    return -ll.sum(), torch.square(lse).sum()


def chunked_cross_entropy(head_fn, params, hidden: torch.Tensor,
                          targets: torch.Tensor, z_loss: float = 0.0) -> torch.Tensor:
    """CE over (B, S, D) hidden states without materialising (B, S, V) logits.

    Walks the sequence in :data:`CE_CHUNK` slices (the last one shorter where
    S is not a multiple; JAX pads it and masks the padding out).  Under
    autograd each chunk runs inside ``torch.utils.checkpoint``, so its
    (B, 512, V) f32 logits are recomputed in the backward pass, not kept:
    2.0 GB at batch 8 and minicpm-2b's 122,880 padded vocabulary."""
    B, S, _ = hidden.shape
    loss_sum = z_sum = 0.0
    for start in range(0, S, CE_CHUNK):
        ls, zs = checkpoint(_ce_chunk, head_fn, params, hidden[:, start:start + CE_CHUNK],
                            targets[:, start:start + CE_CHUNK], use_reentrant=False,
                            preserve_rng_state=False)
        loss_sum = loss_sum + ls
        z_sum = z_sum + zs
    denom = B * S
    return loss_sum / denom + z_loss * z_sum / denom


def make_loss_fn(bundle: ModelBundle, tcfg: TrainConfig):
    def loss_fn(params, batch):
        hidden, aux = bundle.train_hidden(params, batch)
        tokens = batch["tokens"]
        loss = chunked_cross_entropy(
            bundle.head, params, hidden[:, :-1], tokens[:, 1:], tcfg.z_loss
        )
        if "mtp_hidden" in aux:
            # mtp_hidden[:, s] predicts token s + 2 (from h_s and emb(token s + 1))
            loss = loss + tcfg.mtp_weight * chunked_cross_entropy(
                bundle.head, params, aux["mtp_hidden"][:, :-1], tokens[:, 2:], 0.0
            )
        return loss

    return loss_fn


def make_train_step(
    bundle: ModelBundle, tcfg: TrainConfig
) -> Callable[[Dict, Dict], Tuple[Dict, Dict]]:
    """The step: gradients (summed in f32 over ``grad_accum`` microbatches),
    then compression, then :func:`adamw_update`.  Returns ``(state,
    metrics)``; the metrics (loss, lr, grad norm) are 0-d tensors on the
    device, so the caller decides when the host waits for them.  A param that
    gets no gradient raises: every param of every config the port trains
    feeds the loss (the MTP head's through its term; an expert that no route
    reached through the stacked expert weights, as a zero), so a missing
    gradient means a broken graph (an enc-dec encoder reaches the loss only
    through the decoder's cross-attention K/V)."""
    loss_fn = make_loss_fn(bundle, tcfg)

    def grads_of(params, leaves, batch):
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        missing = [i for i, g in enumerate(grads) if g is None]
        if missing:
            raise RuntimeError(
                f"{len(missing)} of {len(leaves)} params got no gradient "
                f"(leaf indices {missing[:8]}): the loss does not reach them"
            )
        return loss.detach(), grads

    def train_step(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        params = state["params"]
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        n = tcfg.grad_accum
        if n > 1:
            gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
            lsum = 0.0
            for i in range(n):
                mb = {k: v.reshape((n, -1) + tuple(v.shape[1:]))[i] for k, v in batch.items()}
                loss, grads = grads_of(params, leaves, mb)
                for acc, g in zip(gsum, grads):
                    acc.add_(g)
                lsum = lsum + loss
                del grads
            den = torch.full((), float(n), dtype=torch.float32, device=gsum[0].device)
            grads = [g.div_(den) for g in gsum]
            loss = lsum / n
        else:
            loss, grads = grads_of(params, leaves, batch)
        grads = tree_unflatten(params, list(grads))

        error_fb = state.get("error_fb")
        if tcfg.compress_grads:
            if error_fb is None:
                error_fb = tree_map(
                    lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)
            grads, error_fb = compress_grads(grads, error_fb)

        params, opt, opt_metrics = adamw_update(tcfg.optimizer, params, grads, state["opt"])
        metrics = {"loss": loss, **opt_metrics}
        return {"params": params, "opt": opt, "error_fb": error_fb}, metrics

    return train_step
