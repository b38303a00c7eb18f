"""One train step, and the loss's gradients, of a reduced arch in both
packages from the same numpy state and batch: the shared part of the
training parity tests (tests/test_torch_train_recurrent.py,
tests/test_torch_train_encdec.py).

The JAX package draws the weights (its ``init``) and runs its jitted
``make_train_step`` and ``jax.grad`` of its loss; ``train_state_from_numpy``
carries the state into the port, which runs its own step and autograd.  A
batch is a dict of numpy arrays: ``tokens`` (int32) and, for the enc-dec
family, ``frames`` (bf16, as ml_dtypes' dtype).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import get_model as jax_get_model
from repro.training import optimizer as jax_opt
from repro.training import train_loop as jax_tl
from repro_torch.models import get_model
from repro_torch.models.convert import (
    params_from_numpy,
    train_state_from_numpy,
    train_state_to_numpy,
)
from repro_torch.training import optimizer as port_opt
from repro_torch.training import train_loop as port_tl
from repro_torch.tree import tree_leaves, tree_paths

OPT = dict(peak_lr=1e-3, warmup_steps=10, total_steps=50)


def jax_reference(cfg_j, batch: dict, **tkw) -> dict:
    """The JAX package's fresh state (``state0``), one jitted train step of
    it (``state1``, ``metrics``) and the loss's gradients at ``state0``
    (``grads``, f32, by path), all as numpy."""
    model = jax_get_model(cfg_j)
    params = jax.jit(model.init)(jax.random.PRNGKey(0))   # quicker than leaf by leaf
    opt = jax_opt.init_opt_state(params)
    tcfg = jax_tl.TrainConfig(optimizer=jax_opt.OptimizerConfig(**OPT), **tkw)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    state0 = jax.tree.map(np.asarray, {"params": params, "opt": opt})
    new, metrics = jax.jit(jax_tl.make_train_step(model, tcfg))(
        {"params": params, "opt": opt, "error_fb": None}, jb)
    grads = jax.jit(jax.grad(jax_tl.make_loss_fn(model, tcfg)))(params, jb)
    return {"state0": state0,
            "state1": jax.tree.map(np.asarray, {"params": new["params"], "opt": new["opt"]}),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": dict(tree_paths(jax.tree.map(lambda a: np.asarray(a, np.float32), grads)))}


def port_batch(batch: dict) -> dict:
    return params_from_numpy(batch, device="cpu")


def port_grads(cfg_t, state0: dict, batch: dict) -> dict:
    """The port's gradients (f32 numpy, by path) of its loss at ``state0``."""
    params = train_state_from_numpy(state0, "cpu")["params"]
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss_fn = port_tl.make_loss_fn(get_model(cfg_t), port_tl.TrainConfig())
    grads = torch.autograd.grad(loss_fn(params, port_batch(batch)), leaves)
    return {k: g.float().numpy() for (k, _), g in zip(tree_paths(params), grads)}


def port_step(cfg_t, state0: dict, batch: dict, **tkw):
    """One port train step from ``state0``: (new state as numpy, metrics)."""
    tcfg = port_tl.TrainConfig(optimizer=port_opt.OptimizerConfig(**OPT), **tkw)
    new, metrics = port_tl.make_train_step(get_model(cfg_t), tcfg)(
        train_state_from_numpy(state0, "cpu"), port_batch(batch))
    return train_state_to_numpy(new), {k: v.item() for k, v in metrics.items()}


def rel(got, want) -> float:
    """||got - want|| / ||want|| in f64."""
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(
        got, np.float64)
    want = want.detach().double().numpy() if isinstance(want, torch.Tensor) else np.asarray(
        want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def hold_grads(got: dict, want: dict, limit: float) -> dict:
    """Every leaf's ``||d|| / ||ref||`` under ``limit``; returns the ratios."""
    assert set(got) == set(want)
    ratios = {k: rel(got[k], want[k]) for k in want}
    bad = {k: r for k, r in ratios.items() if not r < limit}
    assert not bad, f"||d|| / ||ref|| over {limit}: {bad}"
    return ratios
