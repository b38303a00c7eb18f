"""``REPRO_REMAT_POLICY=dots`` in the port, on the CPU at reduced configs.

The JAX package's ``_run_segments`` reads the variable when it traces its
train step: ``dots`` wraps each scanned unit in ``jax.checkpoint`` with
``dots_with_no_batch_dims_saveable``, anything else in the whole-unit
checkpoint.  The port reads it at each train-mode call and, under ``dots``,
hands its per-layer ``torch.utils.checkpoint`` a selective context that
saves the no-batch products (``aten.mm``) the backward reads.

* Under ``dots`` the gradients equal ``full``'s bit for bit: the saved
  products are the ones the recompute would make.
* The loss and gradients under ``dots`` match a freshly jitted JAX step
  under ``dots`` with ``hold_step`` (tests/test_torch_training.py: loss and
  grad norm to 1e-3, each param within 2 lr and a bf16 ulp for at most 2%
  of its elements) and every leaf's gradient within ``GRAD_TOL`` = 3e-2 of
  ``jax.grad``'s (test_torch_training's ``MOE_GRAD_TOL``).  JAX reads the
  variable at trace time, so each JAX step is jitted afresh.
* Under ``FlopCounterMode``, ``full``'s backward less ``dots``'s is exactly
  the forward FLOPs of the stack's saved weight products, counted from the
  parameter shapes.
* The products the port saves have the shapes of the extra residuals
  ``saved_residuals`` (what ``jax.ad_checkpoint.print_saved_residuals``
  prints) lists under ``dots``, less one layer output for each layer but
  the last of a scanned unit: JAX checkpoints RecurrentGemma's (rglru,
  rglru, attn) unit whole and under ``dots`` saves the MLP output inside
  it, where the port's per-layer checkpoint keeps that layer's output as
  the next checkpoint's input under either policy.
* Any other value trains as ``full``; the enc-dec stacks ignore the
  variable, as the JAX package's do.
"""

import collections
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.ad_checkpoint import saved_residuals
from torch.utils.checkpoint import CheckpointPolicy
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import get_model as jax_get_model
from repro.training import train_loop as jax_tl
from repro_torch.configs import ARCHS
from repro_torch.models import get_model
from repro_torch.models import transformer as port_tf
from repro_torch.models.transformer import segments
from repro_torch.training import train_loop as port_tl
from repro_torch.tree import tree_leaves, tree_paths
from test_torch_training import hold_step
from torch_train_parity import hold_grads, jax_reference, port_grads, port_step

FAMILIES = ("minicpm-2b", "phi3.5-moe-42b-a6.6b", "deepseek-v3-671b",
            "recurrentgemma-9b", "rwkv6-3b")
B, S = 2, 64
GRAD_TOL = 3e-2

# the weights of the no-batch products a layer's backward reads, by leaf
# name; the MoE expert stacks (batched over E) and RWKV's shift_w2
# (batched over its five mixes) reach aten.bmm, and the MLP's output
# product (mlp/w_down, mlp/w_out, moe/shared_w_down) only the residual add
# reads
READ_PRODUCTS = {"wq", "wk", "wv", "wo", "wq_a", "wq_b", "wkv_a", "wkv_b",
                 "w_rec_in", "w_gate_in", "w_r", "w_k", "w_v", "w_g", "w_o",
                 "shift_w1", "decay_w1", "decay_w2", "ffn_k", "ffn_v", "ffn_r",
                 "router", "shared_w_gate", "shared_w_up", "mlp/w_gate", "mlp/w_up",
                 "mlp/w_in", "rglru/w_out"}


def tokens(seed: int = 7) -> torch.Tensor:
    return torch.from_numpy(np.random.RandomState(seed).randint(0, 512, (B, S)))


def read_product_flops(cfg, params) -> int:
    """2 x tokens x each saved product's weight, over the stack."""
    total = 0
    for path, leaf in tree_paths(params["segments"]):
        si, j, *names = path.split("/")
        kind, _ = segments(cfg)[int(si)].unit[int(j)]
        name = names[-1]
        scoped = "/".join(names[-2:]) if len(names) > 1 else f"{kind}/{name}"
        if name in READ_PRODUCTS or scoped in READ_PRODUCTS:
            total += 2 * B * S * leaf.numel()
    return total


@functools.lru_cache(maxsize=None)
def grads_and_flops(arch: str, policy: str):
    """The reduced arch's loss gradients (a tuple of leaves) and its
    backward's FLOPs under ``policy``; params drawn from a seed."""
    cfg = ARCHS[arch].reduced()
    bundle = get_model(cfg)
    params = bundle.init(torch.Generator().manual_seed(0), device="cpu")
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_REMAT_POLICY", policy)
    try:
        loss = port_tl.make_loss_fn(bundle, port_tl.TrainConfig())(params, {"tokens": tokens()})
        with FlopCounterMode(display=False) as fc:
            grads = torch.autograd.grad(loss, leaves)
    finally:
        mp.undo()
    return cfg, params, grads, fc.get_total_flops()


@pytest.mark.parametrize("arch", FAMILIES)
def test_dots_gradients_equal_full_bit_for_bit(arch):
    _, params, full, _ = grads_and_flops(arch, "full")
    _, _, dots, _ = grads_and_flops(arch, "dots")
    names = [k for k, _ in tree_paths(params)]
    differ = [n for n, a, b in zip(names, full, dots) if not torch.equal(a, b)]
    assert not differ, differ


@pytest.mark.parametrize("arch", FAMILIES)
def test_flop_difference_is_the_saved_weight_products(arch):
    cfg, params, _, full = grads_and_flops(arch, "full")
    _, _, _, dots = grads_and_flops(arch, "dots")
    want = read_product_flops(cfg, params)
    assert want > 0
    assert full - dots == want


def test_unknown_policy_trains_as_full(monkeypatch):
    cfg, params, full, flops = grads_and_flops("minicpm-2b", "full")
    _, _, other, other_flops = grads_and_flops("minicpm-2b", "no-such-policy")
    assert other_flops == flops
    assert all(torch.equal(a, b) for a, b in zip(full, other))
    layer = port_tf._unstack(params["segments"][0][0], segments(cfg)[0].repeats)[0]
    monkeypatch.setenv("REPRO_REMAT_POLICY", "no-such-policy")
    assert "context_fn" not in port_tf.remat_kwargs(layer)
    monkeypatch.setenv("REPRO_REMAT_POLICY", "dots")
    assert "context_fn" in port_tf.remat_kwargs(layer)


def test_encdec_stacks_ignore_the_policy(monkeypatch):
    """SeamlessM4T-medium reduced: the same gradients and the same backward
    FLOPs under either policy (the reference's stacks never read it)."""
    cfg = ARCHS["seamless-m4t-medium"].reduced()
    bundle = get_model(cfg)
    params = bundle.init(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.RandomState(3)
    batch = {"tokens": tokens(),
             "frames": torch.from_numpy(rng.randn(B, 32, cfg.d_model).astype(np.float32))
             .to(torch.bfloat16)}
    out = {}
    for policy in ("full", "dots"):
        monkeypatch.setenv("REPRO_REMAT_POLICY", policy)
        leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
        loss = port_tl.make_loss_fn(bundle, port_tl.TrainConfig())(params, batch)
        with FlopCounterMode(display=False) as fc:
            out[policy] = (torch.autograd.grad(loss, leaves), fc.get_total_flops())
    assert out["full"][1] == out["dots"][1]
    assert all(torch.equal(a, b) for a, b in zip(out["full"][0], out["dots"][0]))


def test_dots_step_matches_a_fresh_jax_dots_step(monkeypatch):
    """Reduced minicpm-2b under ``dots`` in both packages: one train step
    (``hold_step``) and every leaf's gradient (``GRAD_TOL``)."""
    monkeypatch.setenv("REPRO_REMAT_POLICY", "dots")
    toks = np.random.RandomState(7).randint(0, 512, (B, 128)).astype(np.int32)
    batch = {"tokens": toks}
    ref = jax_reference(JAX_ARCHS["minicpm-2b"].reduced(), batch)
    cfg_t = ARCHS["minicpm-2b"].reduced()
    got, got_m = port_step(cfg_t, ref["state0"], batch)
    hold_step(got, ref["state1"], got_m, ref["metrics"])
    hold_grads(port_grads(cfg_t, ref["state0"], batch), ref["grads"], GRAD_TOL)


def jax_extra_residuals(cfg, monkeypatch) -> list:
    """Sizes of the residuals JAX's loss saves under ``dots`` beyond those
    under ``full`` (a fresh trace each)."""
    model = jax_get_model(cfg)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    batch = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    loss = jax_tl.make_loss_fn(model, jax_tl.TrainConfig())
    sizes = {}
    for policy in ("full", "dots"):
        monkeypatch.setenv("REPRO_REMAT_POLICY", policy)
        sizes[policy] = collections.Counter(
            int(np.prod(aval.shape)) for aval, _ in saved_residuals(loss, params, batch))
    return sorted((sizes["dots"] - sizes["full"]).elements())


def port_saved_products(cfg, monkeypatch) -> list:
    """Sizes of the products the port's ``dots`` policy saves in one
    forward (its recompute replays them)."""
    bundle = get_model(cfg)
    params = bundle.init(torch.Generator().manual_seed(0), device="cpu")
    saved = []
    policy = port_tf.dots_policy

    def recording(unread, ctx, op, *args, **kwargs):
        decision = policy(unread, ctx, op, *args, **kwargs)
        if decision == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            saved.append(args[0].shape[0] * args[-1].shape[-1])
        return decision

    monkeypatch.setattr(port_tf, "dots_policy", recording)
    monkeypatch.setenv("REPRO_REMAT_POLICY", "dots")
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss = port_tl.make_loss_fn(bundle, port_tl.TrainConfig())(
        params, {"tokens": torch.zeros((B, S), dtype=torch.long)})
    torch.autograd.grad(loss, leaves)
    return sorted(saved)


# one unit of each family: RecurrentGemma's is three layers, DeepSeek's
# dense layer and its first MoE layer are two segments
UNIT_LAYERS = {"minicpm-2b": 1, "phi3.5-moe-42b-a6.6b": 1, "deepseek-v3-671b": 2,
               "recurrentgemma-9b": 3, "rwkv6-3b": 1}


@pytest.mark.parametrize("arch", FAMILIES)
def test_saved_products_are_jaxs_dots_residuals(arch, monkeypatch):
    n = UNIT_LAYERS[arch]
    cfg_j = dataclasses.replace(JAX_ARCHS[arch].reduced(), n_layers=n)
    cfg_t = dataclasses.replace(ARCHS[arch].reduced(), n_layers=n)
    got = port_saved_products(cfg_t, monkeypatch)
    assert got
    inner = sum((len(seg.unit) - 1) * seg.repeats for seg in segments(cfg_t))
    want = jax_extra_residuals(cfg_j, monkeypatch)
    assert sorted(got + [B * S * cfg_t.d_model] * inner) == want
