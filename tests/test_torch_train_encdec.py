"""Training the encoder-decoder family (SeamlessM4T-medium, reduced): the
port against the JAX package, on the CPU.  Frames (96 of them) and tokens
(64) are made from a numpy seed; the JAX package draws the weights and
``train_state_from_numpy`` / ``params_from_numpy`` carry them into the port.

Tolerances, stated where they are used, with the readings they were set
from:

* **One train step** against JAX's jitted ``make_train_step`` with
  ``hold_step`` (tests/test_torch_training.py; the loss and grad norm to
  1e-3, readings 9.7e-6 and 4.6e-6; each param within 2 lr and a bf16
  ulp), its norm scales counted together as small leaves, and the share of
  elements off by more than a hundredth of a step at ``STEP_SHARE`` = 4%
  (readings 2.63% at the encoder's wk, 2.00% of the small leaves: the
  encoder is the deepest stack the backward crosses, through every decoder
  layer's cross-attention); every leaf's gradient within
  ``MODEL_GRAD_TOL`` = 3e-2 of ``jax.grad``'s (readings at most 1.37e-2,
  at the encoder's w_in).
* **One encoder layer and one decoder layer** (configs cut to one layer)
  against ``jax.grad`` of the JAX stack: each leaf's ``||d|| / ||ref||``
  under ``LAYER_GRAD_TOL`` = 1e-2 (readings at most 4.6e-3 and 5.3e-3);
  the decoder layer with its cross K/V detached (a planted fault) fails it
  (the encoder output's and the cross K/V weights' gradients vanish: 1.0).
* **Accumulation**: ``grad_accum=2`` slices the frames with the tokens, and
  the gradients it hands the optimizer lie within ``ACCUM_GRAD_TOL`` = 1e-2
  of the full batch's (reading at most 3.9e-3).
* **Remat** changes no gradient bit.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import encdec as jax_ed
from repro_torch.configs import ARCHS
from repro_torch.models import attention as port_attention
from repro_torch.models import encdec as port_ed
from repro_torch.models import get_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.training import train_loop as port_tl
from repro_torch.tree import tree_leaves, tree_paths
from test_torch_training import hold_step
from torch_train_parity import (
    hold_grads,
    jax_reference,
    port_batch,
    port_grads,
    port_step,
    rel,
)

ARCH = "seamless-m4t-medium"
B, S_ENC, S = 2, 96, 64
STEP_SHARE = 0.04
MODEL_GRAD_TOL = 3e-2
LAYER_GRAD_TOL = 1e-2
ACCUM_GRAD_TOL = 1e-2


def configs(**over):
    return (dataclasses.replace(JAX_ARCHS[ARCH].reduced(), **over),
            dataclasses.replace(ARCHS[ARCH].reduced(), **over))


def bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


def make_batch(seed: int, batch: int = B) -> dict:
    rng = np.random.RandomState(seed)
    d = ARCHS[ARCH].reduced().d_model
    return {"frames": bf16(rng.randn(batch, S_ENC, d)),
            "tokens": rng.randint(0, 512, (batch, S)).astype(np.int32)}


@pytest.fixture
def flash_forbidden(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("training reached the flash kernel")

    monkeypatch.setattr(port_attention, "flash_attention", refuse)


# ------------------------------------------------------------ one train step
def test_one_step_matches_jax(flash_forbidden):
    """One train step of reduced SeamlessM4T-medium on a batch of frames and
    tokens against JAX's jitted step, and every leaf's gradient against
    ``jax.grad``'s; every encoder leaf and every cross-attention leaf gets
    a non-zero gradient, and attention never reaches the flash kernel."""
    cfg_j, cfg_t = configs()
    batch = make_batch(7)
    ref = jax_reference(cfg_j, batch)
    got, got_m = port_step(cfg_t, ref["state0"], batch)
    hold_step(got, ref["state1"], got_m, ref["metrics"], moe=True, share=STEP_SHARE)
    grads = port_grads(cfg_t, ref["state0"], batch)
    hold_grads(grads, ref["grads"], MODEL_GRAD_TOL)
    assert all(np.abs(g).max() > 0 for g in grads.values())
    assert sum(k.startswith("enc/") for k in grads) == 9
    assert sum(k.startswith("dec/cross/") for k in grads) == 4


# ---------------------------------------------------------------- one layer
def one_layer_params(cfg_j):
    return jax.tree.map(np.asarray, jax_ed.init_params_encdec(cfg_j, jax.random.PRNGKey(3)))


def torch_grads(fn, inputs: dict, cot) -> dict:
    leaves = {k: params_from_numpy(v, device="cpu") for k, v in inputs.items()}
    for t in tree_leaves(leaves):
        t.requires_grad_(True)
    out = (fn(**leaves).float() * torch.from_numpy(np.asarray(cot, np.float32))).sum()
    flat = tree_paths(leaves)
    grads = torch.autograd.grad(out, [t for _, t in flat], allow_unused=True,
                                materialize_grads=True)
    return {k: g.float().numpy() for (k, _), g in zip(flat, grads)}


def jax_grads(fn, inputs: dict, cot) -> dict:
    def f(inp):
        return jnp.sum(fn(**inp).astype(jnp.float32) * jnp.asarray(cot, jnp.float32))

    g = jax.jit(jax.grad(f))(jax.tree.map(jnp.asarray, inputs))
    return dict(tree_paths(jax.tree.map(lambda a: np.asarray(a, np.float32), g)))


def test_encoder_layer_backward_matches_jax():
    """One encoder layer (and the final norm), rematerialised, against
    ``jax.grad`` of the JAX encoder: the frames' gradient and every leaf's
    within ``LAYER_GRAD_TOL``."""
    cfg_j, cfg_t = configs(enc_layers=1)
    rng = np.random.RandomState(4)
    inputs = {"enc": one_layer_params(cfg_j)["enc"],
              "frames": bf16(rng.randn(B, S_ENC, cfg_t.d_model))}
    cot = bf16(rng.randn(B, S_ENC, cfg_t.d_model))
    want = jax_grads(lambda enc, frames: jax_ed.encode(cfg_j, {"enc": enc}, frames),
                     inputs, cot)
    got = torch_grads(lambda enc, frames: port_ed.encode(cfg_t, {"enc": enc}, frames),
                      inputs, cot)
    assert all(np.abs(g).max() > 0 for g in got.values())
    hold_grads(got, want, LAYER_GRAD_TOL)


def _detached_cross_kv(fn):
    def detached(cfg, cross_p, enc_out):
        k, v = fn(cfg, cross_p, enc_out)
        return k.detach(), v.detach()
    return detached


@pytest.fixture(scope="module")
def decoder_case():
    cfg_j, cfg_t = configs(n_layers=1)
    rng = np.random.RandomState(5)
    d = cfg_t.d_model
    inputs = {"dec": one_layer_params(cfg_j)["dec"], "x": bf16(rng.randn(B, S, d)),
              "enc_out": bf16(rng.randn(B, S_ENC, d))}
    cot = bf16(rng.randn(B, S, d))
    want = jax_grads(lambda dec, x, enc_out: jax_ed._decoder(
        cfg_j, {"dec": dec}, x, enc_out, mode="train")[0], inputs, cot)
    return cfg_t, inputs, cot, want


@pytest.mark.parametrize("fault", [None, "cross K/V detached"])
def test_decoder_layer_backward_matches_jax(decoder_case, monkeypatch, fault):
    """One decoder layer in training (causal self-attention, cross-attention
    whose K/V it computes from the encoder output inside its checkpoint, the
    MLP) against ``jax.grad`` of the JAX decoder: the input's, the encoder
    output's and every leaf's gradient within ``LAYER_GRAD_TOL``.  With the
    cross K/V detached (a planted fault) the encoder output and the cross
    K/V weights get no gradient, and the comparison fails."""
    cfg_t, inputs, cot, want = decoder_case
    if fault:
        monkeypatch.setattr(port_ed, "_cross_kv", _detached_cross_kv(port_ed._cross_kv))
    got = torch_grads(lambda dec, x, enc_out: port_ed._decoder(
        cfg_t, {"dec": dec}, x, enc_out, mode="train"), inputs, cot)
    if fault:
        assert all(rel(got[k], want[k]) == 1.0
                   for k in ("enc_out", "dec/cross/wk", "dec/cross/wv"))
        return
    assert all(np.abs(g).max() > 0 for g in got.values())
    hold_grads(got, want, LAYER_GRAD_TOL)


# ------------------------------------------------------------ remat and guard
def _no_remat(fn, *args, use_reentrant=None, preserve_rng_state=None):
    return fn(*args)


def test_remat_changes_no_gradient(monkeypatch):
    """Every encoder layer and every decoder layer runs inside the
    checkpoint under autograd, and the recompute changes no gradient bit
    against the same model run without it."""
    cfg = ARCHS[ARCH].reduced()
    bundle = get_model(cfg)
    params = bundle.init(torch.Generator().manual_seed(3), device="cpu")
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    batch = port_batch(make_batch(8))
    loss_fn = port_tl.make_loss_fn(bundle, port_tl.TrainConfig())
    calls = []
    ckpt = port_ed.checkpoint
    monkeypatch.setattr(port_ed, "checkpoint", lambda fn, *a, **k: calls.append(fn) or ckpt(
        fn, *a, **k))
    remat = torch.autograd.grad(loss_fn(params, batch), leaves)
    assert calls == [port_ed._enc_layer] * cfg.enc_layers + [port_ed._dec_layer] * cfg.n_layers
    monkeypatch.setattr(port_ed, "checkpoint", _no_remat)
    once = torch.autograd.grad(loss_fn(params, batch), leaves)
    for (k, _), a, b in zip(tree_paths(params), remat, once):
        assert torch.equal(a, b), k


def test_step_raises_when_the_cross_kv_is_detached(monkeypatch):
    """The missing-gradient guard covers the encoder stack: with the cross
    K/V detached, the encoder's leaves and the cross K/V weights get no
    gradient, and the step names them before it updates anything."""
    bundle = get_model(ARCHS[ARCH].reduced())
    state = port_tl.init_train_state(bundle, torch.Generator().manual_seed(5), device="cpu")
    paths = [k for k, _ in tree_paths(state["params"])]
    cut = [i for i, k in enumerate(paths)
           if k.startswith("enc/") or k in ("dec/cross/wk", "dec/cross/wv")]
    assert len(cut) == 11
    monkeypatch.setattr(port_ed, "_cross_kv", _detached_cross_kv(port_ed._cross_kv))
    before = [t.clone() for t in tree_leaves(state["params"])]
    with pytest.raises(RuntimeError, match=re.escape(
            f"{len(cut)} of {len(paths)} params got no gradient (leaf indices {cut[:8]})")):
        port_tl.make_train_step(bundle, port_tl.TrainConfig())(state, port_batch(make_batch(9)))
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(state["params"])))


# ------------------------------------------------------------- accumulation
def test_grad_accum_with_frames_matches_full_batch(monkeypatch):
    """``grad_accum=2`` on a batch of 4: each microbatch carries 2 rows of
    frames with their 2 rows of tokens, and the mean of the two gradients
    the optimizer gets lies within ``ACCUM_GRAD_TOL`` of the whole batch's,
    leaf by leaf."""
    cfg = ARCHS[ARCH].reduced()
    bundle = get_model(cfg)
    batch = make_batch(10, batch=4)
    seen, handed = [], []
    hidden, update = bundle.train_hidden, port_tl.adamw_update
    recording = dataclasses.replace(bundle, train_hidden=lambda p, b: seen.append(
        {k: tuple(v.shape) for k, v in b.items()}) or hidden(p, b))
    monkeypatch.setattr(port_tl, "adamw_update", lambda c, p, g, o: handed.append(
        [t.float().clone() for t in tree_leaves(g)]) or update(c, p, g, o))
    for n in (1, 2):   # each from the same fresh state
        state = port_tl.init_train_state(bundle, torch.Generator().manual_seed(6), device="cpu")
        port_tl.make_train_step(recording, port_tl.TrainConfig(grad_accum=n))(
            state, port_batch(batch))
    d = cfg.d_model
    assert seen == [{"frames": (4, S_ENC, d), "tokens": (4, S)}] + \
        [{"frames": (2, S_ENC, d), "tokens": (2, S)}] * 2
    full, accum = handed
    ratios = [rel(a, b) for a, b in zip(accum, full)]
    assert max(ratios) < ACCUM_GRAD_TOL, max(ratios)
