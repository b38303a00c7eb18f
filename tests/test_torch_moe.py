"""The port's MoE block against the JAX package's, on the CPU.

Both packages compute from the same numpy inputs and the same weights (one
MoE layer of reduced DeepSeek-V3, with its shared expert, and of reduced
Phi-3.5-MoE, drawn by the JAX package's ``block_init``).  The routes (top-k
experts and their order) must be equal to ``jax.lax.top_k``'s on the same
f32 gates, ties included; the layer's outputs are held at rtol = atol =
2e-2, the tolerance of the dense layers' tests (one bf16 rounding step at
2**-8, with matmuls ordered differently).  Cases: drop-free capacity (the
configs' reduced ``capacity_factor`` E / K), cf 1.25 with a router that
sends most tokens to one expert (routes dropped), and gates that tie
exactly (a zero router), where JAX takes the lowest indices.  Then reduced
Phi-3.5-MoE as a whole (train logits, prefill, decode) and its parameter
tree; at model level a near-tie route may flip between the packages, and
those positions are left out (tests/torch_moe_routes.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import get_model as jax_get_model
from repro.models import moe as jax_moe
from repro.models import transformer as jax_tf
from repro_torch.configs import ARCHS
from repro_torch.models import get_model
from repro_torch.models import moe as port_moe
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from torch_moe_routes import assert_close_off_ties, recorded_margins

B, S = 2, 64
TOL = dict(rtol=2e-2, atol=2e-2)
ARCH_IDS = ["deepseek-v3-671b", "phi3.5-moe-42b-a6.6b"]


def f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.fixture(scope="module", params=ARCH_IDS)
def layer(request):
    """(JAX config, port config, the MoE params as numpy)."""
    cfg_j = JAX_ARCHS[request.param].reduced()
    p = jax_tf.block_init(cfg_j, "attn", True, jax.random.PRNGKey(7))["moe"]
    return cfg_j, ARCHS[request.param].reduced(), jax.tree.map(np.asarray, p)


def _inputs(cfg, p_np, case, seed=0):
    """x (B, S, D) bf16 as numpy, and the router for ``case``."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, S, cfg.d_model)
    router = p_np["router"].copy()
    if case == "drops":          # expert 0 takes (nearly) every token
        x = x + 1.0
        router[:, 0] += 0.05
    elif case == "ties":         # every gate 1 / E
        router[:] = 0.0
    x = np.asarray(jnp.asarray(x, jnp.bfloat16))
    return x, {**p_np, "router": router}


def _jax_routes(cfg, p, x):
    logits = jnp.einsum("bsd,de->bse", x, p["router"]).astype(jnp.float32)
    top_w, top_e = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.top_k)
    return logits, top_w, top_e


@pytest.mark.parametrize("case", ["drop-free", "drops", "ties"])
def test_moe_block_matches_jax(layer, case):
    cfg_j, cfg_t, p_np = layer
    if case != "drop-free":
        cfg_j = dataclasses.replace(cfg_j, capacity_factor=1.25)
        cfg_t = dataclasses.replace(cfg_t, capacity_factor=1.25)
    x_np, p_np = _inputs(cfg_t, p_np, case)
    pj = jax.tree.map(jnp.asarray, p_np)
    pt = params_from_numpy(p_np, device="cpu")
    xj = jnp.asarray(x_np)
    xt = params_from_numpy(x_np, device="cpu")
    assert pt["router"].dtype == torch.float32

    logits_j, top_w_j, top_e_j = _jax_routes(cfg_j, pj, xj)
    logits_t = port_moe.router_logits(pt, xt)
    np.testing.assert_allclose(f32(logits_t), f32(logits_j), rtol=1e-5, atol=1e-6)
    top_w_t, top_e_t = port_moe.route(cfg_t, logits_t)
    np.testing.assert_array_equal(top_e_t.numpy(), np.asarray(top_e_j))
    np.testing.assert_allclose(f32(top_w_t), f32(top_w_j) / f32(top_w_j).sum(-1, keepdims=True),
                               rtol=1e-5, atol=1e-6)

    C = port_moe.capacity(cfg_t, S)
    assert C == jax_moe.capacity(cfg_j, S)
    dropped = int((port_moe.positions(top_e_t, cfg_t.n_experts) >= C).sum())
    if case == "ties":
        np.testing.assert_array_equal(top_e_t.numpy(), np.broadcast_to(
            np.arange(cfg_t.top_k), (B, S, cfg_t.top_k)))
    if case == "drop-free":
        assert dropped == 0
    else:
        assert dropped > 0, "the case is built to drop routes"

    want = jax.jit(lambda p, x: jax_moe.moe_block(cfg_j, p, x))(pj, xj)
    got = port_moe.moe_block(cfg_t, pt, xt)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, S, cfg_t.d_model)
    np.testing.assert_allclose(f32(got), f32(want), **TOL)
    if case == "drop-free":  # below capacity the dispatch is the plain sum
        np.testing.assert_allclose(f32(port_moe.moe_block_plain(cfg_t, pt, xt)), f32(got),
                                   **TOL)


def test_plain_version_sees_a_lost_route(layer):
    """At cf 1.25 with drops, the dispatch loses routes the plain sum keeps:
    the yardstick tells them apart."""
    _, cfg_t, p_np = layer
    cfg_t = dataclasses.replace(cfg_t, capacity_factor=1.25)
    x_np, p_np = _inputs(cfg_t, p_np, "drops")
    pt, xt = params_from_numpy(p_np, device="cpu"), params_from_numpy(x_np, device="cpu")
    diff = (port_moe.moe_block(cfg_t, pt, xt).float()
            - port_moe.moe_block_plain(cfg_t, pt, xt).float()).abs().amax(-1)
    dropped = (port_moe.positions(port_moe.route(cfg_t, port_moe.router_logits(pt, xt))[1],
                                  cfg_t.n_experts) >= port_moe.capacity(cfg_t, S)).any(-1)
    assert bool((diff[dropped] > 0).all())
    assert float(diff[~dropped].max()) < 2e-2


def test_aux_load_balance_loss(layer):
    cfg_j, cfg_t, p_np = layer
    x_np, p_np = _inputs(cfg_t, p_np, "drop-free", seed=3)
    logits_j, _, top_e_j = _jax_routes(cfg_j, jax.tree.map(jnp.asarray, p_np),
                                       jnp.asarray(x_np))
    want = jax_moe.aux_load_balance_loss(cfg_j, logits_j, top_e_j)
    got = port_moe.aux_load_balance_loss(
        cfg_t, torch.from_numpy(np.array(logits_j)), torch.from_numpy(np.array(top_e_j)).long())
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("seq", [1, 7, 64, 1000])
def test_capacity(seq):
    for name in ARCH_IDS:
        for cfg_j, cfg_t in ((JAX_ARCHS[name], ARCHS[name]),
                             (JAX_ARCHS[name].reduced(), ARCHS[name].reduced())):
            assert port_moe.capacity(cfg_t, seq) == jax_moe.capacity(cfg_j, seq)


# ---------------------------------------------------------------- the model
@pytest.fixture(scope="module")
def phi():
    """Reduced Phi-3.5-MoE: (JAX config, port config, JAX bundle, JAX params
    as numpy, port params)."""
    name = "phi3.5-moe-42b-a6.6b"
    cfg_j = JAX_ARCHS[name].reduced()
    model = jax_get_model(cfg_j)
    p_np = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))
    return cfg_j, ARCHS[name].reduced(), model, p_np, params_from_numpy(p_np, device="cpu")


def test_phi_matches_jax(phi, monkeypatch):
    """train_logits, prefill and one decode step of reduced Phi-3.5-MoE (GQA
    and MoE; S = 128 takes the flash path in both, the JAX side's Pallas
    kernel in interpret mode), same weights and tokens; positions at a
    near-tie route are left out (tests/torch_moe_routes.py)."""
    monkeypatch.setenv("REPRO_FLASH_ATTN", "1")
    cfg_j, cfg_t, model, p_np, pt = phi
    port = get_model(cfg_t)
    pj = jax.tree.map(jnp.asarray, p_np)
    rng = np.random.RandomState(5)
    S_m = 128
    tokens = rng.randint(0, cfg_t.vocab, (B, S_m)).astype(np.int32)
    nxt = rng.randint(0, cfg_t.vocab, (B, 1)).astype(np.int32)
    tok_t, nxt_t = torch.from_numpy(tokens).long(), torch.from_numpy(nxt).long()

    logits_j, aux_j = jax.jit(lambda p, b: model.train_logits(p, b))(pj, {"tokens": tokens})
    with recorded_margins() as margins:
        logits_t, aux_t = port.train_logits(pt, {"tokens": tok_t})
    assert aux_t == {} and aux_j == {}
    assert tuple(logits_t.shape) == (B, S_m, cfg_t.padded_vocab)
    assert_close_off_ties(logits_t, logits_j, margins, **TOL)

    pre_j, cache_j = jax.jit(lambda p, b, c: model.prefill(p, b, c))(
        pj, {"tokens": tokens}, model.init_cache(B, S_m + 8))
    with recorded_margins() as margins:
        pre_t, cache_t = port.prefill(pt, {"tokens": tok_t},
                                      port.init_cache(B, S_m + 8, device="cpu"))
    assert_close_off_ties(pre_t, pre_j, [m[:, -1:] for m in margins], **TOL)

    dec_j, _ = jax.jit(lambda p, t, c: model.decode_step(p, t, c, S_m))(pj, nxt, cache_j)
    with recorded_margins() as margins:
        dec_t, _ = port.decode_step(pt, nxt_t, cache_t, S_m)
    assert_close_off_ties(dec_t, dec_j, margins, rtol=5e-2, atol=5e-2)


def test_phi_params_tree(phi):
    """Shapes and dtypes of the port's init equal the JAX tree's (the
    routers f32), and the JAX weights round-trip bit for bit."""
    _, cfg_t, _, p_np, pt = phi
    drawn = get_model(cfg_t).init(torch.Generator().manual_seed(0), device="cpu")
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), p_np)
    got = jax.tree.map(lambda a: (a.shape, str(a.dtype)), params_to_numpy(drawn))
    assert got == want
    for seg in drawn["segments"]:
        for unit in seg:
            assert unit["moe"]["router"].dtype == torch.float32
    back, back_def = jax.tree.flatten(params_to_numpy(pt))
    orig, orig_def = jax.tree.flatten(p_np)
    assert back_def == orig_def
    assert all(g.dtype == w.dtype and g.tobytes() == w.tobytes() for g, w in zip(back, orig))
