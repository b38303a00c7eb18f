"""Training the MoE and MLA families: the port against the JAX package, on
the CPU.

Both packages compute from the same numpy inputs made from a seed; the JAX
package draws the weights and ``params_from_numpy`` carries them into the
port.  Tolerances, stated where they are used:

* **DeepSeek's loss** (reduced ``deepseek-v3-671b``: MLA, one dense and
  three MoE layers, the MTP head): the total and the MTP term alone at rtol
  1e-3 against JAX's jitted loss (sound: 1e-4 and 2e-4).  JAX's init draws
  the LM head at std 0.02, whose near-uniform logits leave a CE almost blind
  to its targets (MTP targets one token early move the term by 8e-4); the
  head is scaled by 10, logits of std ~2.3 as a trained head's, so that the
  comparison sees which tokens the term predicts.  Two planted faults must
  fail it: an MTP weight of 0, and MTP targets ``tokens[:, 1:]``.
* **One MoE layer's gradients** (a layer of reduced DeepSeek-V3 with its
  shared expert, and of reduced Phi-3.5-MoE; drop-free and at cf 1.25 with
  routes dropped): each leaf's ``||d|| / ||ref||`` under
  ``LAYER_GRAD_TOL`` = 1e-2 against ``jax.grad`` of the JAX layer, and
  against ``moe_block_plain``'s autograd gradients at drop-free capacity.
  Sound readings are at most 3.7e-3 (bf16 gradients; the SwiGLU's gate
  differentiated through an f32 silu rounded to bf16); the planted faults
  land at 0.39 or more: the route weights detached (the router's gradient
  lost) and the overflow slot left unmasked at the combine.
* **Remat** changes no gradient bit: each layer rematerialised against the
  same model run without it.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import get_model as jax_get_model
from repro.models import moe as jax_moe
from repro.models import transformer as jax_tf
from repro.training import train_loop as jax_tl
from repro_torch.configs import ARCHS
from repro_torch.models import get_model
from repro_torch.models import moe as port_moe
from repro_torch.models import transformer as port_tf
from repro_torch.models.convert import params_from_numpy
from repro_torch.training import train_loop as port_tl
from repro_torch.tree import tree_leaves, tree_paths

MOE_ARCHS = ["deepseek-v3-671b", "phi3.5-moe-42b-a6.6b"]
B, S = 2, 128
LOSS_RTOL = 1e-3
LAYER_GRAD_TOL = 1e-2
HEAD_SCALE = 10


def f32(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def rel(got, want) -> float:
    got, want = f32(got), f32(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ------------------------------------------------------------ DeepSeek's loss
@pytest.fixture(scope="module")
def deepseek_loss():
    """Reduced DeepSeek-V3's JAX params (the head scaled by ``HEAD_SCALE``),
    tokens, and JAX's jitted loss at the default MTP weight and at 0."""
    name = "deepseek-v3-671b"
    model = jax_get_model(JAX_ARCHS[name].reduced())
    params = model.init(jax.random.PRNGKey(0))
    params = {**params, "lm_head": params["lm_head"] * HEAD_SCALE}
    tokens = np.random.RandomState(11).randint(0, 512, (B, S)).astype(np.int32)
    want = {w: float(jax.jit(jax_tl.make_loss_fn(model, jax_tl.TrainConfig(mtp_weight=w)))(
        params, {"tokens": jnp.asarray(tokens)})) for w in (0.3, 0.0)}
    return (get_model(ARCHS[name].reduced()),
            params_from_numpy(jax.tree.map(np.asarray, params), device="cpu"), tokens, want)


def port_loss(bundle, params, tokens, mtp_weight) -> float:
    with torch.no_grad():
        return port_tl.make_loss_fn(bundle, port_tl.TrainConfig(mtp_weight=mtp_weight))(
            params, {"tokens": torch.from_numpy(tokens).long()}).item()


def hold_loss(total, term, want) -> None:
    """The total at the default weight, and the MTP term alone (the total
    less the total at weight 0, over the weight), within ``LOSS_RTOL``."""
    np.testing.assert_allclose(total, want[0.3], rtol=LOSS_RTOL, err_msg="total")
    np.testing.assert_allclose(term, (want[0.3] - want[0.0]) / 0.3, rtol=LOSS_RTOL,
                               err_msg="MTP term")


def test_mtp_loss_matches_jax(deepseek_loss):
    bundle, params, tokens, want = deepseek_loss
    total, base = port_loss(bundle, params, tokens, 0.3), port_loss(bundle, params, tokens, 0.0)
    hold_loss(total, (total - base) / 0.3, want)
    assert (total - base) / 0.3 > 1.0  # the term is there, a CE of its own
    # at weight 0 the loss is the main CE and nothing else (no load-balancing
    # term); the MTP term is the head's CE of mtp_hidden[:, :-1] against the
    # tokens two ahead, with no z-loss: both exact, as the reference writes them
    t = torch.from_numpy(tokens).long()
    with torch.no_grad():
        hidden, aux = bundle.train_hidden(params, {"tokens": t})
        main = port_tl.chunked_cross_entropy(bundle.head, params, hidden[:, :-1], t[:, 1:], 1e-4)
        mtp = port_tl.chunked_cross_entropy(bundle.head, params, aux["mtp_hidden"][:, :-1],
                                            t[:, 2:], 0.0)
    assert tuple(aux["mtp_hidden"].shape) == (B, S - 1, bundle.cfg.d_model)
    assert base == main.item()
    assert total == (main + 0.3 * mtp).item()


@pytest.mark.parametrize("fault", ["weight 0", "targets tokens[:, 1:]"])
def test_mtp_loss_planted_fault_fails(deepseek_loss, monkeypatch, fault):
    bundle, params, tokens, want = deepseek_loss
    base = port_loss(bundle, params, tokens, 0.0)
    if fault == "weight 0":
        total = port_loss(bundle, params, tokens, 0.0)
    else:
        chunked, early = port_tl.chunked_cross_entropy, torch.from_numpy(tokens[:, 1:-1]).long()

        def mtp_one_early(head, p, hidden, targets, z_loss=0.0):
            if hidden.shape[1] == S - 2:  # the MTP term's call: targets one token early
                targets = early
            return chunked(head, p, hidden, targets, z_loss)

        monkeypatch.setattr(port_tl, "chunked_cross_entropy", mtp_one_early)
        total = port_loss(bundle, params, tokens, 0.3)
    with pytest.raises(AssertionError):
        hold_loss(total, (total - base) / 0.3, want)


# --------------------------------------------------------- one MoE layer
@pytest.fixture(scope="module", params=MOE_ARCHS)
def moe_layer(request):
    """(JAX config, port config, one MoE layer's params as numpy)."""
    cfg_j = JAX_ARCHS[request.param].reduced()
    p = jax_tf.block_init(cfg_j, "attn", True, jax.random.PRNGKey(7))["moe"]
    return cfg_j, ARCHS[request.param].reduced(), jax.tree.map(np.asarray, p)


def layer_case(layer, case):
    """(JAX config, port config, params, x, cotangent) as numpy: ``drop-free``
    at the reduced capacity E / K, or ``cf 1.25`` with a router that sends
    every token to expert 0 first (routes dropped)."""
    cfg_j, cfg_t, p_np = layer
    rng = np.random.RandomState(0)
    x = rng.randn(B, 64, cfg_t.d_model)
    router = p_np["router"].copy()
    if case == "cf 1.25":
        cfg_j = dataclasses.replace(cfg_j, capacity_factor=1.25)
        cfg_t = dataclasses.replace(cfg_t, capacity_factor=1.25)
        x = x + 1.0
        router[:, 0] += 0.05
    bf16 = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16))
    return cfg_j, cfg_t, {**p_np, "router": router}, bf16(x), bf16(rng.randn(*x.shape))


def jax_layer_grads(cfg, p, x, cot) -> dict:
    def f(p, x):
        y = jax_moe.moe_block(cfg, p, x).astype(jnp.float32)
        return jnp.sum(y * jnp.asarray(cot, jnp.float32))

    gp, gx = jax.jit(jax.grad(f, argnums=(0, 1)))(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    return {**{k: np.asarray(v, np.float32) for k, v in gp.items()},
            "x": np.asarray(gx, np.float32)}


def port_layer_grads(cfg, p, x, cot, block=None, wrt=None) -> dict:
    """The port layer's gradients of ``sum(y * cot)``; a leaf the output
    does not reach gets zeros (where a fault cut it off)."""
    pt, xt = params_from_numpy(p, device="cpu"), params_from_numpy(x, device="cpu")
    leaves = {**pt, "x": xt}
    names = wrt or list(leaves)
    for n in names:
        leaves[n].requires_grad_(True)
    y = (block or port_moe.moe_block)(cfg, pt, xt)
    out = (y.float() * params_from_numpy(cot, device="cpu").float()).sum()
    grads = torch.autograd.grad(out, [leaves[n] for n in names], allow_unused=True,
                                materialize_grads=True)
    return dict(zip(names, grads))


def hold_grads(got, want, limit=LAYER_GRAD_TOL) -> dict:
    ratios = {k: rel(got[k], want[k]) for k in want}
    bad = {k: r for k, r in ratios.items() if not r < limit}
    assert not bad, f"||d|| / ||ref|| over {limit}: {bad}"
    return ratios


@pytest.mark.parametrize("case", ["drop-free", "cf 1.25"])
def test_moe_layer_grads_match_jax(moe_layer, case):
    cfg_j, cfg_t, p, x, cot = layer_case(moe_layer, case)
    # the same input gives the same routes: checked before any gradient
    logits = jnp.einsum("bsd,de->bse", jnp.asarray(x), jnp.asarray(p["router"]))
    _, want_e = jax.lax.top_k(jax.nn.softmax(logits.astype(jnp.float32), axis=-1), cfg_j.top_k)
    pt, xt = params_from_numpy(p, device="cpu"), params_from_numpy(x, device="cpu")
    top_e = port_moe.route(cfg_t, port_moe.router_logits(pt, xt))[1]
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(want_e))
    dropped = int((port_moe.positions(top_e, cfg_t.n_experts)
                   >= port_moe.capacity(cfg_t, x.shape[1])).sum())
    assert (dropped > 0) == (case == "cf 1.25"), dropped

    want = jax_layer_grads(cfg_j, p, x, cot)
    got = port_layer_grads(cfg_t, p, x, cot)
    assert set(got) == set(want) and all(bool((g != 0).any()) for g in got.values())
    hold_grads(got, want)


def _detached_weights(route):
    def detached(cfg, logits):
        top_w, top_e = route(cfg, logits)
        return top_w.detach(), top_e
    return detached


def _unmasked_overflow(combine):
    def unmasked(out_buf, top_e, b_idx, slot, keep, top_w):
        return combine(out_buf, top_e, b_idx, slot, torch.ones_like(keep), top_w)
    return unmasked


@pytest.mark.parametrize("fault", ["route weights detached", "overflow slot unmasked"])
def test_moe_layer_grad_planted_fault_fails(moe_layer, monkeypatch, fault):
    """Each planted fault lands above ``LAYER_GRAD_TOL`` on some leaf, at cf
    1.25 where routes are dropped (the unmasked overflow slot shows only
    there)."""
    cfg_j, cfg_t, p, x, cot = layer_case(moe_layer, "cf 1.25")
    want = jax_layer_grads(cfg_j, p, x, cot)
    if fault == "route weights detached":
        monkeypatch.setattr(port_moe, "route", _detached_weights(port_moe.route))
    else:
        monkeypatch.setattr(port_moe, "_combine", _unmasked_overflow(port_moe._combine))
    got = port_layer_grads(cfg_t, p, x, cot)
    assert max(rel(got[k], want[k]) for k in want) > 30 * LAYER_GRAD_TOL


def test_moe_layer_grads_match_plain(moe_layer):
    """At drop-free capacity the dispatch's gradients are the plain sum's:
    the same routes, no positions, slots or buffers."""
    _, cfg_t, p, x, cot = layer_case(moe_layer, "drop-free")
    got = port_layer_grads(cfg_t, p, x, cot)
    want = port_layer_grads(cfg_t, p, x, cot, block=port_moe.moe_block_plain)
    hold_grads(got, want)


def test_overflow_bin_gets_no_cotangent(moe_layer, monkeypatch):
    """At cf 1.25 several dropped routes write the overflow slot C of their
    expert (``index_put_`` without accumulate, the winner left to the
    device); the combine masks the slot, so the slot's rows get an exactly
    zero cotangent, where the kept slots' do not, and the dropped routes
    pass nothing back to ``x``."""
    _, cfg_t, p, x, cot = layer_case(moe_layer, "cf 1.25")
    seen = {}
    ffn = port_moe._expert_ffn

    def recording(blocks, p_):
        blocks.register_hook(lambda g: seen.setdefault("grad", g))
        return ffn(blocks, p_)

    monkeypatch.setattr(port_moe, "_expert_ffn", recording)
    port_layer_grads(cfg_t, p, x, cot, wrt=["x"])
    C = port_moe.capacity(cfg_t, x.shape[1])
    g = seen["grad"].view(cfg_t.n_experts, B, C + 1, cfg_t.d_model)
    assert bool((g[:, :, C] == 0).all())
    assert bool((g[:, :, :C] != 0).any())


# ------------------------------------------------------------------- remat
def _no_remat(fn, *args, use_reentrant=None, preserve_rng_state=None):
    return fn(*args)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_remat_changes_no_gradient(arch, monkeypatch):
    """The recompute in the backward pass chooses the routes of the first
    forward: every leaf's gradient with each layer rematerialised equals,
    bit for bit, its gradient with the layers run once and kept
    (``torch.utils.checkpoint`` checks shapes, not values, so a route that
    flipped on recompute would show only here)."""
    cfg = ARCHS[arch].reduced()
    bundle = get_model(cfg)
    params = bundle.init(torch.Generator().manual_seed(3), device="cpu")
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    tokens = {"tokens": torch.from_numpy(
        np.random.RandomState(4).randint(0, cfg.vocab, (B, 64))).long()}
    loss_fn = port_tl.make_loss_fn(bundle, port_tl.TrainConfig())

    calls = []
    route = port_moe.route
    monkeypatch.setattr(port_moe, "route", lambda c, l: calls.append(1) or route(c, l))
    remat = torch.autograd.grad(loss_fn(params, tokens), leaves)
    n_moe = sum(cfg.layer_uses_moe(i) for i in range(cfg.n_layers))
    assert len(calls) == 2 * n_moe  # each MoE layer routed again in the backward
    monkeypatch.setattr(port_tf, "checkpoint", _no_remat)
    once = torch.autograd.grad(loss_fn(params, tokens), leaves)
    assert len(calls) == 3 * n_moe
    for (k, _), a, b in zip(tree_paths(params), remat, once):
        assert torch.equal(a, b), k


# ------------------------------------------------------ the gradient guard
def test_step_raises_when_the_mtp_term_is_dropped():
    """``make_train_step`` raises on a param without a gradient: with the MTP
    term dropped from the loss (its hidden states computed and thrown away),
    the MTP head's subtree gets none, and the step names it before it
    updates anything; with the term, every leaf gets one."""
    cfg = ARCHS["deepseek-v3-671b"].reduced()
    bundle = get_model(cfg)
    state = port_tl.init_train_state(bundle, torch.Generator().manual_seed(5), device="cpu")
    tokens = {"tokens": torch.from_numpy(
        np.random.RandomState(5).randint(0, cfg.vocab, (1, 16))).long()}
    paths = [k for k, _ in tree_paths(state["params"])]
    mtp = [i for i, k in enumerate(paths) if k.startswith("mtp/")]
    dropped = dataclasses.replace(
        bundle, train_hidden=lambda p, batch: (bundle.train_hidden(p, batch)[0], {}))
    before = [t.clone() for t in tree_leaves(state["params"])]
    with pytest.raises(RuntimeError, match=re.escape(
            f"{len(mtp)} of {len(paths)} params got no gradient (leaf indices {mtp[:8]})")):
        port_tl.make_train_step(dropped, port_tl.TrainConfig())(state, tokens)
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(state["params"])))
    state, metrics = port_tl.make_train_step(bundle, port_tl.TrainConfig())(state, tokens)
    assert np.isfinite(metrics["loss"].item())
