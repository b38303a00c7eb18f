"""The port's MLA attention and reduced DeepSeek-V3 against the JAX
package's, on the CPU.

One MLA layer of reduced DeepSeek-V3 (drawn by the JAX package's
``block_init``) through ``mla_forward``, and through ``mla_prefill`` then
``mla_decode`` in both cache forms: the full ``{"k", "v"}`` cache and the
compressed ``{"ckv"}`` latent, whose decode is the absorbed-weight f32 path.
Outputs and caches are held at rtol = atol = 2e-2 and decode at 5e-2, as
the GQA tests are (tests/test_torch_models.py).  Then reduced DeepSeek-V3
as a whole (three MLA + MoE layers behind one dense layer, a shared expert,
the MTP head): train logits with ``mtp_logits``, prefill and decode in both
cache forms, where positions at a near-tie route are left out
(tests/torch_moe_routes.py); its parameter tree; and the reference's
``count_params``, which counts the MTP block as a GQA block, copied.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import attention as jax_attention
from repro.models import get_model as jax_get_model
from repro.models import transformer as jax_tf
from repro.models.registry import count_params as jax_count_params
from repro_torch.configs import ARCHS
from repro_torch.models import attention as port_attention
from repro_torch.models import count_params, get_model
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from torch_moe_routes import assert_close_off_ties, recorded_margins

ARCH = "deepseek-v3-671b"
B, S = 2, 64
TOL = dict(rtol=2e-2, atol=2e-2)
DECODE_TOL = dict(rtol=5e-2, atol=5e-2)
FORMS = {"full": False, "compressed": True}


def f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def close(got, want, **tol):
    np.testing.assert_allclose(f32(got), f32(want), **tol)


def configs(form):
    return tuple(dataclasses.replace(a[ARCH].reduced(), mla_compressed_cache=FORMS[form])
                 for a in (JAX_ARCHS, ARCHS))


# -------------------------------------------------------------- MLA layer
@pytest.fixture(scope="module")
def mla_layer():
    cfg_j = JAX_ARCHS[ARCH].reduced()
    p = jax_tf.block_init(cfg_j, "mla", False, jax.random.PRNGKey(3))
    return jax.tree.map(np.asarray, p)


def _x(seed, *shape):
    a = np.asarray(jnp.asarray(np.random.RandomState(seed).randn(*shape), jnp.bfloat16))
    return jnp.asarray(a), params_from_numpy(a, device="cpu")


def test_mla_forward(mla_layer):
    cfg_j, cfg_t = configs("full")
    xj, xt = _x(4, B, S, cfg_t.d_model)
    want = jax.jit(lambda p, x: jax_attention.mla_forward(cfg_j, p, x))(mla_layer, xj)
    got = port_attention.mla_forward(cfg_t, params_from_numpy(mla_layer, device="cpu"), xt)
    assert got.dtype == torch.bfloat16
    close(got, want, **TOL)


@pytest.mark.parametrize("form", list(FORMS))
def test_mla_prefill_then_decode(mla_layer, form):
    cfg_j, cfg_t = configs(form)
    pj = jax.tree.map(jnp.asarray, mla_layer)
    pt = params_from_numpy(mla_layer, device="cpu")
    xj, xt = _x(5, B, S, cfg_t.d_model)
    cache_j = jax_attention.mla_init_cache(cfg_j, B, S + 4)
    cache_t = port_attention.mla_init_cache(cfg_t, B, S + 4, device="cpu")
    assert sorted(cache_t) == sorted(cache_j) == (["ckv"] if form == "compressed" else ["k", "v"])
    out_j, cache_j = jax.jit(lambda p, x, c: jax_attention.mla_prefill(cfg_j, p, x, c))(
        pj, xj, cache_j)
    out_t, cache_t2 = port_attention.mla_prefill(cfg_t, pt, xt, cache_t)
    assert cache_t2 is cache_t  # written in place
    close(out_t, out_j, **TOL)
    for name in cache_t:
        assert tuple(cache_t[name].shape) == cache_j[name].shape
        close(cache_t[name], cache_j[name], **TOL)
    tj, tt = _x(6, B, 1, cfg_t.d_model)
    dec_j, cache_j = jax.jit(lambda p, x, c: jax_attention.mla_decode(cfg_j, p, x, c, S))(
        pj, tj, cache_j)
    dec_t, _ = port_attention.mla_decode(cfg_t, pt, tt, cache_t, S)
    close(dec_t, dec_j, **DECODE_TOL)
    for name in cache_t:
        close(cache_t[name], cache_j[name], **TOL)


# ---------------------------------------------------------------- the model
@pytest.fixture(scope="module")
def deepseek():
    """(JAX params of reduced DeepSeek-V3 as numpy, the port's copy)."""
    model = jax_get_model(JAX_ARCHS[ARCH].reduced())
    p_np = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))
    return p_np, params_from_numpy(p_np, device="cpu")


@pytest.mark.parametrize("form", list(FORMS))
def test_deepseek_matches_jax(deepseek, form):
    cfg_j, cfg_t = configs(form)
    model, port = jax_get_model(cfg_j), get_model(cfg_t)
    p_np, pt = deepseek
    pj = jax.tree.map(jnp.asarray, p_np)
    rng = np.random.RandomState(5)
    tokens = rng.randint(0, cfg_t.vocab, (B, S)).astype(np.int32)
    nxt = rng.randint(0, cfg_t.vocab, (B, 1)).astype(np.int32)
    tok_t, nxt_t = torch.from_numpy(tokens).long(), torch.from_numpy(nxt).long()

    if form == "full":  # the cache form does not reach teacher forcing
        logits_j, aux_j = jax.jit(lambda p, b: model.train_logits(p, b))(pj, {"tokens": tokens})
        with recorded_margins() as margins:
            logits_t, aux_t = port.train_logits(pt, {"tokens": tok_t})
        assert tuple(logits_t.shape) == (B, S, cfg_t.padded_vocab)
        assert tuple(aux_t["mtp_logits"].shape) == (B, S - 1, cfg_t.padded_vocab)
        assert_close_off_ties(logits_t, logits_j, margins, **TOL)
        # the MTP block is dense: its positions' routes are those of the trunk
        assert_close_off_ties(aux_t["mtp_logits"], aux_j["mtp_logits"],
                              [m[:, :-1] for m in margins], **TOL)

    pre_j, cache_j = jax.jit(lambda p, b, c: model.prefill(p, b, c))(
        pj, {"tokens": tokens}, model.init_cache(B, S + 8))
    with recorded_margins() as margins:
        pre_t, cache_t = port.prefill(pt, {"tokens": tok_t}, port.init_cache(B, S + 8, device="cpu"))
    assert_close_off_ties(pre_t, pre_j, [m[:, -1:] for m in margins], **TOL)
    for seg_t, seg_j in zip(cache_t, cache_j):
        for unit_t, unit_j in zip(seg_t, seg_j):
            assert sorted(unit_t) == sorted(unit_j)

    dec_j, _ = jax.jit(lambda p, t, c: model.decode_step(p, t, c, S))(pj, nxt, cache_j)
    with recorded_margins() as margins:
        dec_t, _ = port.decode_step(pt, nxt_t, cache_t, S)
    assert_close_off_ties(dec_t, dec_j, margins, **DECODE_TOL)


@pytest.mark.parametrize("form", list(FORMS))
def test_deepseek_prefill_then_decode_matches_forward(deepseek, form):
    """The port's cache paths against its own teacher forcing."""
    _, cfg_t = configs(form)
    port = get_model(cfg_t)
    _, pt = deepseek
    tokens = torch.from_numpy(np.random.RandomState(6).randint(0, cfg_t.vocab, (B, S + 1))).long()
    full, _ = port.train_logits(pt, {"tokens": tokens})
    pre, cache = port.prefill(pt, {"tokens": tokens[:, :S]}, port.init_cache(B, S + 8, device="cpu"))
    close(pre[:, -1], full[:, S - 1], **TOL)
    dec, _ = port.decode_step(pt, tokens[:, S:], cache, S)
    close(dec[:, -1], full[:, S], **DECODE_TOL)


def test_deepseek_params_tree(deepseek):
    """The port's init draws the JAX tree's shapes and dtypes (f32 routers,
    the ``mtp`` subtree with an MLA block and a dense MLP), and the JAX
    weights round-trip bit for bit."""
    p_np, pt = deepseek
    cfg_t = ARCHS[ARCH].reduced()
    drawn = get_model(cfg_t).init(torch.Generator().manual_seed(0), device="cpu")
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), p_np)
    got = jax.tree.map(lambda a: (a.shape, str(a.dtype)), params_to_numpy(drawn))
    assert got == want
    assert sorted(drawn["mtp"]) == ["block", "proj"]
    assert "wkv_b" in drawn["mtp"]["block"] and "mlp" in drawn["mtp"]["block"]
    routers = [unit["moe"]["router"] for seg in drawn["segments"] for unit in seg
               if "moe" in unit]
    assert routers and all(r.dtype == torch.float32 for r in routers)
    back, back_def = jax.tree.flatten(params_to_numpy(pt))
    orig, orig_def = jax.tree.flatten(p_np)
    assert back_def == orig_def
    assert all(g.dtype == w.dtype and g.tobytes() == w.tobytes() for g, w in zip(back, orig))


def test_count_params_counts_mtp_as_gqa(deepseek):
    """The reference's ``count_params`` counts the MTP block as a GQA block
    though the tree holds an MLA block there; the port copies it.  At the
    reduced config: 1,000,960 counted against the tree's 986,624 non-norm
    parameters, 14,336 = one GQA block's projections less one MLA block's."""
    p_np, _ = deepseek
    cfg_j, cfg_t = configs("full")
    tree = sum(a.size for path, a in jax.tree_util.tree_flatten_with_path(p_np)[0]
               if "norm" not in jax.tree_util.keystr(path))
    D, H, hd = cfg_t.d_model, cfg_t.n_heads, cfg_t.resolved_head_dim
    qr, kvr = cfg_t.q_lora_rank, cfg_t.kv_lora_rank
    rd, nd, vd = cfg_t.qk_rope_head_dim, cfg_t.qk_nope_head_dim, cfg_t.v_head_dim
    attn_p = D * H * hd + 2 * D * cfg_t.n_kv_heads * hd + H * hd * D
    mla_p = (D * qr + qr * H * (nd + rd) + D * (kvr + rd) + kvr * H * (nd + vd)
             + H * vd * D)
    assert tree == 986_624
    assert count_params(cfg_t) == jax_count_params(cfg_j) == 1_000_960
    assert count_params(cfg_t) - tree == attn_p - mla_p == 14_336
