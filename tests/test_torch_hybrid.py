"""The port's sliding-window attention and reduced RecurrentGemma-9B (RG-LRU
+ local attention) against the JAX package's, on the CPU.

Both packages compute from the same numpy inputs and the same weights (the
JAX package's ``block_init`` / ``init``, carried by ``params_from_numpy``);
the JAX side runs jitted.  Tolerances: ``block_local_attention`` at rtol =
atol = 2e-2, as tests/test_torch_models.py holds ``chunked_attention``; the
windowed GQA layer's outputs and caches at 2e-2 and its decode at 5e-2, as
the dense GQA layer's; the reduced model's train and prefill logits at 2e-2
and decode logits at 5e-2, as tests/test_arch_smoke.py holds the JAX
package's.

The reference's windowed decode is wrong when the prompt is longer than the
window and not a multiple of it (ROADMAP Queue 3): its prefill keeps the
last W keys from slot 0 while its decode writes position p at slot p % W.
The port lays the ring out as its decode reads it.  ``test_ring_layout``
pins both: at S = 40 and 70 (W = 32) the JAX decode parts from the JAX
windowed forward over the same S + 1 tokens by more than 2e-2 of the
forward's largest output, and the port's decode stays within it; at S = 20,
32 and 64, where the two layouts agree, the port's decode and cache equal
the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import attention as jax_attention
from repro.models import get_model as jax_get_model
from repro.models import layers as jax_layers
from repro.models import transformer as jax_tf
from repro_torch.configs import ARCHS
from repro_torch.models import attention as port_attention
from repro_torch.models import get_model
from repro_torch.models import layers as port_layers
from repro_torch.models.convert import params_from_numpy

ARCH = "recurrentgemma-9b"
B = 2
TOL = dict(rtol=2e-2, atol=2e-2)
DECODE_TOL = dict(rtol=5e-2, atol=5e-2)


def bf16(rng, *shape, scale=1.0):
    """The same bf16 values as a JAX array and as a CPU tensor."""
    a = np.asarray(jnp.asarray(rng.randn(*shape) * scale, jnp.bfloat16))
    return jnp.asarray(a), torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)


def f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def close(got, want, **tol):
    np.testing.assert_allclose(f32(got), f32(want), **tol)


@pytest.mark.parametrize("S", [11, 16, 40], ids=["S<W", "S=W", "S=2.5W"])
def test_block_local_attention(S):
    W = 16
    rng = np.random.RandomState(S)
    (qj, qt), (kj, kt), (vj, vt) = (bf16(rng, B, S, 4, 32), bf16(rng, B, S, 2, 32),
                                    bf16(rng, B, S, 2, 32))
    want = jax.jit(lambda q, k, v: jax_layers.block_local_attention(q, k, v, window=W))(
        qj, kj, vj)
    got = port_layers.block_local_attention(qt, kt, vt, window=W)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, S, 4, 32)
    close(got, want, **TOL)
    # the window: the last query sees exactly the W keys up to itself
    full = port_layers.chunked_attention(qt[:, -1:], kt[:, -W:], vt[:, -W:], causal=False)
    close(got[:, -1:], full, rtol=1e-2, atol=1e-5)


@pytest.fixture(scope="module")
def attn_layer():
    """One windowed attention layer of reduced recurrentgemma-9b (W = 32;
    4 query heads over 1 KV head of 32), both packages."""
    cfg_j, cfg_t = JAX_ARCHS[ARCH].reduced(), ARCHS[ARCH].reduced()
    p = jax.tree.map(np.asarray, jax_tf.block_init(cfg_j, "attn", False, jax.random.PRNGKey(3)))
    return cfg_j, cfg_t, jax.tree.map(jnp.asarray, p), params_from_numpy(p, device="cpu")


@pytest.mark.parametrize("S", [20, 32, 64, 40, 70])
def test_ring_layout(attn_layer, S):
    """Windowed GQA: forward, prefill of S tokens, one decode step at
    position S, against the reference and against the windowed forward over
    the S + 1 tokens (see the module docstring)."""
    cfg_j, cfg_t, pj, pt = attn_layer
    W = cfg_t.attn_window
    rng = np.random.RandomState(S)
    xj, xt = bf16(rng, B, S + 1, cfg_t.d_model)
    fwd_j = jax.jit(lambda p, x: jax_attention.gqa_forward(cfg_j, p, x, window=W))(pj, xj)
    fwd_t = port_attention.gqa_forward(cfg_t, pt, xt, window=W)
    close(fwd_t, fwd_j, **TOL)

    cache_j = jax_attention.gqa_init_cache(cfg_j, B, S + W, window=W)
    cache_t = port_attention.gqa_init_cache(cfg_t, B, S + W, window=W, device="cpu")
    assert tuple(cache_t["k"].shape) == tuple(cache_j["k"].shape) == (B, W, cfg_t.n_kv_heads,
                                                                       cfg_t.resolved_head_dim)
    pre_j, cache_j = jax.jit(
        lambda p, x, c: jax_attention.gqa_prefill(cfg_j, p, x, c, window=W))(
            pj, xj[:, :S], cache_j)
    pre_t, cache_t2 = port_attention.gqa_prefill(cfg_t, pt, xt[:, :S], cache_t, window=W)
    assert cache_t2 is cache_t
    close(pre_t, pre_j, **TOL)
    # the port's ring: position p at slot p % W
    k_all = port_attention.gqa_project_qkv(cfg_t, pt, xt[:, :S], torch.arange(S))[1]
    for p in range(max(0, S - W), S):
        assert torch.equal(cache_t["k"][:, p % W], k_all[:, p])
    dec_j, cache_j = jax.jit(
        lambda p, x, c: jax_attention.gqa_decode(cfg_j, p, x, c, S, window=W))(
            pj, xj[:, S:], cache_j)
    dec_t, _ = port_attention.gqa_decode(cfg_t, pt, xt[:, S:], cache_t, S, window=W)

    scale = float(np.abs(f32(fwd_j)).max())
    port_gap = float(np.abs(f32(dec_t)[:, 0] - f32(fwd_j)[:, S]).max()) / scale
    ref_gap = float(np.abs(f32(dec_j)[:, 0] - f32(fwd_j)[:, S]).max()) / scale
    assert port_gap <= 2e-2, port_gap
    if S <= W or S % W == 0:
        close(dec_t, dec_j, **DECODE_TOL)
        for name in ("k", "v"):
            close(cache_t[name], cache_j[name], **TOL)
    else:
        assert ref_gap > 2e-2, ref_gap   # the reference's fault shows


@pytest.fixture(scope="module")
def hybrid():
    """(JAX config, port config, JAX bundle, JAX params, port params) of
    reduced recurrentgemma-9b: 6 layers, two (rglru, rglru, attn) units."""
    cfg_j = JAX_ARCHS[ARCH].reduced()
    model = jax_get_model(cfg_j)
    p_np = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))
    cfg_t = ARCHS[ARCH].reduced()
    return cfg_j, cfg_t, model, jax.tree.map(jnp.asarray, p_np), params_from_numpy(
        p_np, device="cpu")


def test_hybrid_matches_jax(hybrid):
    """Train logits over 2W + 2 tokens; a prefill of 2W (a length at which
    the reference's ring is right) and two decode steps."""
    cfg_j, cfg_t, model, pj, pt = hybrid
    port = get_model(cfg_t)
    S = 2 * cfg_t.attn_window
    rng = np.random.RandomState(5)
    tokens = rng.randint(0, cfg_t.vocab, (B, S + 2)).astype(np.int32)
    tok_t = torch.from_numpy(tokens).long()
    logits_j, _ = jax.jit(model.train_logits)(pj, {"tokens": tokens})
    logits_t, _ = port.train_logits(pt, {"tokens": tok_t})
    close(logits_t, logits_j, **TOL)
    pre_j, cache_j = jax.jit(model.prefill)(pj, {"tokens": tokens[:, :S]},
                                            model.init_cache(B, S + 8))
    pre_t, cache_t = port.prefill(pt, {"tokens": tok_t[:, :S]},
                                  port.init_cache(B, S + 8, device="cpu"))
    close(pre_t, pre_j, **TOL)
    decode = jax.jit(model.decode_step)
    for pos in (S, S + 1):
        dec_j, cache_j = decode(pj, tokens[:, pos:pos + 1], cache_j, pos)
        dec_t, _ = port.decode_step(pt, tok_t[:, pos:pos + 1], cache_t, pos)
        close(dec_t, dec_j, **DECODE_TOL)


@pytest.mark.parametrize("S", [40, 70])
def test_hybrid_decode_matches_forward(hybrid, S):
    """The port's cache path against its own teacher forcing where the
    reference's ring is wrong (S % W != 0, S > W): the prefill's logits at
    2e-2 and three decode steps at 5e-2."""
    _, cfg_t, _, _, pt = hybrid
    port = get_model(cfg_t)
    rng = np.random.RandomState(S)
    tokens = torch.from_numpy(rng.randint(0, cfg_t.vocab, (B, S + 3))).long()
    full, _ = port.train_logits(pt, {"tokens": tokens})
    pre, cache = port.prefill(pt, {"tokens": tokens[:, :S]},
                              port.init_cache(B, S + 8, device="cpu"))
    close(pre[:, -1], full[:, S - 1], **TOL)
    for pos in (S, S + 1, S + 2):
        dec, _ = port.decode_step(pt, tokens[:, pos:pos + 1], cache, pos)
        close(dec[:, -1], full[:, pos], **DECODE_TOL)
