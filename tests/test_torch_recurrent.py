"""The port's recurrent layers (RG-LRU, RWKV-6) and reduced RWKV-6 against
the JAX package's, on the CPU.

Both packages compute from the same numpy inputs and the same weights: the
JAX package's ``block_init`` / ``init`` draws them and ``params_from_numpy``
carries them into the port.  The JAX side runs jitted, as its model does.

Tolerances:

* ``_rglru_scan`` bit for bit against the jitted JAX scan at S = 1, 7, 40,
  333 and 2048 (odd, even, a power of two): the port combines in
  ``jax.lax.associative_scan``'s order and rounds each multiply-add once,
  as XLA's fused multiply-add does;
* single layers at ``LAYER_TOL`` (rtol 1e-2, about one bf16 rounding step
  of 2**-8 with f32 math ordered differently; atol 1e-5); an f32 state
  computed from the same inputs at ``STATE_TOL`` (rtol 1e-4: f32 math
  ordered differently), and at ``LAYER_TOL`` where a bf16 GEMM of the
  block feeds it; a block's output, a bf16 GEMM whose sums can cancel to
  near zero, at rtol 1e-2 and an atol of 1e-2 of its largest value
  (``close_block``: one bf16 step at the output's scale);
* reduced rwkv6-3b, in both WKV forms: train and prefill logits at rtol =
  atol = 2e-2 and decode logits at 5e-2, as tests/test_arch_smoke.py holds
  the JAX package's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import get_model as jax_get_model
from repro.models import layers as jax_layers
from repro.models import recurrent as jax_rec
from repro.models import transformer as jax_tf
from repro_torch.configs import ARCHS
from repro_torch.models import get_model
from repro_torch.models import layers as port_layers
from repro_torch.models import recurrent as port_rec
from repro_torch.models.convert import params_from_numpy

LAYER_TOL = dict(rtol=1e-2, atol=1e-5)
STATE_TOL = dict(rtol=1e-4, atol=1e-6)
TOL = dict(rtol=2e-2, atol=2e-2)
DECODE_TOL = dict(rtol=5e-2, atol=5e-2)
B = 2


def bf16(rng, *shape, scale=1.0):
    """The same bf16 values as a JAX array and as a CPU tensor."""
    a = np.asarray(jnp.asarray(rng.randn(*shape) * scale, jnp.bfloat16))
    return jnp.asarray(a), torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)


def f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def close(got, want, **tol):
    np.testing.assert_allclose(f32(got), f32(want), **tol)


def close_block(got, want):
    close(got, want, rtol=1e-2, atol=1e-2 * float(np.abs(f32(want)).max()))


def layer(name: str, kind: str, **over):
    """(JAX config, port config, JAX params, port params) of one ``kind``
    block of reduced ``name``."""
    cfg_j = dataclasses.replace(JAX_ARCHS[name].reduced(), **over)
    cfg_t = dataclasses.replace(ARCHS[name].reduced(), **over)
    p_np = jax.tree.map(np.asarray, jax_tf.block_init(cfg_j, kind, False, jax.random.PRNGKey(7)))
    return cfg_j, cfg_t, jax.tree.map(jnp.asarray, p_np), params_from_numpy(p_np, device="cpu")


def port_state(jax_state):
    """A copy of a JAX state tree in the port's form (writable tensors)."""
    return params_from_numpy(jax.tree.map(lambda a: np.array(a), jax_state), device="cpu")


# -------------------------------------------------------------------- RG-LRU
@pytest.mark.parametrize("S", [1, 7, 40, 333, 2048])
def test_rglru_scan_bit_for_bit(S):
    rng = np.random.RandomState(S)
    a = rng.uniform(0.5, 1.0, (B, S, 24)).astype(np.float32)
    bx = rng.randn(B, S, 24).astype(np.float32)
    h0 = rng.randn(B, 24).astype(np.float32)
    hh_j, last_j = jax.jit(jax_rec._rglru_scan)(a, bx, h0)
    hh_t, last_t = port_rec._rglru_scan(*map(torch.from_numpy, (a, bx, h0)))
    assert np.asarray(hh_j).tobytes() == hh_t.numpy().tobytes()
    assert np.asarray(last_j).tobytes() == last_t.numpy().tobytes()


@pytest.fixture(scope="module")
def rglru():
    return layer("recurrentgemma-9b", "rglru")


def test_rglru_apply(rglru):
    cfg_j, cfg_t, pj, pt = rglru
    rng = np.random.RandomState(1)
    (xj, xt), (hj, ht) = bf16(rng, B, 40, cfg_t.lru_width), bf16(rng, B, cfg_t.lru_width)
    yj, lj = jax.jit(lambda p, x, h: jax_rec.rglru_apply(cfg_j, p, x, h))(
        pj, xj, hj.astype(jnp.float32))
    yt, lt = port_rec.rglru_apply(cfg_t, pt, xt, ht.float())
    assert yt.dtype == torch.bfloat16 and lt.dtype == torch.float32
    close(yt, yj, **LAYER_TOL)
    close(lt, lj, **STATE_TOL)


def test_causal_conv(rglru):
    _, cfg_t, pj, pt = rglru
    rng = np.random.RandomState(2)
    K = cfg_t.conv_width
    (xj, xt), (bj, bt) = bf16(rng, B, 9, cfg_t.lru_width), bf16(rng, B, K - 1, cfg_t.lru_width)
    yj, nj = jax.jit(jax_rec._causal_conv)(xj, pj["conv_w"], bj)
    yt, nt = port_rec._causal_conv(xt, pt["conv_w"], bt)
    close(yt, yj, **LAYER_TOL)
    assert f32(nt).tobytes() == f32(nj).tobytes()   # the last K - 1 inputs, as they are


def test_rglru_block_prefill_then_decode(rglru):
    """The state carried from a 40-token prefill through three decode
    steps, in place in the port."""
    cfg_j, cfg_t, pj, pt = rglru
    rng = np.random.RandomState(3)
    xj, xt = bf16(rng, B, 43, cfg_t.d_model)
    step = jax.jit(lambda p, x, s: jax_rec.rglru_block(cfg_j, p, x, s))
    st_j = jax_rec.rglru_init_state(cfg_j, B)
    st_t = port_rec.rglru_init_state(cfg_t, B, device="cpu")
    for lo, hi in ((0, 40), (40, 41), (41, 42), (42, 43)):
        yj, st_j = step(pj, xj[:, lo:hi], st_j)
        yt, st_t2 = port_rec.rglru_block(cfg_t, pt, xt[:, lo:hi], st_t)
        assert st_t2 is st_t
        close_block(yt, yj)
        close(st_t["h"], st_j["h"], **LAYER_TOL)
        close(st_t["conv"], st_j["conv"], **LAYER_TOL)


# -------------------------------------------------------------------- RWKV-6
def test_group_norm_heads():
    rng = np.random.RandomState(4)
    x = (rng.randn(B, 8, 4, 32) * 3 + 1).astype(np.float32)
    scale, bias = rng.randn(4, 32).astype(np.float32), rng.randn(4, 32).astype(np.float32)
    want = jax_layers.group_norm_heads(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    got = port_layers.group_norm_heads(*map(torch.from_numpy, (x, scale, bias)))
    close(got, want, rtol=1e-5, atol=1e-5)
    xj, xt = bf16(rng, B, 8, 4, 32)
    close(port_layers.group_norm_heads(xt, torch.from_numpy(scale), torch.from_numpy(bias)),
          jax_layers.group_norm_heads(xj, jnp.asarray(scale), jnp.asarray(bias)), **LAYER_TOL)


@pytest.fixture(scope="module", params=["scan", "chunked"])
def rwkv(request):
    return layer("rwkv6-3b", "rwkv", rwkv_impl=request.param)


def rwkv_state(cfg, rng):
    """A non-zero RWKV state, as the JAX package holds it."""
    H, hd, D = cfg.n_heads, cfg.rwkv_head_dim, cfg.d_model
    return {
        "time": {"s": jnp.asarray(rng.randn(B, H, hd, hd).astype(np.float32) * 0.1),
                 "x_last": bf16(rng, B, D)[0]},
        "chan": {"x_last": bf16(rng, B, D)[0]},
    }


def test_rwkv_time_mix(rwkv):
    """Both WKV forms (64 tokens: the chunked form under ``"chunked"``),
    then one decode step (the scan), from a non-zero state."""
    cfg_j, cfg_t, pj, pt = rwkv
    rng = np.random.RandomState(5)
    xj, xt = bf16(rng, B, 65, cfg_t.d_model)
    st_j = rwkv_state(cfg_j, rng)["time"]
    st_t = port_state(st_j)
    mix = jax.jit(lambda p, x, s: jax_rec.rwkv_time_mix(cfg_j, p, x, s))
    for lo, hi in ((0, 64), (64, 65)):
        yj, st_j = mix(pj, xj[:, lo:hi], st_j)
        yt, _ = port_rec.rwkv_time_mix(cfg_t, pt, xt[:, lo:hi], st_t)
        close_block(yt, yj)
        close(st_t["s"], st_j["s"], **STATE_TOL)
        assert f32(st_t["x_last"]).tobytes() == f32(st_j["x_last"]).tobytes()


def test_wkv_forms_agree(rwkv):
    """The chunked WKV against the sequential scan, both in the port, on
    the same f32 inputs (decays away from the clamp): rtol 1e-4."""
    _, cfg_t, _, _ = rwkv
    rng = np.random.RandomState(6)
    H, hd = cfg_t.n_heads, cfg_t.rwkv_head_dim
    r, k, v = (torch.from_numpy(rng.randn(B, 64, H, hd).astype(np.float32)) for _ in range(3))
    w = torch.from_numpy(rng.uniform(0.3, 0.99, (B, 64, H, hd)).astype(np.float32))
    u = torch.from_numpy(rng.randn(H, hd).astype(np.float32))
    s0 = torch.from_numpy(rng.randn(B, H, hd, hd).astype(np.float32))
    out_s, s_s = port_rec._wkv_scan(r, k, v, w, u, s0)
    out_c, s_c = port_rec._wkv_chunked(r, k, v, w, u, s0)
    close(out_c, out_s, rtol=1e-4, atol=1e-4)
    close(s_c, s_s, rtol=1e-4, atol=1e-4)


def test_rwkv_channel_mix(rwkv):
    cfg_j, cfg_t, pj, pt = rwkv
    rng = np.random.RandomState(7)
    xj, xt = bf16(rng, B, 9, cfg_t.d_model)
    st_j = rwkv_state(cfg_j, rng)["chan"]
    st_t = port_state(st_j)
    yj, st_j = jax.jit(lambda p, x, s: jax_rec.rwkv_channel_mix(cfg_j, p, x, s))(pj, xj, st_j)
    yt, _ = port_rec.rwkv_channel_mix(cfg_t, pt, xt, st_t)
    close_block(yt, yj)
    assert f32(st_t["x_last"]).tobytes() == f32(st_j["x_last"]).tobytes()


# ----------------------------------------------------------------- the model
@pytest.mark.parametrize("impl", ["scan", "chunked"])
def test_rwkv_model_matches_jax(impl):
    """Reduced rwkv6-3b (4 layers, 4 heads of 32): train logits, a 64-token
    prefill (the chunked form under ``"chunked"``) and two decode steps,
    and the port's own cache path against its teacher forcing."""
    cfg_j = dataclasses.replace(JAX_ARCHS["rwkv6-3b"].reduced(), rwkv_impl=impl)
    cfg_t = dataclasses.replace(ARCHS["rwkv6-3b"].reduced(), rwkv_impl=impl)
    model, port = jax_get_model(cfg_j), get_model(cfg_t)
    p_np = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))
    pj, pt = jax.tree.map(jnp.asarray, p_np), params_from_numpy(p_np, device="cpu")
    S = 64
    rng = np.random.RandomState(8)
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
    close(pre_t[:, -1], logits_t[:, S - 1], **TOL)
    decode = jax.jit(model.decode_step)
    for pos in (S, S + 1):
        dec_j, cache_j = decode(pj, tokens[:, pos:pos + 1], cache_j, pos)
        dec_t, _ = port.decode_step(pt, tok_t[:, pos:pos + 1], cache_t, pos)
        close(dec_t, dec_j, **DECODE_TOL)
        close(dec_t[:, -1], logits_t[:, pos], **DECODE_TOL)
