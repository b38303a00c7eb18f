"""The port's flash attention (its plain version, on the CPU) against the JAX
package's Pallas kernel in interpret mode and against the port's chunked
online softmax, on the cases of tests/test_flash_attention.py at its
tolerance; and ``_full_attention``'s gate against the JAX package's opt-in
path (``REPRO_FLASH_ATTN=1``)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jax_flash_mod
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention import flash_hbm_bytes as jax_hbm_bytes
from repro.models import attention as jax_attention
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels.flash_attention import flash_attention, flash_hbm_bytes
from repro_torch.models import attention as port_attention
from repro_torch.models.layers import chunked_attention

TOL = dict(rtol=3e-2, atol=3e-2)

CASES = [
    # B, Sq, Sk, H, KV, hd, causal, bq, bk
    (2, 512, 512, 8, 2, 64, True, 256, 256),
    (1, 1024, 1024, 4, 4, 128, True, 512, 512),
    (2, 512, 512, 8, 8, 64, False, 128, 256),
    (1, 256, 256, 6, 2, 32, True, 128, 128),
    (2, 256, 256, 4, 1, 64, True, 128, 64),   # MQA
]


def _inputs(seed, B, Sq, Sk, H, KV, hd):
    """bf16 q, k, v as numpy (ml_dtypes) arrays and as CPU tensors."""
    rng = np.random.RandomState(seed)
    arrays = [np.asarray(jnp.asarray(rng.randn(B, S, n, hd), jnp.bfloat16))
              for S, n in ((Sq, H), (Sk, KV), (Sk, KV))]
    tensors = [torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16) for a in arrays]
    return arrays, tensors


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("case", CASES, ids=[str(c[:6]) for c in CASES])
def test_matches_jax_kernel_and_chunked(case):
    B, Sq, Sk, H, KV, hd, causal, bq, bk = case
    (qa, ka, va), (q, k, v) = _inputs(sum(case[:6]), B, Sq, Sk, H, KV, hd)
    want = jax_flash(qa, ka, va, causal=causal, block_q=bq, block_k=bk)
    got = flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, Sq, H, hd)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL)
    chunked = chunked_attention(q, k, v, causal=causal, chunk=min(256, Sk))
    np.testing.assert_allclose(_f32(got), _f32(chunked), **TOL)


def test_block_shape_sweep():
    (qa, ka, va), (q, k, v) = _inputs(7, 1, 512, 512, 4, 2, 64)
    chunked = chunked_attention(q, k, v, causal=True, chunk=128)
    for bq, bk in [(64, 64), (128, 256), (256, 128), (512, 512)]:
        got = flash_attention(q, k, v, causal=True, block_q=bq, block_k=bk)
        want = jax_flash(qa, ka, va, causal=True, block_q=bq, block_k=bk)
        np.testing.assert_allclose(_f32(got), _f32(want), **TOL)
        np.testing.assert_allclose(_f32(got), _f32(chunked), **TOL)


def test_scale_override():
    (qa, ka, va), (q, k, v) = _inputs(8, 1, 256, 256, 4, 4, 32)
    s = 1.0 / math.sqrt(57.0)
    got = flash_attention(q, k, v, causal=True, softmax_scale=s, block_q=128, block_k=128)
    want = jax_flash(qa, ka, va, causal=True, softmax_scale=s, block_q=128, block_k=128)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL)
    chunked = chunked_attention(q, k, v, causal=True, softmax_scale=s, chunk=128)
    np.testing.assert_allclose(_f32(got), _f32(chunked), **TOL)
    # the override matters: the default scale gives another result
    default = flash_attention(q, k, v, causal=True, block_q=128, block_k=128)
    assert float((default.float() - got.float()).abs().max()) > 1e-2


def test_traffic_model_is_the_jax_packages():
    for shape in [(32, 32768, 32768, 64, 8, 128), (8, 2048, 2048, 24, 8, 128),
                  (2, 256, 256, 4, 1, 64)]:
        assert flash_hbm_bytes(*shape) == jax_hbm_bytes(*shape)


def test_cpu_runs_the_plain_version_and_counts_no_launch():
    (_, _, _), (q, k, v) = _inputs(3, 1, 128, 128, 2, 1, 32)
    before = flash_attention.launches
    out = flash_attention(q, k, v)
    assert flash_attention.launches == before
    from repro_torch.kernels.ref import flash_attention_ref

    assert torch.equal(out, flash_attention_ref(q, k, v, causal=True, block_k=128))


def test_bad_arguments_raise():
    q = torch.zeros((1, 128, 4, 32), dtype=torch.bfloat16)
    kv = torch.zeros((1, 128, 3, 32), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of KV"):
        flash_attention(q, kv, kv)
    kv = torch.zeros((1, 128, 2, 32), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="must divide"):
        flash_attention(q, kv, kv, block_q=96)
    meta = torch.empty((1, 128, 4, 32), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        flash_attention(meta, meta, meta)


# (B, Sq, Sk, H, KV, hd_qk, hd_v): which shapes does the gate send to flash?
GATE_SHAPES = [
    (1, 128, 128, 2, 1, 32, 32),      # flash, blocks 128
    (1, 512, 512, 2, 1, 32, 32),      # flash, blocks 512
    (1, 1152, 1152, 2, 1, 32, 32),    # flash, blocks 128 (not a multiple of 512)
    (1, 1024, 512, 2, 2, 32, 32),     # flash, Sq != Sk
    (1, 100, 100, 2, 1, 32, 32),      # chunked: not a multiple of 128
    (1, 128, 100, 2, 1, 32, 32),      # chunked: Sk
    (1, 1, 128, 2, 1, 32, 32),        # chunked: a decode step
    (1, 128, 128, 2, 1, 48, 32),      # chunked: MLA's head dims differ
]


@pytest.mark.parametrize("causal", [True, False])
def test_gate_routes_as_the_jax_opt_in_path(monkeypatch, causal):
    monkeypatch.setenv("REPRO_FLASH_ATTN", "1")
    jax_calls, port_calls = [], []

    def jax_spy(q, k, v, *, causal, block_q, block_k):
        jax_calls.append((q.shape, causal, block_q, block_k))
        return jnp.zeros(q.shape[:3] + (v.shape[-1],), q.dtype)

    def port_spy(q, k, v, *, causal, block_q, block_k):
        port_calls.append((tuple(q.shape), causal, block_q, block_k))
        return torch.zeros(tuple(q.shape[:3]) + (v.shape[-1],), dtype=q.dtype)

    monkeypatch.setattr(jax_flash_mod, "flash_attention", jax_spy)
    monkeypatch.setattr(port_attention, "flash_attention", port_spy)
    for B, Sq, Sk, H, KV, hd, hd_v in GATE_SHAPES:
        q = torch.zeros((B, Sq, H, hd), dtype=torch.bfloat16)
        k = torch.zeros((B, Sk, KV, hd), dtype=torch.bfloat16)
        v = torch.zeros((B, Sk, KV, hd_v), dtype=torch.bfloat16)
        n_jax, n_port = len(jax_calls), len(port_calls)
        jax_attention._full_attention(jnp.zeros(q.shape, jnp.bfloat16),
                                      jnp.zeros(k.shape, jnp.bfloat16),
                                      jnp.zeros(v.shape, jnp.bfloat16), causal=causal)
        port_attention._full_attention(q, k, v, causal=causal)
        took_jax, took_port = len(jax_calls) > n_jax, len(port_calls) > n_port
        assert took_jax == took_port, (Sq, Sk, hd, hd_v)
    assert [(tuple(s), c, bq, bk) for s, c, bq, bk in jax_calls] == port_calls
    assert len(port_calls) == 4 and all(c[1] == causal for c in port_calls)
    assert [c[2:] for c in port_calls] == [(128, 128), (512, 512), (128, 128), (512, 512)]


@pytest.mark.parametrize("causal", [True, False])
def test_key_tile_of_the_cuda_kernel_matches_jax_kernel(causal):
    """The plain version over 128-key blocks, the CUDA kernel's key tile, at
    g = 3 (128 folded rows are 42 2/3 positions) and Sq != Sk, against the
    JAX kernel at the same blocks."""
    B, Sq, Sk, H, KV, hd = 1, 256, 384, 6, 2, 64
    (qa, ka, va), (q, k, v) = _inputs(11 + causal, B, Sq, Sk, H, KV, hd)
    want = jax_flash(qa, ka, va, causal=causal, block_q=128, block_k=128)
    got = flash_attention(q, k, v, causal=causal, block_q=128, block_k=128)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL)
    chunked = chunked_attention(q, k, v, causal=causal, chunk=128)
    np.testing.assert_allclose(_f32(got), _f32(chunked), **TOL)


def test_strided_views_of_a_fused_qkv_tensor():
    """q, k and v as views of one (B, S, H + 2 KV, hd) tensor, as a fused
    projection would give them: read through their strides, the same answer
    as contiguous copies and as the JAX kernel."""
    B, S, H, KV, hd = 2, 256, 6, 2, 32
    rng = np.random.RandomState(12)
    fused_a = np.asarray(jnp.asarray(rng.randn(B, S, H + 2 * KV, hd), jnp.bfloat16))
    fused = torch.from_numpy(fused_a.view(np.uint16).copy()).view(torch.bfloat16)
    q, k, v = fused[:, :, :H], fused[:, :, H:H + KV], fused[:, :, H + KV:]
    assert not (q.is_contiguous() or k.is_contiguous() or v.is_contiguous())
    got = flash_attention(q, k, v, causal=True, block_q=128, block_k=128)
    copies = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=True,
                             block_q=128, block_k=128)
    assert torch.equal(got, copies)
    want = jax_flash(*(np.ascontiguousarray(x) for x in (
        fused_a[:, :, :H], fused_a[:, :, H:H + KV], fused_a[:, :, H + KV:])),
        causal=True, block_q=128, block_k=128)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL)
