"""The port's dense attention routes by shape, on the CPU.

``_full_attention`` sends a shape to the flash kernel only where the JAX
package's opt-in path would take it *and* the CUDA kernel takes it (head dim
in ``HEAD_DIMS``, at most ``MAX_GROUP`` query heads per KV head, bf16 on the
card); every other shape goes to ``chunked_attention`` before any launch.
The head-dim and group conditions hold on every device, so the CPU takes
the route the card would.  Each result is held against the JAX package's
``_full_attention`` under ``REPRO_FLASH_ATTN=1`` (its Pallas kernel in
interpret mode) within the 2e-2 that ``tests/test_torch_models.py`` states
for flash against chunked.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jax_attention
from repro_torch.kernels import flash_attention as tflash
from repro_torch.models import attention as port_attention

TOL = dict(rtol=2e-2, atol=2e-2)


def _qkv(seed, B, S, H, KV, hd):
    rng = np.random.RandomState(seed)
    out = []
    for heads in (H, KV, KV):
        a = np.asarray(jnp.asarray(rng.randn(B, S, heads, hd), jnp.bfloat16))
        out.append((jnp.asarray(a),
                    torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)))
    return out


@pytest.fixture
def routes(monkeypatch):
    """Which way each ``_full_attention`` call went."""
    seen = []
    flash, chunked = port_attention.flash_attention, port_attention.chunked_attention

    def spy_flash(*a, **kw):
        seen.append("flash")
        return flash(*a, **kw)

    def spy_chunked(*a, **kw):
        seen.append("chunked")
        return chunked(*a, **kw)

    monkeypatch.setattr(port_attention, "flash_attention", spy_flash)
    monkeypatch.setattr(port_attention, "chunked_attention", spy_chunked)
    monkeypatch.setenv("REPRO_FLASH_ATTN", "1")
    return seen


@pytest.mark.parametrize("case", [
    # label, B, S, H, KV, hd, route
    ("hd 256, GQA", 1, 128, 4, 2, 256, "chunked"),
    ("H / KV = 72", 1, 128, 72, 1, 32, "chunked"),
    ("hd 128, H / KV = 3", 1, 128, 6, 2, 128, "flash"),
    ("H / KV = 64", 1, 128, 64, 1, 32, "flash"),
], ids=lambda c: c[0])
def test_route_by_shape(routes, case):
    _, B, S, H, KV, hd, route = case
    before = tflash.flash_attention.launches
    (qj, qt), (kj, kt), (vj, vt) = _qkv(hd + H, B, S, H, KV, hd)
    got = port_attention._full_attention(qt, kt, vt, causal=True)
    want = jax_attention._full_attention(qj, kj, vj, causal=True)
    assert routes == [route]
    assert tflash.flash_attention.launches == before  # the CPU never launches
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, H, hd)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOL)


def test_kernel_takes():
    def qkv(H, KV, hd, dtype=torch.bfloat16):
        return (torch.zeros((1, 128, H, hd), dtype=dtype),
                torch.zeros((1, 128, KV, hd), dtype=dtype),
                torch.zeros((1, 128, KV, hd), dtype=dtype))

    for hd in tflash.HEAD_DIMS:
        assert tflash.kernel_takes(*qkv(8, 2, hd))
    assert not tflash.kernel_takes(*qkv(8, 2, 256))
    assert not tflash.kernel_takes(*qkv(8, 2, 96))
    assert tflash.kernel_takes(*qkv(tflash.MAX_GROUP, 1, 64))
    assert not tflash.kernel_takes(*qkv(tflash.MAX_GROUP + 8, 1, 64))
    # on the CPU the dtype does not change the route: f32 goes where bf16 does
    assert tflash.kernel_takes(*qkv(8, 2, 64, torch.float32))


def test_f32_keeps_its_route_on_the_cpu(routes):
    q = torch.randn((1, 128, 4, 64))
    k, v = torch.randn((1, 128, 2, 64)), torch.randn((1, 128, 2, 64))
    port_attention._full_attention(q, k, v, causal=True)
    assert routes == ["flash"]
