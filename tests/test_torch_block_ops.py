"""The port's XOR delta and block hash against the JAX package's, on the CPU.

Inputs are made from a seed with numpy and handed to both packages; the JAX
side runs its Pallas kernels in interpret mode (as tests/test_kernels.py
does), the port's wrappers take their plain PyTorch versions because the
tensors lie on the CPU.  Integer arithmetic only, so every comparison is
bit-exact; full-range int32 data makes the hash wrap.  The CUDA kernels
themselves are held against the same plain versions on the card by
chip_smoke.py (phases a and j).

Also here: the launch counters stay exact under concurrent increments (the
service's reader threads launch kernels), and ``EdgeArrays.to_torch``
defaults to the card like every other entry point of the port.
"""

import inspect
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.block_diff import block_hash as jax_hash
from repro.kernels.block_diff import hash_coefficients as jax_coef
from repro.kernels.xor_delta import xor_delta as jax_xor
from repro_torch.core import EdgeArrays
from repro_torch.kernels import count_launch, ops, ref
from repro_torch.kernels.block_diff import block_hash, hash_coefficients
from repro_torch.kernels.xor_delta import xor_delta

# rows per Pallas program (256 by default) not dividing nb, and the edges
NB_SWEEP = [1, 2, 7, 64, 255, 256, 257, 300]


def rand_blocks(rng, nb):
    return rng.randint(-(2**31), 2**31, size=(nb, 8, 128), dtype=np.int64).astype(np.int32)


def T(a):
    return torch.from_numpy(np.array(a))


def assert_same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


class TestXorDelta:
    @pytest.mark.parametrize("nb", NB_SWEEP)
    def test_matches_jax(self, nb):
        rng = np.random.RandomState(nb)
        a, b = rand_blocks(rng, nb), rand_blocks(rng, nb)
        assert_same(xor_delta(T(a), T(b)), jax_xor(jnp.asarray(a), jnp.asarray(b)))

    @pytest.mark.parametrize("rows", [1, 8, 64, 256])
    def test_matches_jax_rows_per_program(self, rows):
        rng = np.random.RandomState(rows)
        a, b = rand_blocks(rng, 129), rand_blocks(rng, 129)
        want = jax_xor(jnp.asarray(a), jnp.asarray(b), rows_per_program=rows)
        assert_same(xor_delta(T(a), T(b)), want)

    def test_self_inverse(self):
        rng = np.random.RandomState(0)
        a, b = T(rand_blocks(rng, 33)), T(rand_blocks(rng, 33))
        assert torch.equal(xor_delta(a, xor_delta(a, b)), b)

    def test_zero_delta(self):
        a = T(rand_blocks(np.random.RandomState(1), 17))
        assert not bool(xor_delta(a, a.clone()).any())

    def test_ops_round_trip_matches_jax(self):
        rng = np.random.RandomState(8)
        a = rng.randn(513, 129).astype(np.float32)
        b = a * 1.5
        ab, meta = ops.to_blocks(torch.from_numpy(a))
        bb, _ = ops.to_blocks(torch.from_numpy(b))
        d = ops.xor_encode(ab, bb)
        jab, _ = jops.to_blocks(jnp.asarray(a))
        jbb, _ = jops.to_blocks(jnp.asarray(b))
        assert_same(d, jops.xor_encode(jab, jbb))
        rec = ops.from_blocks(ops.xor_apply(ab, d), meta)
        np.testing.assert_array_equal(rec.numpy(), b)

    def test_refuses_mismatched_blocks(self):
        a = torch.zeros((4, 8, 128), dtype=torch.int32)
        with pytest.raises(ValueError, match="shape mismatch"):
            xor_delta(a, torch.zeros((5, 8, 128), dtype=torch.int32))
        with pytest.raises(ValueError, match="int32"):
            xor_delta(a.float(), a.float())


class TestBlockHash:
    def test_coefficients_match_jax(self):
        got = hash_coefficients()
        want = jax_coef()
        assert got.dtype == want.dtype == np.int32 and got.shape == (8, 128)
        np.testing.assert_array_equal(got, want)
        assert (got % 2 != 0).all()  # odd multipliers
        np.testing.assert_array_equal(hash_coefficients(7), jax_coef(7))

    @pytest.mark.parametrize("nb", NB_SWEEP)
    def test_matches_jax_full_range(self, nb):
        rng = np.random.RandomState(nb)
        x = rand_blocks(rng, nb)
        coef = hash_coefficients()
        want = jax_hash(jnp.asarray(x), jnp.asarray(coef))
        assert_same(block_hash(T(x), T(coef)), want)
        assert_same(ops.block_hashes(T(x)), jops.block_hashes(jnp.asarray(x)))

    def test_sums_wrap_mod_2_32(self):
        # Python integers give the exact sums; full-range data leaves int32
        rng = np.random.RandomState(5)
        x = rand_blocks(rng, 6)
        coef = hash_coefficients()
        exact = (x.astype(object) * coef.astype(object)).sum(axis=(1, 2))
        assert any(not -(2**31) <= e < 2**31 for e in exact)
        want = [((int(e) + 2**31) % 2**32) - 2**31 for e in exact]
        assert ops.block_hashes(T(x)).tolist() == want
        assert ref.block_hash_ref(T(x), T(coef))[:, 0].tolist() == want

    def test_extreme_values(self):
        x = np.full((3, 8, 128), -(2**31), np.int32)
        x[1] = 2**31 - 1
        x[2, ::2] = -1
        assert_same(ops.block_hashes(T(x)), jops.block_hashes(jnp.asarray(x)))

    def test_equal_blocks_equal_hashes(self):
        x = rand_blocks(np.random.RandomState(3), 4)
        x[2] = x[0]
        h = ops.block_hashes(T(x))
        assert h[2] == h[0] and h[1] != h[0]

    def test_refuses_bad_coefficients(self):
        x = torch.zeros((2, 8, 128), dtype=torch.int32)
        with pytest.raises(ValueError, match="coef"):
            block_hash(x, torch.zeros((8, 64), dtype=torch.int32))


class TestInputsUntouched:
    def test_wrappers_do_not_write_into_arguments(self):
        rng = np.random.RandomState(11)
        a, b = T(rand_blocks(rng, 9)), T(rand_blocks(rng, 9))
        coef = T(hash_coefficients())
        before = [a.clone(), b.clone(), coef.clone()]
        outs = [xor_delta(a, b), ops.xor_encode(a, b), ops.xor_apply(a, b),
                block_hash(a, coef), ops.block_hashes(b)]
        for t, t0 in zip((a, b, coef), before):
            assert torch.equal(t, t0)
        ptrs = {a.data_ptr(), b.data_ptr(), coef.data_ptr()}
        assert all(o.data_ptr() not in ptrs for o in outs)

    def test_coefficients_made_once_per_device(self):
        x = T(rand_blocks(np.random.RandomState(4), 2))
        ops.block_hashes(x)
        first = ops._COEF[torch.device("cpu")]
        ops.block_hashes(x)
        assert ops._COEF[torch.device("cpu")] is first


class TestLaunchCounters:
    def test_concurrent_increments_are_not_lost(self):
        def fn():
            pass

        fn.launches = 0
        n, workers = 20_000, 4
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)  # switch threads as often as possible
        try:
            threads = [
                threading.Thread(target=lambda: [count_launch(fn) for _ in range(n)])
                for _ in range(workers)
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        finally:
            sys.setswitchinterval(old)
        assert not any(t.is_alive() for t in threads)
        assert fn.launches == n * workers

    def test_every_wrapper_counts_through_the_lock(self):
        # the wrappers keep the attribute chip_smoke.py zeroes and reads, and
        # none increments it without the lock
        from repro_torch.kernels import (
            block_diff, chain_apply, flash_attention, segment_ops, sparse_apply,
        )
        from repro_torch.kernels import xor_delta as xor_module

        src = "".join(
            inspect.getsource(m)
            for m in (block_diff, xor_module, sparse_apply, chain_apply,
                      segment_ops, flash_attention)
        )
        assert ".launches += 1" not in src
        assert src.count("count_launch(") >= 11


class TestEdgeArraysDevice:
    def test_to_torch_defaults_to_the_card(self):
        arr = EdgeArrays.from_edges(3, [0, 1], [1, 2], [2.0, 3.0], [1.0, 0.5])
        assert inspect.signature(EdgeArrays.to_torch).parameters["device"].default == "cuda"
        out = arr.to_torch(device="cpu")
        assert out["src"].device.type == "cpu"
        np.testing.assert_array_equal(out["delta"].numpy(), arr.delta)
        if not torch.cuda.is_available():
            with pytest.raises((RuntimeError, AssertionError)):
                arr.to_torch()
