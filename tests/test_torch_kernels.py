"""The port's delta kernels against the JAX package's, on the CPU.

Every input is made from a seed with numpy and handed to both packages; the
JAX side runs its Pallas kernels in interpret mode (as its own tests do), the
port's wrappers take their plain PyTorch versions because the tensors lie on
the CPU.  All of this is integer data movement, so every comparison is
bit-exact.  The cases follow tests/test_kernels.py, tests/test_chain_apply.py
and tests/test_sparse_capacity.py.  The CUDA kernels themselves are held
against the same plain versions on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.block_diff import changed_block_mask as jax_mask
from repro.kernels.chain_apply import (
    chain_delta_apply as jax_chain,
    chain_delta_apply_batched as jax_chain_batched,
)
from repro.kernels.sparse_apply import sparse_delta_apply as jax_sparse
from repro_torch.kernels import ops, ref
from repro_torch.kernels.block_diff import changed_block_mask
from repro_torch.kernels.chain_apply import (
    chain_delta_apply,
    chain_delta_apply_batched,
)
from repro_torch.kernels.sparse_apply import sparse_delta_apply
from repro_torch.store.convert import tensor_from_numpy, tensor_to_numpy


def rand_blocks(rng, nb):
    return rng.randint(-(2**31), 2**31, size=(nb, 8, 128), dtype=np.int64).astype(np.int32)


def T(a):
    """numpy (or jax) int32 array -> CPU tensor with the same bytes."""
    return torch.from_numpy(np.array(a))


def assert_same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


class TestChangedBlockMask:
    @pytest.mark.parametrize("nb", [1, 2, 7, 64, 300])
    def test_matches_jax(self, nb):
        rng = np.random.RandomState(nb)
        a = rand_blocks(rng, nb)
        b = a.copy()
        if nb > 2:
            b[[0, nb // 2, nb - 1], 3, 7] += 1
        want = jax_mask(jnp.asarray(a), jnp.asarray(b))
        assert_same(changed_block_mask(T(a), T(b)), want)

    def test_identical_inputs_all_zero(self):
        a = T(rand_blocks(np.random.RandomState(1), 50))
        assert int(changed_block_mask(a, a.clone()).sum()) == 0

    def test_single_bit_flip_detected(self):
        a = rand_blocks(np.random.RandomState(2), 20)
        b = a.copy()
        b[13, 5, 77] ^= 1
        m = changed_block_mask(T(a), T(b))[:, 0]
        assert m[13] == 1 and int(m.sum()) == 1


class TestSparseApply:
    @pytest.mark.parametrize("nb,k", [(8, 3), (64, 1), (100, 37), (64, 64)])
    def test_matches_jax(self, nb, k):
        rng = np.random.RandomState(nb * 1000 + k)
        base, blocks = rand_blocks(rng, nb), rand_blocks(rng, k)
        idx = rng.choice(nb, size=k, replace=False).astype(np.int32)
        want = jax_sparse(jnp.asarray(base), jnp.asarray(blocks), jnp.asarray(idx))
        assert_same(sparse_delta_apply(T(base), T(blocks), T(idx)), want)

    def test_padding_rows_ignored(self):
        rng = np.random.RandomState(9)
        base, blocks = rand_blocks(rng, 16), rand_blocks(rng, 4)
        idx = np.asarray([2, -1, 5, -1], np.int32)
        want = jax_sparse(jnp.asarray(base), jnp.asarray(blocks), jnp.asarray(idx))
        assert_same(sparse_delta_apply(T(base), T(blocks), T(idx)), want)

    def test_out_of_range_rows_dropped_like_reference(self):
        rng = np.random.RandomState(10)
        base, blocks = rand_blocks(rng, 6), rand_blocks(rng, 4)
        idx = np.asarray([1, 6, -3, 100], np.int32)
        want = jref.sparse_delta_apply_ref(
            jnp.asarray(base), jnp.asarray(blocks), jnp.asarray(idx)
        )
        assert_same(sparse_delta_apply(T(base), T(blocks), T(idx)), want)


class TestChainKernel:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    @pytest.mark.parametrize("k,cap", [(1, 8), (4, 8), (7, 16)])
    def test_matches_jax(self, seed, k, cap):
        # duplicate rows within and across steps (later must win) and -1
        # padding interleaved
        rng = np.random.RandomState(seed)
        nb = 24
        base = rand_blocks(rng, nb)
        idx = rng.randint(0, nb, (k, cap)).astype(np.int32)
        idx[rng.rand(k, cap) < 0.4] = -1
        blocks = rand_blocks(rng, k * cap).reshape(k, cap, 8, 128)
        got = chain_delta_apply(T(base), T(blocks), T(idx))
        jargs = (jnp.asarray(base), jnp.asarray(blocks), jnp.asarray(idx))
        assert_same(got, jax_chain(*jargs))
        assert_same(got, jref.chain_delta_apply_ref(*jargs))

    def test_empty_and_all_padding(self):
        rng = np.random.RandomState(3)
        base = T(rand_blocks(rng, 6))
        empty = chain_delta_apply(
            base, torch.zeros((0, 8, 128), dtype=torch.int32),
            torch.zeros((0,), dtype=torch.int32),
        )
        assert torch.equal(empty, base)
        pad = chain_delta_apply(
            base, T(rand_blocks(rng, 8)), torch.full((8,), -1, dtype=torch.int32)
        )
        assert torch.equal(pad, base)

    @pytest.mark.parametrize("seed", [0, 4])
    def test_batched_matches_jax(self, seed):
        rng = np.random.RandomState(seed)
        l, nb, s = 3, 16, 8
        bases = rand_blocks(rng, l * nb).reshape(l, nb, 8, 128)
        idx = rng.randint(0, nb, (l, s)).astype(np.int32)
        idx[rng.rand(l, s) < 0.3] = -1
        blocks = rand_blocks(rng, l * s).reshape(l, s, 8, 128)
        want = jax_chain_batched(
            jnp.asarray(bases), jnp.asarray(blocks), jnp.asarray(idx)
        )
        assert_same(chain_delta_apply_batched(T(bases), T(blocks), T(idx)), want)

    def test_batched_rows_stay_in_their_leaf(self):
        # a row past num_blocks is padding, not the next leaf's row
        rng = np.random.RandomState(6)
        bases = rand_blocks(rng, 2 * 4).reshape(2, 4, 8, 128)
        blocks = rand_blocks(rng, 2).reshape(2, 1, 8, 128)
        idx = np.asarray([[4], [1]], np.int32)
        got = chain_delta_apply_batched(T(bases), T(blocks), T(idx))
        want = bases.copy()
        want[1, 1] = blocks[1, 0]
        assert_same(got, want)


def _pair(nb=32, changed=12, seed=3):
    a = rand_blocks(np.random.RandomState(seed), nb)
    b = a.copy()
    b[:changed, 0, 0] += 1
    return a, b, changed


class TestCompactAndEncode:
    @pytest.mark.parametrize(
        "rows,capacity",
        [([], 8), ([3, 7, 8, 30], 8), ([0, 1, 2], 8), (list(range(32)), 32),
         (list(range(12)), 4)],  # none, some, leading, all rows, overflow
    )
    def test_compact_matches_jax(self, rows, capacity):
        nb = 32
        mask = np.zeros((nb, 1), np.int32)
        mask[rows] = 1
        new = rand_blocks(np.random.RandomState(len(rows)), nb)
        j_idx, j_blk, j_n = jops._compact(
            jnp.asarray(mask), jnp.asarray(new), capacity=capacity
        )
        idx, blk, n = ops._compact(T(mask), T(new), capacity)
        assert idx.dtype == torch.int32 and n.dtype == torch.int32
        assert_same(idx, j_idx)
        assert_same(blk, j_blk)
        assert int(n) == int(j_n) == len(rows)

    @pytest.mark.parametrize(
        "rows,capacity",
        [([], 8), ([3, 7, 8, 30], 8), ([0, 1, 2], 8), (list(range(32)), 32),
         (list(range(12)), 4)],
    )
    def test_compact_int32_indices_same_bits_as_int64(self, rows, capacity):
        # _compact scatters and gathers with its int32 indices; the int64
        # copies it took before give the same bits
        nb = 32
        mask = np.zeros((nb, 1), np.int32)
        mask[rows] = 1
        m, new = T(mask)[:, 0], T(rand_blocks(np.random.RandomState(len(rows)), nb))
        order = torch.cumsum(m, 0, dtype=torch.int32) - 1
        keep = (m == 1) & (order < capacity)
        want = torch.full((capacity,), -1, dtype=torch.int32)
        want[order[keep].long()] = torch.arange(nb, dtype=torch.int32)[keep]
        want = torch.where(want >= 0, want, torch.argmin(m).to(torch.int32))
        idx, blk, n = ops._compact(T(mask), new, capacity)
        assert torch.equal(idx, want)
        assert torch.equal(blk, new[want.long()])
        assert int(n) == len(rows)

    @pytest.mark.parametrize("changed", [0, 1, 12, 32])
    def test_sparse_encode_matches_jax(self, changed):
        a, b, _ = _pair(changed=changed)
        j_idx, j_blk, j_n = jops.sparse_encode(jnp.asarray(a), jnp.asarray(b))
        idx, blk, n = ops.sparse_encode(T(a), T(b))
        assert n == j_n == changed
        assert_same(idx, j_idx)
        assert_same(blk, j_blk)
        assert torch.equal(ops.sparse_apply(T(a), blk, idx), T(b))

    def test_undersized_capacity_raises(self):
        a, b, changed = _pair()
        with pytest.raises(ValueError, match="capacity overflow"):
            ops.sparse_encode(T(a), T(b), capacity=changed // 2)

    def test_sufficient_capacity_roundtrips(self):
        a, b, changed = _pair()
        idx, blk, n = ops.sparse_encode(T(a), T(b), capacity=16)
        assert n == changed and idx.shape == (16,)
        assert torch.equal(ops.sparse_apply(T(a), blk, idx), T(b))


def _leaf(rng, dtype, shape):
    x = np.asarray(rng.randn(*shape))
    if dtype == "bool":
        return x < 0
    if dtype == "bfloat16":
        return np.asarray(jnp.asarray(x, jnp.bfloat16))
    if np.issubdtype(np.dtype(dtype), np.floating):
        return x.astype(dtype)
    return (x * 50).astype(dtype)


class TestBlockLayout:
    @pytest.mark.parametrize(
        "dtype", ["float32", "float16", "bfloat16", "int8", "int64", "bool"]
    )
    @pytest.mark.parametrize("shape", [(3, 5), (1024,), (2, 8, 130), (4096, 3), ()])
    def test_bytes_match_jax(self, dtype, shape):
        rng = np.random.RandomState(len(shape) * 7 + len(dtype))
        x = _leaf(rng, dtype, shape)
        blocks, meta = ops.to_blocks(tensor_from_numpy(x))
        raw = x.tobytes()
        raw += bytes(-len(raw) % ref.BLOCK_BYTES)
        assert_same(blocks, np.frombuffer(raw, np.int32).reshape(-1, 8, 128))
        if dtype != "bool":  # the JAX package's to_blocks refuses bool
            # it also narrows 64-bit arrays unless x64 is on; compare with
            # x64 on so that both see the same int64 bytes
            with jax.enable_x64(True):
                j_blocks, j_meta = jops.to_blocks(jnp.asarray(x))
                j_blocks = np.asarray(j_blocks)
            assert_same(blocks, j_blocks)
            assert (meta.shape, meta.nbytes, meta.num_blocks) == (
                j_meta.shape, j_meta.nbytes, j_meta.num_blocks,
            )
        back = tensor_to_numpy(ops.from_blocks(blocks, meta))
        assert back.dtype == x.dtype and back.shape == x.shape
        assert back.tobytes() == x.tobytes()

    def test_unaligned_view_is_copied(self):
        x = torch.arange(100, dtype=torch.int8)[3:]
        blocks, meta = ops.to_blocks(x)
        assert blocks.data_ptr() % 16 == 0
        assert torch.equal(ops.from_blocks(blocks, meta), x)


class TestInputsUntouched:
    def test_wrappers_do_not_write_into_arguments(self):
        rng = np.random.RandomState(11)
        base = T(rand_blocks(rng, 16))
        blocks = T(rand_blocks(rng, 8))
        idx = T(np.asarray([0, 3, 3, -1, 15, 2, 0, 9], np.int32))
        bases = T(rand_blocks(rng, 32).reshape(2, 16, 8, 128))
        bblocks = T(rand_blocks(rng, 16).reshape(2, 8, 8, 128))
        bidx = T(np.asarray([[1] * 8, [4, -1, 2, 2, 0, 7, 7, 1]], np.int32))
        args = [base, blocks, idx, bases, bblocks, bidx]
        before = [a.clone() for a in args]
        outs = [
            changed_block_mask(base, base.clone()),
            sparse_delta_apply(base, blocks, idx),
            chain_delta_apply(base, blocks, idx),
            chain_delta_apply_batched(bases, bblocks, bidx),
            ops.sparse_encode(base, sparse_delta_apply(base, blocks, idx))[1],
        ]
        for a, b in zip(args, before):
            assert torch.equal(a, b)
        # results never alias an argument
        ptrs = {a.data_ptr() for a in args}
        assert all(o.data_ptr() not in ptrs for o in outs)

    def test_plain_versions_match_each_other(self):
        # the chain's plain version is the stepwise fold of the sparse one
        rng = np.random.RandomState(12)
        base = T(rand_blocks(rng, 10))
        blocks = T(rand_blocks(rng, 12).reshape(3, 4, 8, 128))
        idx = T(rng.randint(-2, 10, (3, 4)).astype(np.int32))
        step = base
        for k in range(3):
            step = ref.sparse_delta_apply_ref(step, blocks[k], idx[k])
        assert torch.equal(ref.chain_delta_apply_ref(base, blocks, idx), step)
