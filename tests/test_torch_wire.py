"""The port's msgpack subset and delta codec against the JAX package's.

``repro_torch.store.wire`` must give the bytes of
``msgpack.packb(obj, use_bin_type=True)`` and the values of
``msgpack.unpackb(raw=False)`` for everything the store writes, and the two
packages' ``encode_full`` / ``encode_delta`` must give byte-identical
payloads (hence identical object keys) for the same trees.
"""

import math

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.store import delta as JD
from repro_torch.store import delta as TD
from repro_torch.store import wire
from repro_torch.store.convert import flat_from_numpy, flat_to_numpy

INT_EDGES = [
    0, 1, 127, 128, 255, 256, 65535, 65536, 2**31 - 1, 2**31, 2**32 - 1,
    2**32, 2**63 - 1, 2**63, 2**64 - 1,
    -1, -31, -32, -33, -127, -128, -129, -32767, -32768, -32769,
    -(2**31) + 1, -(2**31), -(2**31) - 1, -(2**63) + 1, -(2**63),
]
LENGTHS = [0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536]


def _ref(obj):
    return msgpack.packb(obj, use_bin_type=True)


scalars = (
    st.none() | st.booleans()
    | st.integers(min_value=-(2**63), max_value=2**64 - 1)
    | st.sampled_from(INT_EDGES)
    | st.floats(allow_nan=True, allow_infinity=True)
    | st.text() | st.binary()
)
trees = st.recursive(
    scalars,
    lambda children: (
        st.lists(children, max_size=20)
        | st.dictionaries(st.text(max_size=12), children, max_size=20)
    ),
    max_leaves=60,
)


class TestMsgpackIdentity:
    @settings(max_examples=300, deadline=None)
    @given(trees)
    def test_pack_bytes_match_msgpack(self, obj):
        assert wire.packb(obj) == _ref(obj)

    @settings(max_examples=300, deadline=None)
    @given(trees)
    def test_unpack_matches_msgpack(self, obj):
        data = _ref(obj)
        got = wire.unpackb(data)
        want = msgpack.unpackb(data, raw=False)
        # compare through the packed form: NaN != NaN, but its bytes match
        assert _ref(got) == _ref(want) and type(got) is type(want)

    @pytest.mark.parametrize("v", INT_EDGES)
    def test_int_width_boundaries(self, v):
        assert wire.packb(v) == _ref(v)
        assert wire.unpackb(_ref(v)) == v

    @pytest.mark.parametrize("v", [2**64, -(2**63) - 1])
    def test_int_overflow_raises(self, v):
        with pytest.raises(OverflowError):
            wire.packb(v)

    @pytest.mark.parametrize("n", LENGTHS)
    def test_length_boundaries(self, n):
        for obj in (
            "x" * n, b"\x00" * n, list(range(n)), {str(i): i for i in range(n)},
        ):
            data = wire.packb(obj)
            assert data == _ref(obj)
            assert wire.unpackb(data) == obj

    def test_floats_and_special_values(self):
        for v in (0.0, -0.0, 1.5, 1e308, -1e-308, math.inf, -math.inf):
            assert wire.packb(v) == _ref(v)
            assert wire.unpackb(_ref(v)) == v
        assert wire.packb(math.nan) == _ref(math.nan)
        # single-precision floats are never written but must be read
        f32 = msgpack.packb(1.25, use_single_float=True)
        assert wire.unpackb(f32) == 1.25

    def test_tuples_bytearrays_and_float_subclasses(self):
        obj = {"t": (1, 2, (3,)), "b": bytearray(b"ab"), "m": memoryview(b"cd"),
               "f": np.float64(0.5), "u": "ünï", "e": b""}
        assert wire.packb(obj) == _ref(obj)

    def test_refuses_other_types(self):
        with pytest.raises(TypeError):
            wire.packb({"a": np.int64(3)})
        with pytest.raises(ValueError, match="extra data"):
            wire.unpackb(_ref(1) + b"\x00")


# ------------------------------------------------------------ delta codec
def _leaf(rng, shape, dtype):
    x = rng.randn(*shape)
    if dtype == "bfloat16":
        return np.asarray(jnp.asarray(x, jnp.bfloat16))
    if dtype == "bool":
        return x > 0
    if np.issubdtype(np.dtype(dtype), np.floating):
        return x.astype(dtype)
    return (x * 40).astype(dtype)


def _payload(rng):
    """A nested payload whose dicts are built in *unsorted* insertion order
    (the flatten must sort them, as jax.tree_util does)."""
    return {
        "z": {"w": _leaf(rng, (40, 64), "float32"),
              "b": [_leaf(rng, (300,), "int8"), _leaf(rng, (33, 7), "bfloat16")]},
        "m": _leaf(rng, (1100,), "float16"),
        "a": {"y": _leaf(rng, (16, 130), "int32"), "c": _leaf(rng, (9,), "uint8")},
    }


def _edit(rng, payload):
    new = {
        "z": {"w": payload["z"]["w"].copy(),
              "b": [payload["z"]["b"][0], _leaf(rng, (5, 5), "bfloat16")]},
        "q": _leaf(rng, (3,), "float32"),  # new leaf, "m" is deleted
        "a": {"y": payload["a"]["y"].copy(), "c": payload["a"]["c"]},
    }
    new["z"]["w"][7, 3] += 1
    new["a"]["y"][[0, 15], [1, 129]] -= 3
    return new


def _as_torch_payload(tree):
    if isinstance(tree, dict):
        return {k: _as_torch_payload(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_torch_payload(v) for v in tree]
    return flat_from_numpy({"": tree})[""]


class TestCodecIdentity:
    def test_flatten_sorts_like_jax(self):
        p = _payload(np.random.RandomState(0))
        j = JD.flatten_payload(p)
        t = TD.flatten_payload(_as_torch_payload(p))
        assert list(j) == list(t)
        assert list(t) == ["a/c", "a/y", "m", "z/b/0", "z/b/1", "z/w"]
        for k in j:
            assert flat_to_numpy(t)[k].tobytes() == np.asarray(j[k]).tobytes()

    @pytest.mark.parametrize("seed", [0, 1])
    def test_encode_full_and_delta_bytes_match(self, seed):
        rng = np.random.RandomState(seed)
        base = _payload(rng)
        new = _edit(rng, base)
        jb, jn = JD.flatten_payload(base), JD.flatten_payload(new)
        tb = TD.flatten_payload(_as_torch_payload(base))
        tn = TD.flatten_payload(_as_torch_payload(new))
        assert TD.encode_full(tb) == JD.encode_full(jb)
        assert TD.encode_full(tn) == JD.encode_full(jn)
        j_payload, j_stats = JD.encode_delta(jb, jn)
        t_payload, t_stats = TD.encode_delta(tb, tn, device="cpu")
        assert t_payload == j_payload
        assert t_stats == j_stats
        assert t_stats["changed_blocks"] >= 1 and t_stats["full_leaves"] == 2

    def test_decode_both_ways(self):
        rng = np.random.RandomState(2)
        base = JD.flatten_payload(_payload(rng))
        full = JD.encode_full(base)
        got = flat_to_numpy(TD.decode_full(full))
        assert list(got) == list(JD.decode_full(full))
        for k, v in base.items():
            assert got[k].dtype == v.dtype and got[k].tobytes() == v.tobytes()

    def test_refuses_unsupported_dtypes(self):
        with pytest.raises(TypeError, match="unsupported"):
            TD.flatten_payload({"x": torch.zeros(2, dtype=torch.float8_e4m3fn)})
        with pytest.raises(TypeError, match="unsupported"):
            TD.flatten_payload({"x": np.zeros(2, ">f4")})
        with pytest.raises(TypeError, match="leaves must be"):
            TD.flatten_payload({"x": 1.5})
