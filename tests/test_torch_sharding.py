"""The port's logical-axis sharding against the JAX package's, in one process.

The rules table; the seven cases of tests/test_sharding_rules.py, each also
held against JAX's own ``spec_for``; for every arch (and with
``moe_impl="ep"`` for the two MoE archs) the ``param_axes`` and
``cache_axes`` trees, and ``spec_for`` of every leaf on abstract 16 x 16 and
2 x 16 x 16 meshes, strict and not: the JAX package's trees come from
``jax.eval_shape`` at full width, the port's are meta tensors of those
shapes, so nothing is allocated.  ``shard`` outside the context; the
production meshes over the ``fake`` process group in a subprocess.  The
multi-rank checks are in tests/test_torch_mesh_ranks.py.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh

from repro.configs import ARCHS as JAX_ARCHS
from repro.distributed import sharding as jax_sh
from repro.models import get_model as jax_get_model
from repro_torch.configs import ARCHS
from repro_torch.distributed import compression
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import DEFAULT_RULES, AbstractMesh, P, spec_for
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import get_model

SRC = Path(__file__).resolve().parents[1] / "src"
SIZES = {"16x16": ((16, 16), ("data", "model")),
         "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _jax_mesh(sizes, names):
    try:
        return JaxAbstractMesh(sizes, names)
    except TypeError:  # older JAX: ((name, size), ...)
        return JaxAbstractMesh(tuple(zip(names, sizes)))


JAX_MESHES = {k: _jax_mesh(*v) for k, v in SIZES.items()}
PORT_MESHES = {k: AbstractMesh(*v) for k, v in SIZES.items()}
MESH, MESH3 = PORT_MESHES["16x16"], PORT_MESHES["2x16x16"]


def test_rules_table_is_jaxs():
    assert DEFAULT_RULES == jax_sh.DEFAULT_RULES
    assert sh.DP_AXES == jax_sh.DP_AXES


# the cases of tests/test_sharding_rules.py: (axes, shape, mesh, kwargs, want)
CASES = {
    "weight_fsdp_tp": (("embed", "mlp"), (5120, 25600), "16x16", {}, ("data", "model")),
    "multi_axis_batch_on_multipod": (("batch", "seq"), (256, 4096), "2x16x16", {},
                                     (("pod", "data"),)),
    "kv_heads_too_small_replicates": (("embed", "kv_heads", None), (4608, 8, 128), "16x16",
                                      {}, ("data",)),
    "strict_divisibility_blocks_uneven": (("heads",), (36,), "16x16", {"strict": True}, ()),
    "strict_divisibility_pads_activations": (("heads",), (36,), "16x16", {"strict": False},
                                             ("model",)),
    "axis_tuple_degradation": (("experts_ep", None, None), (16, 4096, 6400), "16x16",
                               {"rules": dict(DEFAULT_RULES)}, ("model",)),
    "no_axis_reuse": (("vocab", "mlp"), (1024, 1024), "16x16", {}, ("model",)),
    "pod_only_rule": (("expert_fsdp",), (7168,), "2x16x16", {}, ("pod",)),
    "pod_only_rule_single_pod": (("expert_fsdp",), (7168,), "16x16", {}, ()),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_spec_for_cases(case):
    axes, shape, mesh, kw, want = CASES[case]
    got = spec_for(axes, shape, mesh=PORT_MESHES[mesh], **kw)
    assert got == P(*want) and isinstance(got, tuple)
    assert tuple(got) == tuple(jax_sh.spec_for(axes, shape, mesh=JAX_MESHES[mesh], **kw))


def _arch_cases():
    out = [(name, "dispatch") for name in sorted(ARCHS)]
    return out + [(name, "ep") for name in sorted(ARCHS) if ARCHS[name].n_experts]


def _meta(tree):
    """The port's tree of meta tensors of a JAX tree of ShapeDtypeStructs."""
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32, "int32": torch.int32}
    return jax.tree.map(lambda s: torch.empty(s.shape, dtype=dtypes[str(s.dtype)],
                                              device="meta"), tree)


def _leaves(axes_tree, shape_tree):
    """(axes, shape) of every leaf, walking the axes tree."""
    pairs = []
    sh.map_axes(lambda axes, leaf: pairs.append((axes, tuple(leaf.shape))), axes_tree,
                shape_tree)
    return pairs


@pytest.mark.parametrize("name,impl", _arch_cases())
def test_param_and_cache_axes_match_jax(name, impl):
    """Both trees equal JAX's, and every leaf's spec on both production
    meshes, strict and not, equals JAX's spec_for."""
    cfg_j = dataclasses.replace(JAX_ARCHS[name], moe_impl=impl)
    cfg_t = dataclasses.replace(ARCHS[name], moe_impl=impl)
    jm, tm = jax_get_model(cfg_j), get_model(cfg_t)
    p_shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    kw = {"enc_len": 64} if cfg_j.is_encdec else {}
    c_shapes = jax.eval_shape(lambda: jm.init_cache(2, 128, **kw))
    want_p, want_c = jm.param_axes(p_shapes), jm.cache_axes(c_shapes)
    got_p, got_c = tm.param_axes(_meta(p_shapes)), tm.cache_axes(_meta(c_shapes))
    assert got_p == want_p
    assert got_c == want_c
    if impl == "ep":
        moe_axes = [a for a, _ in _leaves(got_p, p_shapes) if "experts_ep" in a]
        assert moe_axes and all(a[1:3] == ("experts_ep", "expert_fsdp") for a in moe_axes)
    leaves = _leaves(got_p, p_shapes) + _leaves(got_c, c_shapes)
    for mesh in SIZES:
        for strict in (True, False):
            for axes, shape in leaves:
                got = spec_for(axes, shape, mesh=PORT_MESHES[mesh], strict=strict)
                want = jax_sh.spec_for(axes, shape, mesh=JAX_MESHES[mesh], strict=strict)
                assert tuple(got) == tuple(want), (mesh, strict, axes, shape)
    # tree_spec over the port's own meta tree gives the same specs
    specs = sh.tree_spec(got_p, _meta(p_shapes), mesh=MESH3)
    flat = []
    sh.map_axes(lambda axes, s: flat.append(s.spec), got_p, specs)
    assert flat == [spec_for(a, s, mesh=MESH3) for a, s in _leaves(got_p, p_shapes)]


def test_shard_is_a_no_op_outside_the_context():
    x = torch.randn(4, 8)
    assert sh.shard(x, "batch", "act_embed") is x
    with sh.logical_sharding(MESH):
        assert sh.shard(x, "batch", "act_embed") is x  # a plain tensor passes too
        assert sh.active_mesh() is MESH
    assert sh.active_mesh() is None


def test_named_sharding_placements_and_refusals():
    from torch.distributed.tensor import Replicate, Shard

    assert sh.NamedSharding(MESH3, P(None, ("data", "model"), "pod")).placements == (
        Shard(2), Shard(1), Shard(1))
    assert sh.NamedSharding(MESH, P()).placements == (Replicate(), Replicate())
    with pytest.raises(ValueError, match="out of the mesh's dim order"):
        sh.NamedSharding(MESH, P(("model", "data"))).placements
    with pytest.raises(ValueError, match="no process group"):
        sh.axis_group(MESH, "data")
    with pytest.raises(ValueError, match="needs an active"):
        compression.compressed_psum(torch.zeros(4), "data")
    with sh.logical_sharding(MESH), pytest.raises(ValueError, match="no process group"):
        compression.compressed_psum(torch.zeros(4), "data")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_host_mesh()


FAKE_PG = """
import warnings
warnings.simplefilter("ignore")
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.distributed import compression, sharding
from repro_torch.launch.mesh import make_production_mesh

for world, multi in ((256, False), (512, True)):
    dist.init_process_group("fake", store=FakeStore(), rank=3, world_size=world)
    try:
        make_production_mesh(multi_pod=not multi, device="cpu")
        raise SystemExit("a mesh of the other size was built")
    except RuntimeError as e:
        assert f"this one has {world}" in str(e), e
    mesh = make_production_mesh(multi_pod=multi, device="cpu")
    print(tuple(mesh.shape), mesh.mesh_dim_names, tuple(mesh.get_coordinate()))
    with sharding.logical_sharding(mesh):
        try:
            compression.compressed_psum(torch.zeros(4), "expert")
            raise SystemExit("an unknown axis was taken")
        except ValueError as e:
            assert "not an axis of the mesh" in str(e), e
    dist.destroy_process_group()
"""


def test_production_meshes_over_the_fake_process_group():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", FAKE_PG], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split("\n")[:2] == [
        "(16, 16) ('data', 'model') (0, 3)", "(2, 16, 16) ('pod', 'data', 'model') (0, 0, 3)"]
