"""The port's mesh runtime across ranks on the CPU, against the JAX package.

Each test spawns the ranks of one mesh (this file, run as a script) as gloo
processes that meet through a ``FileStore`` under ``tmp_path`` (never a
fixed TCP port: several test workers run at once), with a 60 s timeout on
every collective; the test waits at most ``DEADLINE_S`` for them, then
kills them and fails.  The JAX references come from one module-scoped
subprocess on 8 forced host devices (as tests/test_moe_ep.py sets them up),
started before the ranks and read after them.  The inputs are made once
from a seed (the reduced Phi-3.5-MoE layer of tests/test_moe_ep.py: E 8,
top 2, one shared expert, d 64; the E = 4 case keeps its first 4
experts).

* 2 x 4 (data, model): the EP forward against JAX's ``moe_block_ep`` at cf
  4.0 (no route dropped), cf 1.0 (routes dropped) and, with the first 4
  experts, at E = 4 (EP group ("model",), each expert on both data rows),
  rtol = atol = 2e-2 (tests/test_moe_ep.py's), each rank returning the
  whole output, two all-to-alls a call; a planted fault (rank 0 sends its
  chunks in reversed order) must fail the same comparison; decode (S = 1)
  raises ``ValueError`` naming the model axis, where ``shard_map`` raises.
  The drop-free gradients of ``x``, the router and each rank's expert
  blocks (DTensors placed by ``param_axes``) at E = 8 and E = 4 against
  ``jax.grad`` of the jitted ``moe_block_ep`` on the same mesh, the global
  gradients (readings 2.7e-3 to 5.5e-3), and against ``moe.moe_block``'s
  on the whole layer (up to 5.4e-3), every leaf within ``GRAD_TOL`` of its
  norm, beside a planted fault (the block adjoints skip their
  all-reduce: 0.52 and above on x, the router and E = 4's experts) that
  must land above it.  ``compressed_psum`` over "data" and ("data",
  "model"), bit for bit against JAX's inside ``shard_map``.  Each rank's
  ``distribute_tensor(leaf, *tree_spec(...)).to_local()`` equals JAX's
  ``addressable_shards`` block for the device at the same coordinate, for a
  two-axis entry (``experts_ep``) and a degraded one among others.
* 2 x 2 x 2 (pod, data, model): the EP forward against JAX's, drop-free
  (the pod all-gather of the experts' inner dim), and its gradients with
  whole expert stacks (the pod reduce-scatter) against JAX's, as on 2 x 4
  and against the dispatch's (readings 3.2e-3 to 6.9e-3 and up to 3.7e-3;
  the fault 0.53 and above on x, the router and the experts).
* 2 x 2: ``restore(shardings=)`` of a store the JAX package's manager
  committed gives each rank its slices of the saved leaves.
* 1 x 1: reduced Phi-3.5-MoE and DeepSeek-V3 with ``moe_impl="ep"``
  serve (a prefill and 4 decode steps) and take a train step against the
  JAX package's under ``logical_sharding(make_host_mesh())``
  (``models_main`` states the tolerances).

The processes run this file as a script:
``python tests/test_torch_mesh_ranks.py rank MESH RANK WORLD STORE IN_DIR
OUT_DIR`` runs one rank of the port (``2x4``: (data, model); ``2x2x2``:
(pod, data, model); ``2x2``; ``1x1``) and writes its arrays to
``OUT_DIR/rank{RANK}.npz``; ``... jax IN_DIR OUT_DIR`` the JAX package's
references on 8 forced host devices (``OUT_DIR/jax.npz``, keys
``<case>/<coordinate>`` for one device's block); ``... models OUT_DIR``
case (g), which raises on a mismatch.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
import warnings
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest

from repro_torch.configs import ARCHS

MESHES = {
    "2x4": ((2, 4), ("data", "model")),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "1x1": ((1, 1), ("data", "model")),
}
B, S = 4, 16          # divides (pod x data) and model on every mesh above
SMALL_MOE = dict(n_experts=8, top_k=2, expert_d_ff=32, d_model=64, n_shared_experts=1)
# the EP cases of each mesh: (experts, capacity factor).  cf 4.0 drops no
# route, cf 1.0 drops some; "e4" keeps the first 4 experts, which do not
# divide data x model = 8, so its EP group is ("model",) and the two data
# rows hold the same experts
EP_CASES = {"2x4": {"cf4": (8, 4.0), "cf1": (8, 1.0), "e4": (4, 4.0)},
            "2x2x2": {"cf4": (8, 4.0)}}
GRAD_CASES = {"2x4": ("cf4", "e4"), "2x2x2": ("cf4",)}   # drop-free
EXPERTS = ("w_gate", "w_up", "w_down")
BF16_LEAVES = EXPERTS + ("shared_w_gate", "shared_w_up", "shared_w_down")
# (e): leaves, their logical axes and shapes; experts_deg degrades to ("model",)
SHARD_LEAVES = {
    "w2d": (("embed", "mlp"), (64, 96)),
    "experts": (("experts_ep", "expert_fsdp", None), (8, 64, 32)),
    "experts_deg": (("experts_ep", "expert_fsdp", None), (4, 64, 32)),
    "kv": (("embed", "kv_heads", None), (64, 2, 16)),
    "stacked": (("stack", "embed", "mlp"), (3, 64, 8)),
}
PSUM_AXES = {"data": "data", "data_model": ("data", "model")}
RESTORE_AXES = {"params": {"w": ("embed", "mlp"), "experts": ("experts_ep", None, None)},
                "step": ()}


def make_inputs(path: Path) -> None:
    """The seeded numpy inputs every process reads; bf16 leaves are stored
    as f32 values that bf16 holds exactly."""
    import ml_dtypes

    rng = np.random.RandomState(0)
    E, D, F = SMALL_MOE["n_experts"], SMALL_MOE["d_model"], SMALL_MOE["expert_d_ff"]
    bf = lambda a: np.asarray(a, np.float32).astype(ml_dtypes.bfloat16).astype(np.float32)
    out = {"router": (rng.randn(D, E) * 0.1).astype(np.float32),
           "w_gate": bf(rng.randn(E, D, F) * 0.1), "w_up": bf(rng.randn(E, D, F) * 0.1),
           "w_down": bf(rng.randn(E, F, D) * 0.1),
           "shared_w_gate": bf(rng.randn(D, F) * 0.1), "shared_w_up": bf(rng.randn(D, F) * 0.1),
           "shared_w_down": bf(rng.randn(F, D) * 0.1),
           "x": bf(rng.randn(B, S, D) * 0.5),
           "cot": rng.randn(B, S, D).astype(np.float32),
           # (d): one (3, 300) block a device, scales apart by up to 2**6
           "psum": (rng.randn(8, 3, 300) * np.exp2(rng.randint(-3, 4, (8, 1, 1)))
                    ).astype(np.float32)}
    for name, (_, shape) in SHARD_LEAVES.items():
        out["shard/" + name] = rng.randn(*shape).astype(np.float32)
    np.savez(path, **out)


def coords(shape):
    return [tuple(int(i) for i in c) for c in np.ndindex(*shape)]


def key(case: str, coord) -> str:
    return f"{case}/{'.'.join(map(str, coord))}"


# ------------------------------------------------------------------ the port
def moe_arrays(inp, n_experts: int) -> dict:
    """The layer's leaves, cut to the first ``n_experts`` experts."""
    out = {k: inp[k] for k in ("router",) + BF16_LEAVES}
    out["router"] = np.ascontiguousarray(out["router"][:, :n_experts])
    for k in EXPERTS:
        out[k] = np.ascontiguousarray(out[k][:n_experts])
    return out


def small_cfg(archs, n_experts: int, cf: float):
    return dataclasses.replace(archs["phi3.5-moe-42b-a6.6b"].reduced(), capacity_factor=cf,
                               **dict(SMALL_MOE, n_experts=n_experts))


def port_params(inp, n_experts: int, requires_grad=False):
    import torch

    p = {}
    for k, a in moe_arrays(inp, n_experts).items():
        t = torch.from_numpy(a)
        p[k] = (t.to(torch.bfloat16) if k in BF16_LEAVES else t).requires_grad_(requires_grad)
    return p


def reversed_chunks(moe_ep, rank: int):
    """A planted fault: on ``rank`` the first all-to-all of each call sends
    its chunks in reversed order."""
    original, calls = moe_ep._exchange, []

    def faulty(x, group):
        calls.append(1)
        if rank == 0 and len(calls) % 2 == 1:
            x = x.flip(0)
        return original(x, group)

    return faulty


def ep_cases(mesh_name: str, mesh, rank: int, inp, out: dict, *,
             dtensor_experts: bool) -> None:
    """The EP forward of each of the mesh's cases, the planted fault at cf
    1, and the drop-free cases' gradients against a cotangent, with and
    without a planted fault."""
    import torch

    from repro_torch.distributed.sharding import logical_sharding, tree_spec
    from repro_torch.models import moe_ep
    from repro_torch.models import transformer as tf

    x = torch.from_numpy(inp["x"]).to(torch.bfloat16)
    cases = EP_CASES[mesh_name]
    with logical_sharding(mesh):
        for name, (n_e, cf) in cases.items():
            before = moe_ep.all_to_all.calls
            out[f"ep_{name}"] = moe_ep.moe_block_ep(small_cfg(ARCHS, n_e, cf),
                                                    port_params(inp, n_e), x).float()
            out[f"a2a_{name}"] = np.int64(moe_ep.all_to_all.calls - before)
        try:  # decode: S = 1 does not divide over "model"
            moe_ep.moe_block_ep(small_cfg(ARCHS, 8, 4.0), port_params(inp, 8), x[:, :1])
            out["decode_raises"] = np.array("")
        except ValueError as e:
            out["decode_raises"] = np.array(str(e))
        if "cf1" in cases:
            good = moe_ep._exchange
            moe_ep._exchange = reversed_chunks(moe_ep, rank)
            try:
                out["ep_cf1_fault"] = moe_ep.moe_block_ep(small_cfg(ARCHS, *cases["cf1"]),
                                                          port_params(inp, 8), x).float()
            finally:
                moe_ep._exchange = good

        # drop-free gradients; on 2 x 4 the experts are DTensors placed by param_axes
        for name in GRAD_CASES[mesh_name]:
            n_e, cf = cases[name]
            for fault in (False, True):
                p = port_params(inp, n_e, requires_grad=True)
                if dtensor_experts:
                    from torch.distributed.tensor import distribute_tensor

                    axes = tf.block_axes({"moe": p}, stacked=False, moe_impl="ep")["moe"]
                    specs = tree_spec(axes, p, mesh=mesh)
                    for k in EXPERTS:
                        p[k] = distribute_tensor(p[k].detach(), mesh, specs[k].placements,
                                                 src_data_rank=None).requires_grad_(True)
                xg = x.clone().requires_grad_(True)
                saved = moe_ep.all_reduce
                if fault:  # planted: the block adjoints skip their all-reduce
                    moe_ep.all_reduce = lambda t, group: t
                try:
                    y = moe_ep.moe_block_ep(small_cfg(ARCHS, n_e, cf), p, xg)
                    (y.float() * torch.from_numpy(inp["cot"])).sum().backward()
                finally:
                    moe_ep.all_reduce = saved
                tag = f"grad_{name}" + ("_fault" if fault else "")
                out[f"{tag}/x"] = xg.grad.float()
                for k, v in p.items():
                    g = v.grad.to_local() if hasattr(v.grad, "to_local") else v.grad
                    out[f"{tag}/{k}"] = g.float()


def psum_cases(mesh, rank: int, inp, out: dict) -> None:
    import torch

    from repro_torch.distributed.compression import compressed_psum
    from repro_torch.distributed.sharding import logical_sharding

    block = torch.from_numpy(inp["psum"][rank])  # the mesh is arange-ordered
    with logical_sharding(mesh):
        for name, axes in PSUM_AXES.items():
            out[f"psum_{name}"] = compressed_psum(block, axes)


def shard_cases(mesh, inp, out: dict) -> None:
    import torch
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed.sharding import tree_spec

    leaves = {n: torch.from_numpy(inp["shard/" + n]) for n in SHARD_LEAVES}
    specs = tree_spec({n: a for n, (a, _) in SHARD_LEAVES.items()}, leaves, mesh=mesh)
    for n, t in leaves.items():
        out["shard/" + n] = distribute_tensor(t, mesh, specs[n].placements).to_local()
        out["spec/" + n] = np.array(json.dumps(list(specs[n].spec)))


def restore_case(mesh, rank: int, in_dir: Path, out_dir: Path, out: dict) -> None:
    import torch

    from repro_torch.checkpoint import VersionedCheckpointManager
    from repro_torch.distributed.sharding import tree_spec

    # each rank reads its own copy: a manager writes access counts on close
    root = out_dir / f"store{rank}"
    shutil.copytree(in_dir / "ckpt", root)
    template = {"params": {"w": ((8, 6), torch.float32), "experts": ((4, 6, 2), torch.bfloat16)},
                "step": ((), torch.int32)}
    mgr = VersionedCheckpointManager(root, device="cpu")
    try:
        got = mgr.restore(template, shardings=tree_spec(RESTORE_AXES, template, mesh=mesh))
    finally:
        mgr.close()
    for k, v in (("w", got["params"]["w"]), ("experts", got["params"]["experts"]),
                 ("step", got["step"])):
        out[f"restore/{k}"] = v.to_local().float()
        out[f"restore_placements/{k}"] = np.array(repr(v.placements))


def rank_main(mesh_name: str, rank: int, world: int, store: str, in_dir: Path,
              out_dir: Path) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    warnings.simplefilter("ignore", FutureWarning)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=timedelta(seconds=60))
    try:
        shape, names = MESHES[mesh_name]
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        inp = np.load(in_dir / "inputs.npz")
        out: dict = {"coord": np.array(mesh.get_coordinate())}
        if mesh_name == "2x4":
            ep_cases(mesh_name, mesh, rank, inp, out, dtensor_experts=True)
            psum_cases(mesh, rank, inp, out)
            shard_cases(mesh, inp, out)
        elif mesh_name == "2x2x2":
            ep_cases(mesh_name, mesh, rank, inp, out, dtensor_experts=False)
        elif mesh_name == "2x2":
            restore_case(mesh, rank, in_dir, out_dir, out)
        np.savez(out_dir / f"rank{rank}.npz",
                 **{k: v.detach().numpy() if hasattr(v, "detach") else v
                    for k, v in out.items()})
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------ the JAX package
def jax_main(in_dir: Path, out_dir: Path) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.configs import ARCHS
    from repro.distributed import compression
    from repro.distributed.sharding import logical_sharding, spec_for
    from repro.models import moe_ep

    def make(shape, names):
        return jax.make_mesh(shape, names, axis_types=(jax.sharding.AxisType.Auto,) * len(names))

    inp = np.load(in_dir / "inputs.npz")
    x = jnp.asarray(inp["x"], jnp.bfloat16)
    cot = jnp.asarray(inp["cot"])
    out = {}
    for mesh_name, cases in EP_CASES.items():
        mesh = make(*MESHES[mesh_name])
        for name, (n_e, cf) in cases.items():
            cfg = small_cfg(ARCHS, n_e, cf)
            p = {k: jnp.asarray(a, jnp.bfloat16 if k in BF16_LEAVES else jnp.float32)
                 for k, a in moe_arrays(inp, n_e).items()}

            def loss(p, x):
                return jnp.sum(moe_ep.moe_block_ep(cfg, p, x).astype(jnp.float32) * cot)

            with logical_sharding(mesh):
                y = jax.jit(lambda p, x: moe_ep.moe_block_ep(cfg, p, x))(p, x)
                if name in GRAD_CASES[mesh_name]:  # the global gradients
                    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, x)
                    out[f"{mesh_name}/grad_{name}/x"] = np.asarray(gx, np.float32)
                    for k, g in gp.items():
                        out[f"{mesh_name}/grad_{name}/{k}"] = np.asarray(g, np.float32)
            out[f"{mesh_name}/ep_{name}"] = np.asarray(y, np.float32)

    mesh = make(*MESHES["2x4"])
    spec = P(("data", "model"))
    xs = jnp.asarray(inp["psum"])
    for name, axes in PSUM_AXES.items():
        f = shard_map(lambda b: compression.compressed_psum(b[0], axes)[None], mesh=mesh,
                      in_specs=spec, out_specs=spec, check_rep=False)
        res = np.asarray(jax.jit(f)(xs))
        for i, c in enumerate(coords((2, 4))):
            out[key(f"psum_{name}", c)] = res[i]
    for n, (axes, _) in SHARD_LEAVES.items():
        arr = jnp.asarray(inp["shard/" + n])
        s = spec_for(axes, arr.shape, mesh=mesh)
        placed = jax.device_put(arr, NamedSharding(mesh, s))
        by_dev = {sh.device: np.asarray(sh.data) for sh in placed.addressable_shards}
        for c in coords((2, 4)):
            out[key("shard/" + n, c)] = by_dev[mesh.devices[c]]
        out["spec/" + n] = np.array(json.dumps([list(e) if isinstance(e, tuple) else e
                                                for e in s]))
    np.savez(out_dir / "jax.npz", **out)


# ------------------------------------------------------- (g) the MoE archs
def models_main(out_dir: Path) -> None:
    """Reduced Phi-3.5-MoE and DeepSeek-V3 with ``moe_impl="ep"`` on a 1 x 1
    mesh: the prefill's last logits (rtol = atol = 2e-2) and 4 decode steps'
    (5e-2), tests/test_arch_smoke.py's tolerances, off near-tie positions
    (tests/torch_moe_routes.py), and one train step (the training tests'
    ``hold_step``, on JAX's routes where a near tie flips)."""
    import jax
    import jax.numpy as jnp
    import torch
    import torch.distributed as dist

    from repro.configs import ARCHS as JAX_ARCHS
    from repro.distributed.sharding import logical_sharding as jax_sharding
    from repro.launch.mesh import make_host_mesh as jax_host_mesh
    from repro.models import get_model as jax_get_model
    from repro.training import optimizer as jax_opt
    from repro.training import train_loop as jax_tl
    from repro_torch.configs import ARCHS
    from repro_torch.distributed.sharding import logical_sharding
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import get_model, moe_ep
    from repro_torch.models.convert import params_from_numpy, train_state_from_numpy
    from repro_torch.models.convert import train_state_to_numpy
    from repro_torch.training import optimizer as port_opt
    from repro_torch.training import train_loop as port_tl
    from test_torch_training import OPT, hold_step
    from torch_moe_routes import (
        assert_close_off_ties,
        assert_near_ties,
        forced_routes,
        jax_recorded_routes,
        recorded_margins,
        routes_by_layer,
    )

    warnings.simplefilter("ignore", FutureWarning)
    torch.set_num_threads(2)
    jmesh, mesh = jax_host_mesh(), make_host_mesh("cpu")
    Bm, Sm, steps = 2, 64, 4
    report = {}
    try:
        for arch in ("phi3.5-moe-42b-a6.6b", "deepseek-v3-671b"):
            cfg_j = dataclasses.replace(JAX_ARCHS[arch].reduced(), moe_impl="ep")
            cfg_t = dataclasses.replace(ARCHS[arch].reduced(), moe_impl="ep")
            jm, tm = jax_get_model(cfg_j), get_model(cfg_t)
            n_moe = sum(cfg_t.layer_uses_moe(i) for i in range(cfg_t.n_layers))
            params = jm.init(jax.random.PRNGKey(0))
            rng = np.random.RandomState(3)
            tokens = rng.randint(0, cfg_t.vocab, (Bm, Sm + steps)).astype(np.int32)

            # serving: the prefill and 4 decode steps on the same tokens
            with jax_sharding(jmesh):
                cache = jm.init_cache(Bm, Sm + steps)
                want = [jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(tokens[:, :Sm])},
                                            cache)]
                for i in range(steps):
                    want.append(jax.jit(jm.decode_step, static_argnums=3)(
                        params, jnp.asarray(tokens[:, Sm + i:Sm + i + 1]), want[-1][1], Sm + i))
            pt = params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
            before = moe_ep.all_to_all.calls
            with torch.no_grad(), logical_sharding(mesh), recorded_margins() as margins:
                cache = tm.init_cache(Bm, Sm + steps, device="cpu")
                got = [tm.prefill(pt, {"tokens": torch.from_numpy(tokens[:, :Sm]).long()},
                                  cache)[0]]
                for i in range(steps):
                    got.append(tm.decode_step(
                        pt, torch.from_numpy(tokens[:, Sm + i:Sm + i + 1]).long(), cache,
                        Sm + i)[0])
            a2a = moe_ep.all_to_all.calls - before
            assert a2a == 2 * n_moe * (1 + steps), (arch, a2a)
            # each call's margins, (B, S) for the prefill, (B, 1) a step
            per_call = [margins[i * n_moe:(i + 1) * n_moe] for i in range(1 + steps)]
            left = []
            for i, (g, (w, _)) in enumerate(zip(got, want)):
                m = [mm[:, -1:] for mm in per_call[i]]
                tol = 2e-2 if i == 0 else 5e-2
                left.append(assert_close_off_ties(g[:, -1:], np.asarray(w[:, -1:], np.float32),
                                                  m, rtol=tol, atol=tol))

            # one train step, on JAX's routes where a near tie flips
            opt = jax_opt.init_opt_state(params)
            tcfg = jax_tl.TrainConfig(optimizer=jax_opt.OptimizerConfig(**OPT))
            batch = tokens[:, :Sm]
            with jax_sharding(jmesh), jax_recorded_routes() as calls:
                new, metrics = jax.jit(jax_tl.make_train_step(jm, tcfg))(
                    {"params": params, "opt": opt, "error_fb": None},
                    {"tokens": jnp.asarray(batch)})
                jax.block_until_ready(new)
            routes = [(w.reshape(Bm, Sm, -1), e.reshape(Bm, Sm, -1))
                      for w, e in routes_by_layer(calls, n_moe)]
            state0 = jax.tree.map(np.asarray, {"params": params, "opt": opt})
            step = port_tl.make_train_step(tm, port_tl.TrainConfig(
                optimizer=port_opt.OptimizerConfig(**OPT)))
            with logical_sharding(mesh), forced_routes(routes) as flips:
                got_s, got_m = step(train_state_from_numpy(state0, "cpu"),
                                    {"tokens": torch.from_numpy(batch).long()})
            assert_near_ties(flips, n_moe * batch.size)
            hold_step(train_state_to_numpy(got_s),
                      jax.tree.map(np.asarray, {"params": new["params"], "opt": new["opt"]}),
                      {k: v.item() for k, v in got_m.items()},
                      {k: float(v) for k, v in metrics.items()}, moe=True)
            report[arch] = {"near_tie_positions_left_out": left, "train_flips": len(flips),
                            "all_to_all": a2a}
    finally:
        dist.destroy_process_group()
    (out_dir / "models.json").write_text(json.dumps(report))



# ------------------------------------------------------------------ the tests
HERE = Path(__file__).resolve().parent
HELPER = Path(__file__).resolve()  # the processes run this file as a script
DEADLINE_S = 180
TOL = dict(rtol=2e-2, atol=2e-2)
GRAD_TOL = 2e-2


def _env():
    path = os.pathsep.join([str(HERE.parent / "src"), str(HERE), os.environ.get("PYTHONPATH", "")])
    return dict(os.environ, PYTHONPATH=path, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")


def _start(args, log: Path) -> subprocess.Popen:
    with open(log, "wb") as f:
        return subprocess.Popen([sys.executable, str(HELPER), *map(str, args)], env=_env(),
                                stdout=f, stderr=subprocess.STDOUT)


def _wait(procs, logs, what: str, deadline: float) -> None:
    """Wait for every process until ``deadline`` (monotonic); past it, kill
    them all and fail.  A non-zero exit fails with the log's tail."""
    try:
        for p in procs:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        pytest.fail(f"{what}: not done within {DEADLINE_S} s; killed")
    bad = [(i, p.returncode) for i, p in enumerate(procs) if p.returncode != 0]
    if bad:
        i = bad[0][0]
        pytest.fail(f"{what}: process {i} exited {bad[0][1]}:\n"
                    + logs[i].read_text(errors="replace")[-4000:])


class _Pending:
    """A started subprocess whose npz output is read once it ends."""

    def __init__(self, args, out: Path, what: str):
        self.log, self.out, self.what = out.with_suffix(".log"), out, what
        self.proc = _start(args, self.log)
        self.deadline = time.monotonic() + DEADLINE_S
        self._data = None

    def get(self):
        if self._data is None:
            _wait([self.proc], [self.log], self.what, self.deadline)
            self._data = dict(np.load(self.out))
        return self._data


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The seeded inputs, and a store the JAX package's manager committed."""
    from repro.checkpoint import VersionedCheckpointManager as JaxManager

    d = tmp_path_factory.mktemp("mesh_inputs")
    make_inputs(d / "inputs.npz")
    rng = np.random.RandomState(5)
    import ml_dtypes

    state = {"params": {"w": rng.randn(8, 6).astype(np.float32),
                        "experts": rng.randn(4, 6, 2).astype(ml_dtypes.bfloat16)},
             "step": np.int32(7)}
    jm = JaxManager(d / "ckpt")
    jm.save(0, state, blocking=True)
    jm.close()
    np.savez(d / "ckpt_state.npz", w=state["params"]["w"],
             experts=state["params"]["experts"].astype(np.float32), step=state["step"])
    return d


@pytest.fixture(scope="module")
def jax_refs(inputs, tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_jax")
    return _Pending(["jax", inputs, d], d / "jax.npz", "the JAX references")


def run_ranks(mesh_name: str, inputs: Path, tmp_path: Path) -> list:
    """Every rank of ``mesh_name``'s outputs, by rank."""
    shape, _ = MESHES[mesh_name]
    world = int(np.prod(shape))
    store = tmp_path / "filestore"
    logs = [tmp_path / f"rank{r}.log" for r in range(world)]
    procs = [_start(["rank", mesh_name, r, world, store, inputs, tmp_path], logs[r])
             for r in range(world)]
    _wait(procs, logs, f"the {mesh_name} ranks", time.monotonic() + DEADLINE_S)
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


def _coord(out) -> tuple:
    return tuple(int(c) for c in out["coord"])


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _jax_grads(ref: dict, mesh_name: str, case: str) -> dict:
    """``jax.grad`` of JAX's ``moe_block_ep`` on the same mesh, by leaf."""
    prefix = f"{mesh_name}/grad_{case}/"
    return {k[len(prefix):]: v for k, v in ref.items() if k.startswith(prefix)}


def _dispatch_grads(inputs: Path, mesh_name: str, case: str) -> dict:
    """``moe.moe_block``'s gradients on the whole layer against the same
    cotangent: the port's own single-process yardstick (an f32 router, so
    a near-tie token may route apart from EP's bf16 one)."""
    import torch

    from repro_torch.models import moe

    inp = np.load(inputs / "inputs.npz")
    n_e, cf = EP_CASES[mesh_name][case]
    p = port_params(inp, n_e, requires_grad=True)
    x = torch.from_numpy(inp["x"]).to(torch.bfloat16).requires_grad_(True)
    y = moe.moe_block(small_cfg(ARCHS, n_e, cf), p, x)
    (y.float() * torch.from_numpy(inp["cot"])).sum().backward()
    return {"x": x.grad.float().numpy(), **{k: v.grad.float().numpy() for k, v in p.items()}}


def _hold_grads(outs, want: dict, mesh_name: str, case: str, dtensor_experts: bool) -> dict:
    """Every rank's gradients within GRAD_TOL of ``want``, the global ones
    (the experts: the rank's block when they are DTensors), and the planted
    fault above it on every leaf whose gradient an all-reduce sums.
    Returns the largest reading and the fault's smallest, by leaf."""
    shape, names = MESHES[mesh_name]
    sizes = dict(zip(names, shape))
    n_e = EP_CASES[mesh_name][case][0]
    ep = ("data", "model") if n_e % (sizes["data"] * sizes["model"]) == 0 else ("model",)
    e_loc = n_e // int(np.prod([sizes[a] for a in ep]))
    assert set(want) == {"x", "router"} | set(BF16_LEAVES), sorted(want)
    readings, faults = {}, {}
    for out in outs:
        c = dict(zip(names, _coord(out)))
        r = 0
        for a in ep:
            r = r * sizes[a] + c[a]
        for k, w in want.items():
            if dtensor_experts and k in EXPERTS:
                w = w[r * e_loc:(r + 1) * e_loc]
            readings[k] = max(readings.get(k, 0.0), _rel(out[f"grad_{case}/{k}"], w))
            faults[k] = min(faults.get(k, np.inf), _rel(out[f"grad_{case}_fault/{k}"], w))
    bad = {k: v for k, v in readings.items() if not v <= GRAD_TOL}
    assert not bad, f"{mesh_name} {case}: gradients over {GRAD_TOL} of their norm: {bad}"
    # a DTensor expert block is summed only over the axes outside its EP group
    hit = ["x", "router"] + ([] if dtensor_experts and len(ep) == 2 else list(EXPERTS))
    missed = {k: faults[k] for k in hit if not faults[k] > GRAD_TOL}
    assert not missed, (f"{mesh_name} {case}: the planted fault (no all-reduce in the block "
                        f"adjoints) passes: {missed}")
    return {"max": readings, "fault_min": faults}


def test_ep_psum_and_shards_on_2x4(inputs, jax_refs, tmp_path):
    """(a) the EP forward with and without drops, at E = 4, and the planted
    fault, (c) the gradients against JAX's at E = 8 and E = 4, (d)
    compressed_psum, (e) the shards, on 2 x 4."""
    outs = run_ranks("2x4", inputs, tmp_path)
    ref = jax_refs.get()
    for out in outs:
        c = _coord(out)
        for case in EP_CASES["2x4"]:
            np.testing.assert_allclose(out[f"ep_{case}"], ref[f"2x4/ep_{case}"], **TOL,
                                       err_msg=f"rank at {c}, {case}")
            assert int(out[f"a2a_{case}"]) == 2
        # decode (S = 1) on a model axis of 4 raises, as shard_map does
        assert "sequence 1 by the model axis 4" in str(out["decode_raises"])
        # the planted fault fails the same comparison
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(out["ep_cf1_fault"], ref["2x4/ep_cf1"], **TOL)
        for name in ("data", "data_model"):
            got, want = out[f"psum_{name}"], ref[key(f"psum_{name}", c)]
            np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32),
                                          err_msg=f"compressed_psum over {name} at {c}")
        for n in SHARD_LEAVES:
            assert str(out["spec/" + n]) == str(ref["spec/" + n]), n
            np.testing.assert_array_equal(out["shard/" + n], ref[key("shard/" + n, c)],
                                          err_msg=f"{n} at {c}")
    assert sorted(_coord(o) for o in outs) == coords(MESHES["2x4"][0])
    # a two-axis entry splits over all 8 ranks; the degraded one over "model"
    assert json.loads(str(ref["spec/experts"])) == [["data", "model"]]
    assert json.loads(str(ref["spec/experts_deg"])) == ["model"]
    for case in GRAD_CASES["2x4"]:
        for want in (_jax_grads(ref, "2x4", case), _dispatch_grads(inputs, "2x4", case)):
            _hold_grads(outs, want, "2x4", case, dtensor_experts=True)


def test_ep_on_2x2x2(inputs, jax_refs, tmp_path):
    """(b) the EP forward on (pod, data, model), drop-free, and its
    gradients with whole expert stacks against JAX's."""
    outs = run_ranks("2x2x2", inputs, tmp_path)
    ref = jax_refs.get()
    for out in outs:
        np.testing.assert_allclose(out["ep_cf4"], ref["2x2x2/ep_cf4"], **TOL,
                                   err_msg=f"rank at {_coord(out)}")
        assert int(out["a2a_cf4"]) == 2
        assert "sequence 1 by the model axis 2" in str(out["decode_raises"])
    for want in (_jax_grads(ref, "2x2x2", "cf4"), _dispatch_grads(inputs, "2x2x2", "cf4")):
        _hold_grads(outs, want, "2x2x2", "cf4", dtensor_experts=False)


def test_sharded_restore_on_2x2(inputs, tmp_path):
    """(f) each rank restores its slices of a JAX-committed store."""
    outs = run_ranks("2x2", inputs, tmp_path)
    saved = np.load(inputs / "ckpt_state.npz")
    for out in outs:
        d, m = _coord(out)
        np.testing.assert_array_equal(out["restore/w"], saved["w"][4 * d:4 * d + 4,
                                                                   3 * m:3 * m + 3])
        r = 2 * d + m
        np.testing.assert_array_equal(out["restore/experts"], saved["experts"][r:r + 1])
        assert float(out["restore/step"]) == 7.0
        assert "Shard(dim=0), Shard(dim=1)" in str(out["restore_placements/w"])


def test_moe_archs_on_1x1(tmp_path):
    """(g) reduced Phi-3.5-MoE and DeepSeek-V3 with moe_impl="ep" serve and
    train on a 1 x 1 mesh as the JAX package does."""
    log = tmp_path / "models.log"
    proc = _start(["models", tmp_path], log)
    _wait([proc], [log], "the 1 x 1 model run", time.monotonic() + DEADLINE_S)
    report = json.loads((tmp_path / "models.json").read_text())
    assert set(report) == {"phi3.5-moe-42b-a6.6b", "deepseek-v3-671b"}


if __name__ == "__main__":
    mode, args = sys.argv[1], sys.argv[2:]
    if mode == "rank":
        rank_main(args[0], int(args[1]), int(args[2]), args[3], Path(args[4]), Path(args[5]))
    elif mode == "jax":
        jax_main(Path(args[0]), Path(args[1]))
    else:
        models_main(Path(args[0]))
