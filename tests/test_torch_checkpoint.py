"""The port's versioned checkpoint manager against the JAX package's, on the
CPU: round trips bit for bit, the step map recovered on reopen, emergency
saves and the preemption guard, the restore-SLA repack (Problem 6), a failed
background repack kept on the manager, and checkpoints that cross between
the packages in both directions (same path keys, same bits, and one more
train step from either restore gives the loss of the other package's step
to 1e-3 relative, the train-step tolerance of tests/test_torch_training.py).
"""

import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import VersionedCheckpointManager as JaxManager
from repro.configs import ARCHS as JAX_ARCHS
from repro.models import get_model as jax_get_model
from repro.training import optimizer as jax_opt
from repro.training import train_loop as jax_tl
from repro_torch.checkpoint import (
    PreemptionGuard,
    VersionedCheckpointManager,
    restore_to_template,
)
from repro_torch.configs import ARCHS
from repro_torch.launch.train import state_template
from repro_torch.models import get_model
from repro_torch.models.convert import train_state_from_numpy, train_state_to_numpy
from repro_torch.store.convert import tensor_to_numpy
from repro_torch.training import optimizer as port_opt
from repro_torch.training import train_loop as port_tl
from repro_torch.tree import tree_map, tree_paths

ARCH = "minicpm-2b"
OPT = dict(peak_lr=1e-3, warmup_steps=10, total_steps=50)


def bits(a):
    a = np.asarray(a)
    return a.view({2: np.uint16, 4: np.uint32, 1: np.uint8}[a.dtype.itemsize])


def same_bits(got, want):
    """Two trees with the same paths and bit-identical leaves (numpy or
    tensors)."""
    as_np = lambda x: tensor_to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)
    g, w = tree_paths(got), tree_paths(want)
    assert [k for k, _ in g] == [k for k, _ in w]
    for (k, a), (_, b) in zip(g, w):
        a, b = as_np(a), as_np(b)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(bits(a), bits(b), err_msg=k)


def small_state(seed=0):
    rng = np.random.RandomState(seed)
    return {
        "params": {"w": torch.randn(64, 32, generator=torch.Generator().manual_seed(seed))
                   .to(torch.bfloat16),
                   "layers": [torch.arange(600, dtype=torch.float32) * seed]},
        "opt": {"mu": torch.from_numpy(rng.randn(64, 32).astype(np.float32)),
                "step": torch.tensor(seed, dtype=torch.int32)},
        "data": {"step": np.int32(seed), "epoch": np.int32(0)},
    }


def snapshot(state):
    """A numpy copy of a state tree (tensor_to_numpy shares memory)."""
    return tree_map(np.array, {**train_state_to_numpy(state), "data": dict(state["data"])})


def bump(state):
    """The next step's state, written in place as the train step does."""
    with torch.no_grad():
        state["params"]["w"].add_(1)
        state["params"]["layers"][0][::7] += 1
        state["opt"]["mu"][3].mul_(2)
        state["opt"]["step"].add_(1)
    state["data"] = {"step": state["data"]["step"] + 1, "epoch": np.int32(0)}
    return state


TEMPLATE = {
    "params": {"w": ((64, 32), torch.bfloat16), "layers": [((600,), torch.float32)]},
    "opt": {"mu": torch.empty(64, 32, device="meta"), "step": ((), torch.int32)},
    "data": {"step": ((), torch.int32), "epoch": np.zeros((), np.int32)},
}


class TestRoundTrip:
    def test_save_restore_bit_for_bit(self, tmp_path):
        mgr = VersionedCheckpointManager(tmp_path, device="cpu")
        state = small_state(1)
        want = {0: snapshot(state)}
        mgr.save(0, state)
        # the host copy was taken at save: the in-place step that follows
        # must not reach the commit
        bump(state)
        want[1] = snapshot(state)
        mgr.save(1, state, blocking=True)
        for step in (0, 1):
            got = mgr.restore(TEMPLATE, step=step)
            same_bits({k: got[k] for k in ("params", "opt")},
                      {k: want[step][k] for k in ("params", "opt")})
            assert int(got["data"]["step"]) == int(want[step]["data"]["step"])
            assert got["params"]["w"].dtype == torch.bfloat16
        # restored leaves are copies, never the store's cached tensors
        got = mgr.restore(TEMPLATE)
        got["params"]["w"].add_(5)
        same_bits(mgr.restore(TEMPLATE)["params"], want[1]["params"])
        mgr.close()

    def test_step_map_recovered_on_reopen(self, tmp_path):
        mgr = VersionedCheckpointManager(tmp_path, device="cpu")
        state = small_state(2)
        for step in (0, 5, 9):
            mgr.save(step, state)
            bump(state)
        mgr.close()
        again = VersionedCheckpointManager(tmp_path, device="cpu")
        assert sorted(again.step_to_vid) == [0, 5, 9]
        assert again.latest_step() == 9 and again.latest_vid() == again.step_to_vid[9]
        assert int(again.restore(TEMPLATE, step=5)["opt"]["step"]) == 3
        again.close()

    def test_template_checks(self, tmp_path):
        flat = {"a": torch.zeros(3)}
        with pytest.raises(KeyError, match="missing leaf 'b'"):
            restore_to_template(flat, {"b": ((3,), torch.float32)}, device="cpu")
        out = restore_to_template(flat, {"a": ((3,), torch.float64), "none": None},
                                  device="cpu")
        assert out["a"].dtype == torch.float64 and out["none"] is None

    def test_default_device_is_the_card(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default manager runs")
        with pytest.raises(RuntimeError, match="CUDA"):
            VersionedCheckpointManager(tmp_path)
        with pytest.raises(RuntimeError, match="CUDA"):
            restore_to_template({}, {})


class TestEmergencyAndRepack:
    def test_emergency_save_and_guard(self, tmp_path):
        guard = PreemptionGuard()
        assert not guard.preempted
        guard.trigger()
        assert guard.preempted
        guard.reset()
        assert not guard.preempted
        prev = signal.getsignal(signal.SIGTERM)
        g2 = PreemptionGuard(install_signal_handlers=True)
        signal.raise_signal(signal.SIGTERM)
        assert g2.preempted
        g2.uninstall()
        assert signal.getsignal(signal.SIGTERM) is prev

        mgr = VersionedCheckpointManager(tmp_path, device="cpu")
        state = small_state(3)
        mgr.save(0, state)
        vid = mgr.emergency_save(1, bump(state))
        assert mgr.step_to_vid[1] == vid
        meta = {m.vid: m for m in mgr.store.log()}
        assert meta[vid].message == "EMERGENCY step=1"
        assert meta[vid].parents == [mgr.step_to_vid[0]]
        mgr.close()

    def test_sla_repack_holds_theta(self, tmp_path):
        mgr = VersionedCheckpointManager(tmp_path, device="cpu", max_restore_cost_s=0.05)
        state = small_state(4)
        for step in range(6):
            mgr.save(step, bump(state))
        spec = mgr.sla_spec()
        assert spec.describe() == mgr.sla_spec(0.05).describe()
        stats = mgr.repack()
        assert stats["optimize"]["problem"] == 6 and stats["optimize"]["backend"] == "torch"
        assert stats["after"]["max_recreation_s"] <= 0.05
        for step in range(6):
            assert mgr.restore_cost_s(step) <= 0.05
        same_bits(mgr.restore(TEMPLATE)["params"], snapshot(state)["params"])
        with pytest.raises(ValueError, match="max_restore_cost_s"):
            VersionedCheckpointManager(tmp_path / "x", device="cpu").sla_spec()
        mgr.close()

    def test_failed_background_repack_is_kept(self, tmp_path):
        """As in the JAX package, a background repack that fails does not
        stop the saves; the port keeps the exception and counts it."""
        mgr = VersionedCheckpointManager(tmp_path, device="cpu", repack_every=2)
        state = small_state(5)
        for step in range(4):
            mgr.save(step, bump(state))
        mgr.wait()
        assert sorted(mgr.step_to_vid) == [0, 1, 2, 3]
        assert mgr.repack_errors == 2
        assert isinstance(mgr.last_repack_error, ValueError)
        assert "max_restore_cost_s" in str(mgr.last_repack_error)
        mgr.close()
        ok = VersionedCheckpointManager(tmp_path, device="cpu", repack_every=1,
                                        max_restore_cost_s=1.0)
        ok.save(4, bump(state), blocking=True)
        assert ok.repack_errors == 0 and ok.last_repack_error is None
        ok.close()


# ------------------------------------------------------------- cross-package
def jax_bundle():
    return jax_get_model(JAX_ARCHS[ARCH].reduced())


def jax_template(bundle):
    params_t = jax.eval_shape(lambda: bundle.init(jax.random.PRNGKey(0)))
    return {"params": params_t,
            "opt": jax.eval_shape(lambda: jax_opt.init_opt_state(params_t)),
            "data": {"step": jax.ShapeDtypeStruct((), jnp.int32),
                     "epoch": jax.ShapeDtypeStruct((), jnp.int32)}}


class TestAcrossPackages:
    def test_checkpoints_cross_both_ways(self, tmp_path):
        tokens = np.random.RandomState(11).randint(0, 512, (2, 128)).astype(np.int32)
        jb = jax_bundle()
        jstep = jax.jit(jax_tl.make_train_step(
            jb, jax_tl.TrainConfig(optimizer=jax_opt.OptimizerConfig(**OPT))))
        pb = get_model(ARCHS[ARCH].reduced())
        pstep = port_tl.make_train_step(
            pb, port_tl.TrainConfig(optimizer=port_opt.OptimizerConfig(**OPT)))
        data = {"step": np.int32(7), "epoch": np.int32(1)}

        # the JAX package saves; the port restores the same keys and bits
        params = jb.init(jax.random.PRNGKey(0))
        jstate = {"params": params, "opt": jax_opt.init_opt_state(params)}
        jm = JaxManager(tmp_path / "from_jax")
        jm.save(0, {**jstate, "data": data}, blocking=True)
        jm.close()
        pm = VersionedCheckpointManager(tmp_path / "from_jax", device="cpu")
        template = state_template(ARCHS[ARCH].reduced())
        stored = pm.store.checkout(pm.latest_vid())
        assert sorted(k for k, _ in tree_paths_of_template(template)) == sorted(stored)
        restored = pm.restore(template)
        want = jax.tree.map(np.asarray, {**jstate, "data": data})
        same_bits(restored, want)
        pm.close()

        # one more step from either: the same loss
        _, jmet = jstep({**jstate, "error_fb": None}, {"tokens": jnp.asarray(tokens)})
        pstate = {"params": restored["params"], "opt": restored["opt"], "error_fb": None}
        pstate, pmet = pstep(pstate, {"tokens": torch.from_numpy(tokens)})
        assert pmet["loss"].item() == pytest.approx(float(jmet["loss"]), rel=1e-3)

        # the port saves its stepped state; the JAX package restores it
        pm = VersionedCheckpointManager(tmp_path / "from_port", device="cpu")
        pm.save(1, {"params": pstate["params"], "opt": pstate["opt"], "data": data},
                blocking=True)
        pm.close()
        jm = JaxManager(tmp_path / "from_port")
        back = jm.restore(jax_template(jb))
        jm.close()
        same_bits(jax.tree.map(np.asarray, back),
                  {**train_state_to_numpy(pstate), "error_fb": None, "data": data})
        _, jmet2 = jstep({"params": back["params"], "opt": back["opt"], "error_fb": None},
                         {"tokens": jnp.asarray(tokens)})
        _, pmet2 = pstep(train_state_from_numpy(train_state_to_numpy(pstate), "cpu"),
                         {"tokens": torch.from_numpy(tokens)})
        assert pmet2["loss"].item() == pytest.approx(float(jmet2["loss"]), rel=1e-3)


def tree_paths_of_template(template):
    """The store keys a template names ((shape, dtype) pairs are leaves)."""
    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                yield from walk(node[k], path + (k,))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                yield from walk(v, path + (str(i),))
        else:
            yield "/".join(path), node

    return list(walk(template, ()))
