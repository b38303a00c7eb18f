"""The port's training driver on the CPU (``device="cpu"``): twins of
tests/test_train_driver.py (preempt, resume, repack; accumulation and
compression) and of tests/test_elastic.py (host topology, the exactly-once
stream, the straggler policy), plus the command line."""

import numpy as np
import pytest
import torch

from repro.data.pipeline import SyntheticTokenPipeline as JaxPipeline
from repro_torch.checkpoint import PreemptionGuard
from repro_torch.data.pipeline import SyntheticTokenPipeline
from repro_torch.launch import train as train_mod
from repro_torch.launch.train import RunConfig, train
from repro_torch.models.convert import train_state_to_numpy
from repro_torch.training.elastic import HostTopology, StragglerPolicy
from repro_torch.tree import tree_paths


class PreemptAt(PreemptionGuard):
    def __init__(self, at):
        super().__init__()
        self.at = at
        self.count = 0

    @property
    def preempted(self):
        self.count += 1
        return self.count >= self.at


class TestDriver:
    def test_train_preempt_resume_repack(self, tmp_path):
        common = dict(
            arch="minicpm-2b", reduced=True, steps=16, seq_len=64,
            global_batch=4, save_every=4, ckpt_dir=str(tmp_path),
            max_restore_cost_s=30.0,
        )
        out1 = train(RunConfig(**common), guard=PreemptAt(at=8), log_every=100, device="cpu")
        assert out1["preempted"]
        assert 0 < out1["steps_done"] < 16
        out1["manager"].close()

        out2 = train(RunConfig(**common), log_every=100, device="cpu")
        assert not out2["preempted"]
        losses = out1["losses"] + out2["losses"]
        assert len(losses) == 16  # no step repeated or skipped
        assert losses[-1] < losses[0]
        assert len(out2["step_s"]) == out2["steps_done"] and min(out2["step_s"]) > 0
        # the resumed pipeline continues the uninterrupted stream
        ref = SyntheticTokenPipeline(vocab=512, seq_len=64, global_batch=4, device="cpu")
        for _ in range(16):
            ref.next_tokens()
        assert out2["pipe"].snapshot() == ref.snapshot()

        mgr = out2["manager"]
        stats = mgr.repack()
        assert stats["optimize"]["problem"] == 6 and stats["optimize"]["backend"] == "torch"
        assert stats["after"]["max_recreation_s"] <= 30.0
        assert mgr.last_repack_error is None
        mgr.close()

    def test_train_grad_accum_and_compression_run(self, tmp_path):
        out = train(RunConfig(
            arch="minitron-4b", reduced=True, steps=4, seq_len=32,
            global_batch=4, save_every=0, ckpt_dir=str(tmp_path),
            grad_accum=2, compress_grads=True,
        ), log_every=100, device="cpu")
        assert out["steps_done"] == 4
        assert np.isfinite(out["losses"]).all() and np.isfinite(out["grad_norms"]).all()
        assert out["final_state"]["error_fb"] is not None
        out["manager"].close()

    def test_command_line(self, tmp_path, capsys):
        with pytest.raises(SystemExit) as done:
            train_mod.main(["--device", "cpu", "--steps", "3", "--seq-len", "32",
                            "--global-batch", "2", "--save-every", "2",
                            "--ckpt-dir", str(tmp_path)])
        assert done.value.code == 0
        assert "[train] done: 3 steps" in capsys.readouterr().out

    def test_default_device_is_the_card(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default run trains")
        with pytest.raises(RuntimeError, match="CUDA"):
            train(RunConfig(steps=1, ckpt_dir=str(tmp_path)))


    @pytest.mark.parametrize("arch", ["deepseek-v3-671b", "phi3.5-moe-42b-a6.6b"])
    def test_moe_and_mla_families_do_not_train_yet(self, tmp_path, arch):
        """The MoE and MLA families, which the driver once refused, train:
        reduced DeepSeek-V3 (MLA, its MTP loss) and Phi-3.5-MoE through
        saves, a preemption and a resume.  The state the emergency save
        stored comes back leaf for leaf, bit for bit, with its dtypes (the f32
        routers, the MTP head's subtree), and the resumed run ends where an
        uninterrupted stream would."""
        common = dict(arch=arch, reduced=True, steps=6, seq_len=32, global_batch=2,
                      save_every=2, ckpt_dir=str(tmp_path), max_restore_cost_s=30.0)
        out1 = train(RunConfig(**common), guard=PreemptAt(at=3), log_every=100, device="cpu")
        assert out1["preempted"] and out1["steps_done"] == 3
        mgr = out1["manager"]
        saved = train_state_to_numpy({k: out1["final_state"][k] for k in ("params", "opt")})
        restored = train_state_to_numpy(mgr.restore(train_mod.state_template(
            train_mod.run_model_config(RunConfig(**common)))))
        paths = [k for k, _ in tree_paths(saved)]
        assert paths == [k for k, _ in tree_paths({"params": restored["params"],
                                                   "opt": restored["opt"]})]
        assert any(k.endswith("moe/router") for k in paths)
        assert any(k.startswith("params/mtp/") for k in paths) == (arch == "deepseek-v3-671b")
        for (k, a), (_, b) in zip(tree_paths(saved), tree_paths(
                {"params": restored["params"], "opt": restored["opt"]})):
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), k
            if k.endswith("moe/router") and k.startswith("params/"):
                assert a.dtype == np.float32
        mgr.close()

        out2 = train(RunConfig(**common), log_every=100, device="cpu")
        assert not out2["preempted"] and out2["steps_done"] == 3
        losses = out1["losses"] + out2["losses"]
        assert len(losses) == 6 and np.isfinite(losses).all()
        ref = SyntheticTokenPipeline(vocab=512, seq_len=32, global_batch=2, device="cpu")
        for _ in range(6):
            ref.next_tokens()
        assert out2["pipe"].snapshot() == ref.snapshot()
        out2["manager"].close()


class TestHostTopology:
    def test_rebalance_after_failure(self):
        topo = HostTopology(["h0", "h1", "h2", "h3"])
        a = topo.rebalance(failed=["h2"], resume_step=100)
        assert set(a) == {"h0", "h1", "h3"}
        assert all(v.n_hosts == 3 and v.resume_step == 100 for v in a.values())
        assert sorted(v.host_id for v in a.values()) == [0, 1, 2]

    def test_join_after_replacement(self):
        topo = HostTopology(["h0", "h1"])
        a = topo.rebalance(joined=["h9"], resume_step=7)
        assert set(a) == {"h0", "h1", "h9"}
        with pytest.raises(ValueError):
            HostTopology([])

    def test_stream_is_exactly_the_smaller_jobs_stream(self):
        """After dropping a host, survivors produce the same global stream a
        fresh 3-host job would (the exactly-once contract), and the same
        tokens as the JAX package's pipelines."""
        topo = HostTopology(["h0", "h1", "h2", "h3"])
        assign = topo.rebalance(failed=["h3"], resume_step=5)

        def batch_for(host, step, cls=SyntheticTokenPipeline, **extra):
            a = assign[host]
            p = cls(vocab=100, seq_len=8, global_batch=6, host_id=a.host_id,
                    n_hosts=a.n_hosts, seed=0, **extra)
            p.state.step = step
            return np.asarray(p.next_batch()["tokens"])

        fresh = [SyntheticTokenPipeline(vocab=100, seq_len=8, global_batch=6,
                                        host_id=i, n_hosts=3, seed=0, device="cpu")
                 for i in range(3)]
        for f in fresh:
            f.state.step = 5
        for host, ref in zip(sorted(assign), fresh):
            got = batch_for(host, 5, device="cpu")
            np.testing.assert_array_equal(got, ref.next_batch()["tokens"].numpy())
            np.testing.assert_array_equal(got, batch_for(host, 5, JaxPipeline))


class TestStragglerPolicy:
    def test_flags_persistent_straggler_only(self):
        pol = StragglerPolicy(tolerance=2.0, patience=2)
        for _ in range(4):
            for h in ("h0", "h1", "h2"):
                pol.record(h, 1.0)
            pol.record("slow", 5.0)
            pol.update_strikes()
        assert pol.stragglers() == ["slow"]

    def test_transient_blip_not_flagged(self):
        pol = StragglerPolicy(tolerance=2.0, patience=3)
        for h in ("h0", "h1", "h2"):
            pol.record(h, 1.0)
        pol.record("blip", 9.0)
        pol.update_strikes()
        for _ in range(3):
            for h in ("h0", "h1", "h2", "blip"):
                pol.record(h, 1.0)
            pol.update_strikes()
        assert pol.stragglers() == []

    def test_no_deadline_with_single_host_and_window(self):
        pol = StragglerPolicy(window=2)
        pol.record("h0", 1.0)
        assert pol.deadline_s() is None
        for t in (1.0, 2.0, 3.0):
            pol.record("h0", t)
        assert pol._times["h0"] == [2.0, 3.0]
