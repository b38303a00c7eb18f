"""The port's token pipelines against the JAX package's, on the CPU: the
synthetic batches bit for bit (across hosts, a snapshot and a restore), and
a versioned corpus committed by the JAX package read through the port's
store, epochs included."""

import numpy as np
import pytest
import torch

from repro.data import pipeline as jax_pipe
from repro.store import VersionStore as JaxStore
from repro_torch.data import pipeline as port_pipe
from repro_torch.store import VersionStore


def kw(**extra):
    return dict(vocab=1000, seq_len=33, global_batch=6, seed=7, **extra)


class TestSynthetic:
    @pytest.mark.parametrize("host_id,n_hosts", [(0, 1), (1, 2), (2, 3)])
    def test_batches_bit_for_bit_across_a_restore(self, host_id, n_hosts):
        j = jax_pipe.SyntheticTokenPipeline(**kw(host_id=host_id, n_hosts=n_hosts))
        p = port_pipe.SyntheticTokenPipeline(**kw(host_id=host_id, n_hosts=n_hosts),
                                             device="cpu")
        for _ in range(3):
            got = p.next_batch()["tokens"]
            assert got.dtype == torch.int32 and got.device.type == "cpu"
            np.testing.assert_array_equal(got.numpy(), j.next_batch()["tokens"])
        snap = p.snapshot()
        assert snap == j.snapshot() == {"step": 3, "epoch": 0}
        q = port_pipe.SyntheticTokenPipeline(**kw(host_id=host_id, n_hosts=n_hosts),
                                             device="cpu")
        q.restore(snap)
        for _ in range(2):
            np.testing.assert_array_equal(q.next_batch()["tokens"].numpy(),
                                          j.next_batch()["tokens"])

    def test_state_and_checks(self):
        s = port_pipe.PipelineState(step=5, epoch=2)
        assert port_pipe.PipelineState.from_dict(s.to_dict()) == s
        with pytest.raises(ValueError, match="divide"):
            port_pipe.SyntheticTokenPipeline(**kw(n_hosts=4), device="cpu")

    def test_default_device_is_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default pipeline runs")
        with pytest.raises(RuntimeError, match="CUDA"):
            port_pipe.SyntheticTokenPipeline(**kw())


class TestVersionedCorpus:
    @pytest.mark.parametrize("host_id,n_hosts", [(0, 1), (1, 2)])
    def test_jax_committed_corpus_reads_alike(self, tmp_path, host_id, n_hosts):
        rng = np.random.RandomState(3)
        jstore = JaxStore(tmp_path)
        v1 = jstore.commit({"shard0": rng.randint(0, 500, 900).astype(np.int32),
                            "shard1": rng.randint(0, 500, (20, 31)).astype(np.int64),
                            "meta": np.arange(3)})
        jstore.close()
        common = dict(seq_len=16, global_batch=4, host_id=host_id, n_hosts=n_hosts)
        j = jax_pipe.VersionedDatasetPipeline(JaxStore(tmp_path), v1, **common)
        p = port_pipe.VersionedDatasetPipeline(VersionStore(tmp_path, device="cpu"), v1,
                                               **common)
        assert p.device.type == "cpu" and p.stream.dtype == torch.int32
        np.testing.assert_array_equal(p.stream.numpy(), j.stream)
        epochs = set()
        for _ in range(60):  # 2.7 passes over the 1,520 tokens
            np.testing.assert_array_equal(p.next_batch()["tokens"].numpy(),
                                          j.next_batch()["tokens"])
            assert p.snapshot() == j.snapshot()
            epochs.add(p.state.epoch)
        assert epochs == {0, 1, 2}
        q = port_pipe.VersionedDatasetPipeline(VersionStore(tmp_path, device="cpu"), v1,
                                               **common)
        q.restore(p.snapshot())
        np.testing.assert_array_equal(q.next_batch()["tokens"].numpy(),
                                      j.next_batch()["tokens"])

    def test_version_without_shards_raises(self, tmp_path):
        store = VersionStore(tmp_path, device="cpu")
        vid = store.commit({"x": torch.arange(4)})
        with pytest.raises(ValueError, match="shard"):
            port_pipe.VersionedDatasetPipeline(store, vid, seq_len=2, global_batch=1)
