"""Deterministic, resumable, host-sharded token pipelines, as
``repro.data.pipeline`` has them.

* **determinism**: batch ``i`` of host ``h`` is a pure function of
  (seed, i, h), drawn with the JAX package's ``np.random.RandomState``
  seeding, so both packages give the same tokens bit for bit and restarts
  and elastic re-host-counts replay identically;
* **checkpointable state**: the iterator state is a tiny tree committed to
  the version store next to the weights, so a restore resumes mid-epoch with
  no data lost or repeated;
* **versioned corpora**: a dataset is a set of shard payloads in the
  VersionStore; switching corpus versions is a version-graph checkout.

Batches are ``{"tokens": (B, S) int32}`` tensors on the pipeline's device,
the card unless the caller passes ``device="cpu"``: the synthetic tokens go
up through pinned memory without blocking the host; a versioned corpus is
uploaded once and its windows are cut on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import numpy as np
import torch

from ..kernels import resolve_device
from ..store import VersionStore


@dataclasses.dataclass
class PipelineState:
    step: int = 0
    epoch: int = 0

    def to_dict(self) -> Dict[str, int]:
        return {"step": self.step, "epoch": self.epoch}

    @classmethod
    def from_dict(cls, d) -> "PipelineState":
        return cls(step=int(d["step"]), epoch=int(d["epoch"]))


def upload(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A CPU tensor on ``device``; a CUDA copy goes through pinned memory with
    ``non_blocking=True``."""
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


class SyntheticTokenPipeline:
    """Seeded synthetic LM batches (a markov-ish stream with local structure,
    so cross entropy actually decreases during the example runs)."""

    def __init__(
        self,
        *,
        vocab: int,
        seq_len: int,
        global_batch: int,
        host_id: int = 0,
        n_hosts: int = 1,
        seed: int = 0,
        state: Optional[PipelineState] = None,
        device: Union[str, torch.device] = "cuda",
    ) -> None:
        if global_batch % n_hosts:
            raise ValueError(f"global_batch {global_batch} must divide among {n_hosts} hosts")
        self.device = resolve_device(device)
        self.vocab = vocab
        self.seq_len = seq_len
        self.local_batch = global_batch // n_hosts
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.seed = seed
        self.state = state or PipelineState()

    def _batch_rng(self, step: int) -> np.random.RandomState:
        return np.random.RandomState(
            (self.seed * 1_000_003 + step * 65_537 + self.host_id) % (2**31)
        )

    def next_tokens(self) -> np.ndarray:
        """The next batch's tokens on the host, (B, S) int32."""
        rng = self._batch_rng(self.state.step)
        B, S, V = self.local_batch, self.seq_len, self.vocab
        # structured stream: short arithmetic token runs + repeats => learnable
        starts = rng.randint(0, V, size=(B, 1))
        deltas = rng.randint(1, 4, size=(B, 1))
        ramp = (starts + deltas * np.arange(S)[None, :]) % V
        noise_mask = rng.rand(B, S) < 0.1
        noise = rng.randint(0, V, size=(B, S))
        tokens = np.where(noise_mask, noise, ramp).astype(np.int32)
        self.state.step += 1
        return tokens

    def next_batch(self) -> Dict[str, torch.Tensor]:
        return {"tokens": upload(torch.from_numpy(self.next_tokens()), self.device)}

    # resumability -----------------------------------------------------------
    def snapshot(self) -> Dict[str, int]:
        return self.state.to_dict()

    def restore(self, snap: Dict[str, int]) -> None:
        self.state = PipelineState.from_dict(snap)


class VersionedDatasetPipeline:
    """Reads tokenized shards from a VersionStore version (a committed
    dataset), host-sharded and resumable, on the store's device unless
    ``device`` is given."""

    def __init__(
        self,
        store: VersionStore,
        version_id: int,
        *,
        seq_len: int,
        global_batch: int,
        host_id: int = 0,
        n_hosts: int = 1,
        state: Optional[PipelineState] = None,
        device: Union[str, torch.device, None] = None,
    ) -> None:
        self.store = store
        self.version_id = version_id
        self.device = resolve_device(store.device if device is None else device)
        flat = store.checkout(version_id)
        shards = [flat[k] for k in sorted(flat) if k.startswith("shard")]
        if not shards:
            raise ValueError("dataset version has no 'shard*' arrays")
        dtype = shards[0].dtype
        for s in shards[1:]:
            dtype = torch.promote_types(dtype, s.dtype)
        stream = torch.cat([s.reshape(-1).to(dtype) for s in shards]).to(torch.int32)
        self.stream = upload(stream, self.device)
        self.seq_len = seq_len
        self.local_batch = global_batch // n_hosts
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.state = state or PipelineState()
        self.tokens_per_batch = self.local_batch * (seq_len + 1)

    def next_batch(self) -> Dict[str, torch.Tensor]:
        n = self.stream.numel()
        need = self.tokens_per_batch
        # host-interleaved contiguous windows
        offset = (
            (self.state.step * self.n_hosts + self.host_id) * need
        ) % max(1, n - need)
        window = self.stream[offset: offset + need]
        tokens = window[: self.local_batch * self.seq_len].reshape(
            self.local_batch, self.seq_len
        )
        self.state.step += 1
        if (self.state.step * self.n_hosts * need) // max(1, n) > self.state.epoch:
            self.state.epoch += 1
        return {"tokens": tokens.clone()}

    def snapshot(self) -> Dict[str, int]:
        return {**self.state.to_dict(), "dataset_version": self.version_id}

    def restore(self, snap) -> None:
        self.state = PipelineState.from_dict(snap)
