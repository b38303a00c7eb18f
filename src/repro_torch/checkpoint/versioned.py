"""Versioned checkpointing on top of the VersionStore, as
``repro.checkpoint.versioned`` has it.

The checkpoint manager is where the paper's storage/recreation tradeoff
becomes a *fault-tolerance* control: Problem 6's θ (max recreation cost) is
the restore-latency SLA that bounds the time to recover, and ``repack``
enforces it while shrinking bytes at rest.

* **async saves**: the device-to-host copy is taken on the caller's thread,
  into pinned memory, and the host copy is what gets committed, so the next
  step may overwrite the device tensors; the delta encode (whose
  changed-block masks run on the store's device) and the store I/O run on a
  background thread;
* **branch aware**: fine-tune forks pass explicit parent steps, building the
  DAG the solvers optimize;
* **restore onto the manager's device, or onto a mesh**: checkpoints are
  stored by logical path (the JAX package's keys, so a checkpoint saved by
  either package restores in the other); ``shardings=`` (one
  ``NamedSharding`` of ``repro_torch.distributed.sharding`` or a tree of
  them) makes each leaf a DTensor holding the rank's block: the elastic
  restore, whose mesh may differ from the one that saved;
* **emergency saves**: a synchronous path for preemption handlers.

The manager runs on its store's device, the card unless the caller passes
``device="cpu"`` (or a store of its own).  A background repack stays
best-effort, as in the JAX package, so it never stops training; its
exception is kept in ``last_repack_error`` and counted in ``repack_errors``.
"""

from __future__ import annotations

import concurrent.futures
import threading
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch

from ..core import OptimizeSpec
from ..distributed.sharding import NamedSharding
from ..kernels import resolve_device
from ..store import VersionStore
from ..store.convert import tensor_from_numpy
from ..store.delta import FlatTree
from ..tree import tree_map

class VersionedCheckpointManager:
    def __init__(
        self,
        directory: str | Path,
        *,
        store: Optional[VersionStore] = None,
        max_restore_cost_s: Optional[float] = None,
        repack_every: int = 0,
        device: Union[str, torch.device] = "cuda",
    ) -> None:
        """A manager over ``store``, or over a new ``VersionStore`` at
        ``directory`` on ``device``; it restores onto the store's device."""
        self.store = store if store is not None else VersionStore(directory, device=device)
        self.device = self.store.device
        self.max_restore_cost_s = max_restore_cost_s
        self.repack_every = repack_every
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ckpt"
        )
        self._pending: Optional[concurrent.futures.Future] = None
        self._lock = threading.Lock()
        self.step_to_vid: Dict[int, int] = {}
        self._saves_since_repack = 0
        self.last_repack_error: Optional[BaseException] = None
        self.repack_errors = 0
        # recover the step map from persisted commit messages (restart path)
        for meta in self.store.log():
            for part in meta.message.split():
                if part.startswith("step="):
                    try:
                        self.step_to_vid[int(part[5:])] = meta.vid
                    except ValueError:
                        pass

    # ---------------------------------------------------------------- save
    def save(
        self,
        step: int,
        state: Any,
        *,
        parent_steps: Optional[Sequence[int]] = None,
        message: str = "",
        blocking: bool = False,
    ) -> None:
        """Commit ``state`` (a tree) as a child of the previous checkpoint.
        Returns once the state is copied to the host; the commit runs in the
        background unless ``blocking``."""
        host_state = host_copy(state)
        # the previous save's commit must land first: its vid is the parent
        # (the JAX package reads the step map before it waits, so a save
        # right behind another may lose its parent)
        self.wait()
        if parent_steps is None:
            parents = [self.latest_vid()] if self.step_to_vid else []
        else:
            parents = [self.step_to_vid[s] for s in parent_steps]
        parents = [p for p in parents if p is not None]

        def _commit():
            vid = self.store.commit(
                host_state, parents=parents, message=message or f"step={step}"
            )
            with self._lock:
                self.step_to_vid[step] = vid
                self._saves_since_repack += 1
                if self.repack_every and self._saves_since_repack >= self.repack_every:
                    self._saves_since_repack = 0
                    self._auto_repack()
            return vid

        fut = self._pool.submit(_commit)
        self._pending = fut
        if blocking:
            fut.result()

    def emergency_save(self, step: int, state: Any) -> int:
        """Synchronous save for preemption handlers (always blocking)."""
        self.save(step, state, message=f"EMERGENCY step={step}", blocking=True)
        return self.step_to_vid[step]

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    # -------------------------------------------------------------- restore
    def latest_vid(self) -> Optional[int]:
        if not self.step_to_vid:
            return None
        return self.step_to_vid[max(self.step_to_vid)]

    def latest_step(self) -> Optional[int]:
        return max(self.step_to_vid) if self.step_to_vid else None

    def restore(self, template: Any, *, step: Optional[int] = None,
                shardings: Any = None) -> Any:
        """Rebuild ``template``-shaped state from the store, on the manager's
        device.  ``template`` is a tree of tensors (any device, ``meta``
        included), numpy arrays or ``(shape, dtype)`` pairs giving the
        logical structure; ``shardings`` (a tree of its structure or a
        single sharding) re-shards each leaf onto a mesh
        (:func:`restore_to_template`)."""
        self.wait()
        vid = self.step_to_vid[step] if step is not None else self.latest_vid()
        if vid is None:
            raise FileNotFoundError("no checkpoints saved")
        flat = self.store.checkout(vid)
        return restore_to_template(flat, template, shardings, device=self.device)

    def restore_cost_s(self, step: Optional[int] = None) -> float:
        vid = self.step_to_vid[step] if step is not None else self.latest_vid()
        return self.store.recreation_cost(vid)

    # --------------------------------------------------------------- repack
    def sla_spec(self, theta: Optional[float] = None) -> OptimizeSpec:
        """The restore-latency SLA as a declarative spec: Problem 6
        (min storage s.t. max R_i ≤ θ) with θ = ``max_restore_cost_s``."""
        theta = theta if theta is not None else self.max_restore_cost_s
        if theta is None:
            raise ValueError("set max_restore_cost_s or pass theta=")
        return OptimizeSpec.problem(6, theta=theta)

    def repack(self, spec: Optional[OptimizeSpec] = None, *,
               theta: Optional[float] = None, **kw) -> Dict:
        """Re-optimize storage against an OptimizeSpec; the default enforces
        the restore-latency SLA (:meth:`sla_spec`).  The solver runs on the
        store's device."""
        self.wait()
        if spec is None:
            spec = self.sla_spec(theta)
        return self.store.repack(spec, **kw)

    def _auto_repack(self) -> None:
        # best-effort in the background, as in the JAX package: a failed
        # repack must not stop training, but it is kept and counted.  It runs
        # inside the save's own commit, so it calls the store directly: the
        # JAX package's call of repack() waits on that commit and never ends
        try:
            self.store.repack(self.sla_spec())
        except Exception as exc:  # noqa: BLE001 - recorded for the caller
            self.last_repack_error = exc
            self.repack_errors += 1

    def close(self) -> None:
        self.wait()
        self._pool.shutdown(wait=True)
        # persist access counts accumulated by restores, so a later
        # repack(use_access_frequencies=True) sees the real workload
        self.store.close()


def host_copy(state: Any) -> Any:
    """A host copy of every leaf of ``state``: CUDA tensors go to pinned
    memory (one synchronisation for all), CPU tensors are cloned (the train
    step updates them in place), numpy leaves pass as arrays."""
    streams = set()

    def one(x):
        if isinstance(x, torch.Tensor):
            x = x.detach()
            if x.device.type == "cuda":
                out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                out.copy_(x, non_blocking=True)
                streams.add(torch.cuda.current_stream(x.device))
                return out
            return x.clone()
        return np.asarray(x)

    host = tree_map(one, state)
    for stream in streams:
        stream.synchronize()
    return host


def _leaf_dtype(leaf: Any) -> torch.dtype:
    if isinstance(leaf, torch.Tensor):
        return leaf.dtype
    if isinstance(leaf, tuple):
        return leaf[1]
    return tensor_from_numpy(np.zeros((), np.asarray(leaf).dtype)).dtype


def _is_pair(node: Any) -> bool:
    return isinstance(node, tuple) and len(node) == 2 and isinstance(node[1], torch.dtype)


def _sub(sh: Any, k: Any) -> Any:
    """The shardings under key or index ``k``: a single sharding (or none)
    covers the whole subtree."""
    if sh is None or isinstance(sh, NamedSharding):
        return sh
    return sh.get(k) if isinstance(sh, dict) else sh[k]


def restore_to_template(flat: FlatTree, template: Any, shardings: Any = None,
                        *, device: Union[str, torch.device] = "cuda") -> Any:
    """Match store paths onto ``template``'s structure; each leaf is cast to
    the template's dtype and copied onto ``device`` (never shared with the
    store's cache, which a train step must not write into).  With
    ``shardings`` (one ``NamedSharding``, or a tree of them with the
    template's structure) each leaf becomes a DTensor on the sharding's mesh,
    on the mesh's device type, whose local tensor is this rank's block."""
    device = resolve_device(device)

    def build(node: Any, path: tuple, sh: Any) -> Any:
        if isinstance(node, dict):
            return {k: build(v, path + (str(k),), _sub(sh, k)) for k, v in node.items()}
        if isinstance(node, (list, tuple)) and not _is_pair(node):
            return type(node)(build(v, path + (str(i),), _sub(sh, i))
                              for i, v in enumerate(node))
        if node is None:
            return None
        key = "/".join(path)
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        if sh is None:
            return flat[key].to(device=device, dtype=_leaf_dtype(node), copy=True)
        if not isinstance(sh, NamedSharding):
            raise TypeError(f"leaf {key!r}: a sharding must be a NamedSharding, not {sh!r}")
        from torch.distributed.tensor import distribute_tensor

        mesh = sh.mesh
        leaf = flat[key].to(device=mesh.device_type, dtype=_leaf_dtype(node), copy=True)
        # every rank reads the same store: each keeps its own block, no scatter
        return distribute_tensor(leaf, mesh, sh.placements, src_data_rank=None)

    return build(template, (), shardings)
