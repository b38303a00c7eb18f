"""Elastic scaling + straggler handling (control-plane side): a copy of
``repro.training.elastic``, which imports no JAX but belongs to the JAX
package.

On a 1000+-node fleet, hosts fail and get replaced mid-run.  The data-plane
elasticity (re-sharding checkpoints onto a different mesh) lives in
``checkpoint.restore_to_template(shardings=)``, which places each leaf as a
DTensor on the new mesh.  This module is the control plane that pairs with
it:

* :class:`HostTopology` — the current set of healthy hosts and the
  deterministic assignment of data-pipeline shards to hosts.  On failure or
  join, ``rebalance`` produces a new assignment **and** the pipeline state
  every host should resume from, so the global token stream stays exactly-
  once (batch `i` is a pure function of (seed, i), so shard reassignment is
  just a host_id/n_hosts change).
* :class:`StragglerPolicy` — per-step wall-time tracking with a robust
  deadline (median × tolerance).  The launcher consults it to decide when a
  host should be treated as failed (checkpoint-restore-drop cycle) rather
  than waited on; on synchronous SPMD fleets this is *the* availability
  knob, since one slow host stalls every collective.
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import Dict, List, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class ShardAssignment:
    host_id: int
    n_hosts: int
    resume_step: int


class HostTopology:
    def __init__(self, hosts: Sequence[str]) -> None:
        if not hosts:
            raise ValueError("need at least one host")
        self.hosts: List[str] = sorted(hosts)

    def assignment(self, host: str, *, resume_step: int = 0) -> ShardAssignment:
        return ShardAssignment(
            host_id=self.hosts.index(host),
            n_hosts=len(self.hosts),
            resume_step=resume_step,
        )

    def rebalance(
        self, *, failed: Sequence[str] = (), joined: Sequence[str] = (),
        resume_step: int = 0,
    ) -> Dict[str, ShardAssignment]:
        """New deterministic assignment after membership changes.

        All hosts restart their pipelines at ``resume_step`` (the step of the
        checkpoint being restored) under the new (host_id, n_hosts): since
        batches are pure functions of (seed, step, host_id, n_hosts), the
        global stream after the change is exactly the one a fresh job of the
        new size would produce from that step — no token is lost or doubled
        within the new epoch regime.
        """
        survivors = [h for h in self.hosts if h not in set(failed)]
        for h in joined:
            if h not in survivors:
                survivors.append(h)
        if not survivors:
            raise ValueError("no hosts left after rebalance")
        self.hosts = sorted(survivors)
        return {
            h: self.assignment(h, resume_step=resume_step) for h in self.hosts
        }


class StragglerPolicy:
    """Flag hosts whose step times exceed median × tolerance persistently."""

    def __init__(self, *, tolerance: float = 2.0, patience: int = 3,
                 window: int = 32) -> None:
        self.tolerance = tolerance
        self.patience = patience
        self.window = window
        self._times: Dict[str, List[float]] = {}
        self._strikes: Dict[str, int] = {}

    def record(self, host: str, step_time_s: float) -> None:
        buf = self._times.setdefault(host, [])
        buf.append(step_time_s)
        if len(buf) > self.window:
            buf.pop(0)

    def deadline_s(self) -> Optional[float]:
        latest = [t[-1] for t in self._times.values() if t]
        if len(latest) < 2:
            return None
        return statistics.median(latest) * self.tolerance

    def update_strikes(self) -> None:
        dl = self.deadline_s()
        if dl is None:
            return
        for host, buf in self._times.items():
            if buf and buf[-1] > dl:
                self._strikes[host] = self._strikes.get(host, 0) + 1
            else:
                self._strikes[host] = 0

    def stragglers(self) -> List[str]:
        return sorted(
            h for h, s in self._strikes.items() if s >= self.patience
        )
