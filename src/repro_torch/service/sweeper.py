"""Background integrity sweeps for a running :class:`DatasetService`.

A long-lived serving process accumulates risk the offline tools never see:
bit-rot in delta payloads, a half-applied repack after a crash, constraint
drift (a storage graph that no longer satisfies the recreation bound δ the
last optimization promised).  :class:`FsckSweeper` runs
:meth:`Repository.fsck` on a configurable cadence under the service's
exclusive write lock — the same quiescing a repack takes — so the whole
version table can be walked without racing in-flight commits.

Findings land in the shared :class:`ServiceMetrics` registry
(``fsck.sweeps``, ``fsck.findings``) and the full
:class:`~repro_torch.analysis.findings.Report` is kept on
``service.last_fsck``.  A ``fsck.constraint`` finding means the stored
chains violate the recreation-cost bound the last repack was solved
against — the sweep counts it under ``fsck.repack_recommended`` and logs a
repack recommendation, since re-solving storage is the fix, not a serving
concern.

When the service carries a :class:`~repro_torch.obs.tradeoff.TradeoffMonitor`
(the default), every sweep also publishes the live (C, R) drift as gauges
(``tradeoff.storage_ratio``, ``tradeoff.access_weighted_recreation_ratio``,
…) and the repack recommendation becomes *quantitative*: the warning says
how far the tradeoff has moved — "access-weighted R is 2.3x the post-repack
baseline" — not just that a constraint broke.
"""

from __future__ import annotations

import asyncio
import logging
from typing import TYPE_CHECKING, Optional

if TYPE_CHECKING:  # pragma: no cover - import cycle (service starts us)
    from .service import DatasetService

logger = logging.getLogger("repro_torch.service")

__all__ = ["FsckSweeper"]


class FsckSweeper:
    """Periodic fsck runner bound to one service (see module docs)."""

    def __init__(
        self,
        service: "DatasetService",
        *,
        interval_s: float,
        sample: Optional[int] = None,
    ) -> None:
        self.service = service
        self.interval_s = float(interval_s)
        self.sample = sample

    async def run(self) -> None:
        """Sweep every ``interval_s`` seconds until cancelled."""
        while True:
            await asyncio.sleep(self.interval_s)
            try:
                await self.sweep()
            except asyncio.CancelledError:
                raise
            except Exception:
                self.service.metrics.inc("errors.fsck")
                logger.exception("background fsck sweep failed")

    async def sweep(self):
        """One sweep: quiesce requests, fsck on a reader thread, record."""
        from ..obs.tracer import get_tracer

        svc = self.service
        tr = get_tracer()
        sp = tr.start("svc.fsck_sweep")
        t0 = svc._loop.time()
        try:
            async with svc._rw.write():
                if tr.enabled:
                    tr.add_event(
                        "svc.quiesce", t0, svc._loop.time(), parent=sp
                    )

                def run_fsck():
                    with tr.attach(sp or None):
                        return svc.repo.fsck(sample=self.sample)

                report = await svc._loop.run_in_executor(
                    svc._reader_pool, run_fsck
                )
        finally:
            sp.end()
        svc.last_fsck = report
        svc.metrics.inc("fsck.sweeps")
        svc.metrics.inc("fsck.findings", len(report.findings))
        if sp:
            sp.set(findings=len(report.findings))
        drift_note = self._publish_tradeoff_drift()
        drift = report.by_rule("fsck.constraint")
        if drift:
            svc.metrics.inc("fsck.repack_recommended")
            logger.warning(
                "fsck: %d constraint-drift finding(s) — stored chains no "
                "longer meet the last optimization's recreation bound; "
                "recommend scheduling a repack%s",
                len(drift),
                f" ({drift_note})" if drift_note else "",
            )
        return report

    def _publish_tradeoff_drift(self) -> Optional[str]:
        """Export the monitor's live drift ratios as ``tradeoff.*`` gauges
        and return the human one-liner for the repack recommendation (or
        ``None`` when no monitor/samples exist)."""
        svc = self.service
        mon = getattr(svc, "_monitor", None) or getattr(
            svc.repo.store, "tradeoff_monitor", None
        )
        if mon is None:
            return None
        # take a fresh sample so the ratios reflect *now*, not the last
        # commit (a sweep may run long after traffic went quiet)
        mon.sample("sweep")
        d = mon.drift()
        if d is None:
            return None
        for key in (
            "storage_ratio",
            "access_weighted_recreation_ratio",
            "recreation_p99_ratio",
        ):
            if d.get(key) is not None:
                svc.metrics.set_gauge(f"tradeoff.{key}", round(d[key], 6))
        svc.metrics.set_gauge("tradeoff.versions_added", d["versions_added"])
        svc.metrics.set_gauge("tradeoff.storage_bytes", d["storage_bytes"])
        return mon.describe_drift()
