"""DatasetService — concurrent serving front-end over a :class:`Repository`.

The paper's recreation cost Φ only matters under retrieval traffic; this is
the tier that takes that traffic (the OrpheusDB/DataHub "bolt-on serving
front-end" shape): an asyncio event loop accepting checkout / commit / log /
diff / repack requests and dispatching the CPU/device-bound work onto thread
pools, with three load-bearing mechanisms:

* **Request coalescing** — a checkout resolves its ref to a vid at enqueue
  time (the snapshot point); if a materialization for that vid is already in
  flight, the request awaits the same future instead of decoding twice
  (``checkout.coalesced`` counts these).  Correct because a version's
  content is immutable: whatever commit lands meanwhile, vid → tree never
  changes.  Each waiter after the first gets its own copy of the tree, made
  before any waiter resumes, so a client may write into what it was given.
  Waiters await the shared future through ``asyncio.shield`` — a client
  timeout cancelling one coalesced request cannot cancel the future the
  other waiters share.

* **Batching window** — distinct vids arriving within ``batch_window_s``
  fold into one :meth:`VersionStore.checkout_many` plan (capped at
  ``max_batch``), so chain prefixes shared across concurrent requests decode
  exactly once.  The batch runs on a reader thread-pool worker; requesters
  await per-vid futures.

* **Single-writer / multi-reader coordination** — commits serialize on a
  one-thread writer pool and may overlap with readers (a commit only
  *appends* to the storage graph, and the append-aware cache keeps reader
  state warm across it — see ``cache_invalidation="chain"`` on
  ``VersionStore``).  ``repack`` and the background fsck sweep take the
  exclusive side of an async reader-writer lock, quiescing every in-flight
  request before the storage graph rewrites under them.  Each enqueued
  checkout additionally parks a read claim on its batch (released when the
  batch settles), so the quiesce covers pending/dispatching batches even
  when the requesters behind them were cancelled.

Reads are snapshot-consistent: ref resolution happens once per request on
the event loop, so a ``checkout("main")`` racing a commit observes either
the old or the new tip, never a torn mix — and the tree it returns is the
immutable content of whichever vid it resolved.

Per-request metrics (queue wait, decode time, warm-hit attribution,
p50/p99 end-to-end latency) record into :class:`ServiceMetrics`; a
configurable :class:`~repro_torch.service.sweeper.FsckSweeper` surfaces integrity
findings and repack recommendations through the same registry.

Usage::

    repo = Repository(root)
    async with DatasetService(repo, readers=8) as svc:
        tree = await svc.checkout("main")
        vid = await svc.commit(new_tree, message="nightly refresh")
        print(svc.stats()["counters"])

All public coroutines must run on the loop that ``start()`` ran on.

The port's copy of the JAX package's ``repro.service.service``: the same
coalescing, batching window, shielded futures, parked read claims, metric
names and spans.  What differs is underneath: the store decodes and encodes
on its device with the port's kernels.  Every kernel launch and every device
synchronisation happens on a pool thread (``run_in_executor``), never on
the event loop.  All pool threads launch on the device's default stream,
PyTorch's per-thread current stream unless a caller sets another, so work
handed from one thread to the next is ordered without events, and
``delta._to_host`` synchronises the stream its own copies were queued on.
The first kernel call builds the kernels under a lock; a failed build
raises into the request's future like any other decode error.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Set, Union

from ..core import OptimizeSpec
from ..obs.tracer import get_tracer
from ..obs.tradeoff import TradeoffMonitor
from ..store.delta import FlatTree
from ..store.repository import Ref, Repository, TreeDiff
from .metrics import ServiceMetrics

logger = logging.getLogger("repro_torch.service")

__all__ = ["DatasetService"]


class _AsyncRWLock:
    """Async reader-writer lock: checkouts/commits/log/diff share the read
    side; repack and fsck take the write side, draining readers first.  A
    waiting writer blocks new readers, so sustained read traffic cannot
    starve a repack."""

    def __init__(self) -> None:
        self._readers = 0
        self._writer = False
        self._cond: Optional[asyncio.Condition] = None

    def _condition(self) -> asyncio.Condition:
        if self._cond is None:  # created lazily on the running loop
            self._cond = asyncio.Condition()
        return self._cond

    @contextlib.asynccontextmanager
    async def read(self):
        cond = self._condition()
        async with cond:
            await cond.wait_for(lambda: not self._writer)
            self._readers += 1
        try:
            yield
        finally:
            async with cond:
                self._readers -= 1
                cond.notify_all()

    @contextlib.asynccontextmanager
    async def write(self):
        cond = self._condition()
        async with cond:
            await cond.wait_for(lambda: not self._writer)
            self._writer = True
            try:
                await cond.wait_for(lambda: self._readers == 0)
            except BaseException:
                # cancelled mid-acquire: drop the claim or the flag leaks
                # and every later reader/writer blocks forever
                self._writer = False
                cond.notify_all()
                raise
        try:
            yield
        finally:
            async with cond:
                self._writer = False
                cond.notify_all()

    def claim_read_nowait(self) -> None:
        """Add one read claim synchronously.  Caller must already hold the
        read side (``_readers > 0`` and therefore no active writer), so the
        increment needs no waiting and — being await-free on the event
        loop — cannot be torn by a cancellation.  Pair with
        :meth:`release_read`."""
        if self._readers <= 0:
            raise RuntimeError("claim_read_nowait without a held read lock")
        self._readers += 1

    async def release_read(self, n: int = 1) -> None:
        """Release ``n`` claims taken via :meth:`claim_read_nowait`."""
        cond = self._condition()
        async with cond:
            self._readers -= n
            cond.notify_all()


def _own_copies(tree: FlatTree, n: int) -> List[FlatTree]:
    """``tree`` and ``n - 1`` copies of it that share no storage."""
    return [tree] + [
        {k: t.clone() for k, t in tree.items()} for _ in range(n - 1)
    ]


@dataclasses.dataclass
class _PendingCheckout:
    """One enqueued checkout awaiting its batch: vid, future, enqueue time,
    and (when tracing) the request's root span — the batch dispatcher
    parents the retroactive queue-wait span under it."""

    vid: int
    future: "asyncio.Future[List[FlatTree]]"
    enqueued_at: float
    span: Any = None


class DatasetService:
    """Asyncio serving tier over a :class:`Repository` (see module docs).

    Construct, then ``await start()`` (or use ``async with``).  Knobs:

    * ``readers`` — checkout/log/diff thread-pool width (checkouts are
      CPU/device-bound; the event loop itself never decodes).
    * ``batch_window_s`` — how long a checkout waits for co-batchable
      requests before dispatching; ``0`` dispatches on the next loop tick.
    * ``max_batch`` — dispatch immediately once this many distinct vids are
      pending, whatever the window says.
    * ``fsck_interval_s`` — run a background integrity sweep this often
      (``None`` disables; see :class:`FsckSweeper`).  ``fsck_sample``
      bounds the expensive per-version re-decode.
    * ``tradeoff`` — attach a :class:`~repro_torch.obs.tradeoff.TradeoffMonitor`
      to the store for the service's lifetime (default on): live (C, R)
      samples on every commit/repack, surfaced through :meth:`stats`,
      the sweeper's drift gauges, and the Prometheus exporter.

    Tracing: the request path records spans into the process-global
    :mod:`repro_torch.obs` tracer (disabled by default — the instrumentation then
    costs one attribute check per request stage).  Enable with
    ``repro_torch.obs.tracing()`` around the service, or install a tracer via
    ``repro_torch.obs.set_tracer``.  Span times share the event loop's
    ``time.monotonic`` clock, so per-stage span totals reconcile exactly
    with the ``ServiceMetrics`` latency tracks.
    """

    def __init__(
        self,
        repo: Repository,
        *,
        readers: int = 4,
        batch_window_s: float = 0.002,
        max_batch: int = 32,
        fsck_interval_s: Optional[float] = None,
        fsck_sample: Optional[int] = None,
        metrics_cap: int = 100_000,
        tradeoff: bool = True,
    ) -> None:
        if readers < 1:
            raise ValueError(f"need at least one reader thread, got {readers}")
        self.repo = repo
        self.readers = int(readers)
        self.batch_window_s = float(batch_window_s)
        self.max_batch = int(max_batch)
        self.fsck_interval_s = fsck_interval_s
        self.fsck_sample = fsck_sample
        self.metrics = ServiceMetrics(track_cap=metrics_cap)
        self.tradeoff = bool(tradeoff)
        self._owns_monitor = False
        self._monitor: Optional[TradeoffMonitor] = None
        self.last_fsck = None  # most recent sweep Report (sweeper writes it)
        self._rw = _AsyncRWLock()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._reader_pool: Optional[ThreadPoolExecutor] = None
        self._writer_pool: Optional[ThreadPoolExecutor] = None
        # vid -> the future its requests share, settled with one tree a
        # request; _sharers counts the requests on it
        self._inflight: Dict[int, "asyncio.Future[List[FlatTree]]"] = {}
        self._sharers: Dict[int, int] = {}
        self._pending: List[_PendingCheckout] = []
        self._window_handle: Optional[asyncio.TimerHandle] = None
        self._dispatch_tasks: Set["asyncio.Task"] = set()
        self._sweep_task: Optional["asyncio.Task"] = None
        self._started = False

    # ------------------------------------------------------------ lifecycle
    async def start(self) -> "DatasetService":
        """Bind to the running loop, spin up pools and the fsck sweeper."""
        if self._started:
            raise RuntimeError("service already started")
        self._loop = asyncio.get_running_loop()
        self._reader_pool = ThreadPoolExecutor(
            max_workers=self.readers, thread_name_prefix="repro-svc-read"
        )
        self._writer_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="repro-svc-write"
        )
        if self.tradeoff and self.repo.store.tradeoff_monitor is None:
            self.repo.store.tradeoff_monitor = TradeoffMonitor(self.repo.store)
            self._owns_monitor = True
            self.repo.store.tradeoff_monitor.sample("start")
        self._monitor = self.repo.store.tradeoff_monitor
        self._started = True
        if self.fsck_interval_s is not None:
            from .sweeper import FsckSweeper  # local: sweeper imports us

            sweeper = FsckSweeper(
                self, interval_s=self.fsck_interval_s, sample=self.fsck_sample
            )
            self._sweep_task = self._loop.create_task(sweeper.run())
        return self

    async def stop(self) -> None:
        """Drain in-flight work, stop the sweeper, flush access counts."""
        if not self._started:
            return
        self._started = False  # new requests now refuse
        if self._sweep_task is not None:
            self._sweep_task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._sweep_task
            self._sweep_task = None
        self._dispatch_now()  # whatever the window was still holding
        while self._dispatch_tasks:
            tasks = list(self._dispatch_tasks)
            await asyncio.gather(*tasks, return_exceptions=True)
            # drop them here: gather over tasks that are all done completes
            # without yielding (Python 3.12), so the done callbacks that
            # discard them would never get to run and this loop would spin
            self._dispatch_tasks.difference_update(tasks)
        # quiesce: taking the write side proves no reader remains in flight
        async with self._rw.write():
            pass
        self._reader_pool.shutdown(wait=True)
        self._writer_pool.shutdown(wait=True)
        if self._owns_monitor:
            # detach so store-layer bulk commits stop paying O(n) sampling;
            # self._monitor keeps the history readable through stats()
            self.repo.store.tradeoff_monitor = None
            self._owns_monitor = False
        self.repo.store.flush_access_counts()

    async def __aenter__(self) -> "DatasetService":
        return await self.start()

    async def __aexit__(self, *exc: Any) -> None:
        await self.stop()

    def _require_started(self) -> None:
        if not self._started:
            raise RuntimeError(
                "DatasetService not started (await start() or use "
                "'async with DatasetService(...)')"
            )

    # ------------------------------------------------------------- checkout
    async def checkout(self, ref: Optional[Ref] = None) -> FlatTree:
        """Materialize the tree at ``ref`` (default: head tip).

        Coalesces with any in-flight materialization of the same vid and
        folds into the current batching window otherwise.  The tree is the
        request's own: it shares no storage with the cache or with another
        request's tree.
        """
        self._require_started()
        t0 = self._loop.time()
        self.metrics.inc("requests.checkout")
        tr = get_tracer()
        sp = tr.start("svc.checkout")  # request root span (NULL when disabled)
        try:
            async with self._rw.read():
                vid = self.repo.resolve(ref)  # snapshot point
                fut = self._inflight.get(vid)
                if fut is not None:
                    self._sharers[vid] += 1
                    self.metrics.inc("checkout.coalesced")
                    if sp:
                        sp.set(vid=vid, coalesced=True)
                else:
                    fut = self._loop.create_future()
                    self._inflight[vid] = fut
                    self._sharers[vid] = 1
                    # the pending entry itself holds a read claim (released
                    # by _dispatch after the batch settles), so a repack
                    # cannot slip between enqueue and dispatch even if
                    # every requester behind the batch is cancelled
                    self._rw.claim_read_nowait()
                    if sp:
                        sp.set(vid=vid, coalesced=False)
                    self._pending.append(
                        _PendingCheckout(vid, fut, t0, sp or None)
                    )
                    self._arm_window()
                # shield: the future is shared by every request coalesced
                # onto this vid — one waiter's cancellation must neither
                # cancel the others nor poison _inflight with a cancelled
                # future for later arrivals
                tree = (await asyncio.shield(fut)).pop()
        except Exception:
            self.metrics.inc("errors.checkout")
            if sp:
                sp.set(error=True)
            raise
        finally:
            sp.end()
        self.metrics.observe("latency.checkout", self._loop.time() - t0)
        return dict(tree)

    async def checkout_many(self, refs: Sequence[Ref]) -> List[FlatTree]:
        """Concurrent checkouts of several refs — they coalesce and batch
        against each other exactly like independent requests."""
        return list(
            await asyncio.gather(*(self.checkout(r) for r in refs))
        )

    def _arm_window(self) -> None:
        if len(self._pending) >= self.max_batch:
            self._dispatch_now()
        elif self._window_handle is None:
            self._window_handle = self._loop.call_later(
                self.batch_window_s, self._dispatch_now
            )

    def _dispatch_now(self) -> None:
        if self._window_handle is not None:
            self._window_handle.cancel()
            self._window_handle = None
        batch, self._pending = self._pending, []
        if not batch:
            return
        task = self._loop.create_task(self._dispatch(batch))
        self._dispatch_tasks.add(task)
        task.add_done_callback(self._dispatch_tasks.discard)

    async def _dispatch(self, batch: List[_PendingCheckout]) -> None:
        """Run one folded batch on a reader thread; settle per-vid futures.

        The batch holds one read claim per entry (taken at enqueue), so the
        whole enqueue→settle span sits inside the read side of the RW lock:
        a repack/fsck writer cannot rewrite the storage graph under a
        pending or running batch, whatever happened to the requesters."""
        now = self._loop.time()
        store = self.repo.store
        tr = get_tracer()
        bsp = tr.start("svc.batch", size=len(batch))
        self.metrics.inc("checkout.batches")
        self.metrics.inc("checkout.batched_refs", len(batch))
        for p in batch:
            self.metrics.observe("queue_wait", now - p.enqueued_at)
            if tr.enabled:
                # retroactive: the enqueue→dispatch interval, parented under
                # the request's own root span (exactly the queue_wait track)
                tr.add_event(
                    "svc.queue_wait", p.enqueued_at, now,
                    parent=p.span, vid=p.vid,
                )
        vids = [p.vid for p in batch]  # distinct by construction (coalescing)

        def run_batch():
            # warm-hit attribution just before the decode mutates cache
            # state — on the reader thread, because probe() hashes the whole
            # decode chain per vid (too much work for the event loop)
            # (attach: pool threads don't inherit the submitting context, so
            # materializer/delta spans need the batch span bridged across)
            with tr.attach(bsp or None):
                warm = sum(1 for v in vids if store.materializer.probe(v))
                return warm, store.checkout_many(vids)

        try:
            try:
                t0 = self._loop.time()
                warm, trees = await self._loop.run_in_executor(
                    self._reader_pool, run_batch
                )
                t1 = self._loop.time()
                self.metrics.observe("decode", t1 - t0)
                if tr.enabled:
                    # same interval the "decode" track just recorded
                    tr.add_event("svc.decode", t0, t1, parent=bsp,
                                 vids=len(vids), warm=warm)
                self.metrics.inc("checkout.warm_hits", warm)
                self.metrics.inc("checkout.warm_misses", len(vids) - warm)
                if bsp:
                    bsp.set(warm=warm)
                # the futures leave _inflight before the copies are made,
                # so the number of requests on each is final; a later
                # request for the vid starts a decode (a warm hit) of its own
                sharers = [self._retire(p) for p in batch]
                if any(n > 1 for n in sharers):
                    trees = await self._loop.run_in_executor(
                        self._reader_pool,
                        lambda: [_own_copies(t, n) for t, n in zip(trees, sharers)],
                    )
                else:
                    trees = [[t] for t in trees]
            except Exception as exc:
                for p in batch:
                    self._retire(p)
                    if not p.future.done():
                        p.future.set_exception(exc)
                        # consume: every waiter may have been cancelled, and
                        # an unretrieved future exception logs noise at GC
                        p.future.exception()
                return
            for p, own in zip(batch, trees):
                if not p.future.done():
                    p.future.set_result(own)
        finally:
            bsp.end()
            # shielded: the claims MUST drop even if this task is cancelled
            # mid-release, or a waiting writer hangs forever
            await asyncio.shield(self._rw.release_read(len(batch)))

    def _retire(self, p: _PendingCheckout) -> int:
        """Take ``p``'s future out of ``_inflight`` (if a later request has
        not replaced it already); returns the requests that share it."""
        if self._inflight.get(p.vid) is not p.future:
            return 1
        del self._inflight[p.vid]
        return self._sharers.pop(p.vid)

    # ---------------------------------------------------------------- write
    async def commit(
        self,
        tree: Any,
        *,
        message: str = "",
        parent: Union[Ref, Sequence[Ref], None] = None,
        branch: Optional[str] = None,
    ) -> int:
        """Commit a payload through the single-writer pool; returns its vid.

        Commits hold the read side of the RW lock — they may overlap with
        checkouts (append-only, and the append-aware cache keeps reader
        entries warm) but serialize among themselves on the one writer
        thread, and are excluded by an in-progress repack/fsck.
        """
        self._require_started()
        t0 = self._loop.time()
        self.metrics.inc("requests.commit")
        tr = get_tracer()
        sp = tr.start("svc.commit")

        def run_commit():
            with tr.attach(sp or None):  # bridge onto the writer thread
                return self.repo.commit(
                    tree, message=message, parent=parent, branch=branch
                )

        try:
            async with self._rw.read():
                vid = await self._loop.run_in_executor(
                    self._writer_pool, run_commit
                )
        except Exception:
            self.metrics.inc("errors.commit")
            if sp:
                sp.set(error=True)
            raise
        finally:
            sp.end()
        if sp:
            sp.set(vid=vid)
        self.metrics.observe("latency.commit", self._loop.time() - t0)
        return vid

    async def repack(
        self, spec: OptimizeSpec, **kwargs: Any
    ) -> Dict[str, Any]:
        """Re-optimize physical storage against ``spec`` (an
        :class:`~repro_torch.core.OptimizeSpec`; the port takes no solver
        name) under the exclusive write lock — every in-flight
        checkout/commit drains first, and the cache purge the rewrite
        triggers can never race a reader."""
        self._require_started()
        t0 = self._loop.time()
        self.metrics.inc("requests.repack")
        tr = get_tracer()
        sp = tr.start("svc.repack")

        def run_repack():
            with tr.attach(sp or None):  # store.repack nests under us
                return self.repo.repack(spec, **kwargs)

        try:
            async with self._rw.write():
                if tr.enabled:
                    # the drain window: write-lock wait while in-flight
                    # readers finish
                    tr.add_event(
                        "svc.quiesce", t0, self._loop.time(), parent=sp
                    )
                out = await self._loop.run_in_executor(
                    self._writer_pool, run_repack
                )
        finally:
            sp.end()
        self.metrics.observe("latency.repack", self._loop.time() - t0)
        return out

    # ---------------------------------------------------------------- reads
    async def log(self, ref: Optional[Ref] = None) -> List[Any]:
        """Ancestry of ``ref`` (resolved at dispatch), newest first."""
        self._require_started()
        self.metrics.inc("requests.log")
        with get_tracer().span("svc.log"):
            async with self._rw.read():
                return await self._loop.run_in_executor(
                    self._reader_pool, self.repo.log, ref
                )

    async def diff(self, a: Ref, b: Ref) -> TreeDiff:
        """Leaf-level diff of two refs, materialized on a reader thread."""
        self._require_started()
        self.metrics.inc("requests.diff")
        with get_tracer().span("svc.diff"):
            async with self._rw.read():
                return await self._loop.run_in_executor(
                    self._reader_pool, self.repo.diff, a, b
                )

    async def fsck(self):
        """One on-demand integrity sweep (same path, metrics and write-lock
        quiescing as the periodic background sweeper)."""
        self._require_started()
        from .sweeper import FsckSweeper

        return await FsckSweeper(
            self, interval_s=0.0, sample=self.fsck_sample
        ).sweep()

    # -------------------------------------------------------------- stats
    def stats(self) -> Dict[str, Any]:
        """Service metrics snapshot + the shared materializer/cache stats,
        plus the live tradeoff telemetry when a monitor is attached."""
        out = self.metrics.snapshot()
        out["store"] = self.repo.store.materializer.stats()
        mon = self._monitor or self.repo.store.tradeoff_monitor
        if mon is not None:
            out["tradeoff"] = mon.snapshot()
        if self.last_fsck is not None:
            out["fsck"] = {
                "findings": len(self.last_fsck.findings),
                "checked": sum(self.last_fsck.checked.values()),
            }
        return out
