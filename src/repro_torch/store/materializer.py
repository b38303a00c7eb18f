"""Materialization subsystem: planned, cached, batched checkouts.

Recreation cost Φ is paid at *checkout* time; this module pays it.  Every
checkout routes through a :class:`Materializer`, which composes three parts:

* :class:`CheckoutPlanner` — turns one or many requested version ids into an
  explicit :class:`CheckoutPlan` over the storage graph.  A batch is
  topologically ordered (bases before dependents) with shared chain prefixes
  deduplicated, so ``checkout_many([v1..vk])`` decodes each intermediate
  FlatTree exactly once while staying bit-identical to k independent
  checkouts.  The walk is bounded, so corrupted ``stored_base`` metadata
  raises instead of looping.

* :class:`MaterializationCache` — a byte-budgeted LRU of materialized
  FlatTrees keyed by vid, each entry tagged with the fingerprint it was
  decoded under.  Under the default **append-aware** discipline
  (``cache_invalidation="chain"``) the tag is the vid's own *decode-chain*
  fingerprint — a hash over just the ``(vid, stored_base, object_key)``
  triples along its storage chain — so a commit (which appends triples but
  rewrites none) leaves every warm entry valid.
  ``cache_invalidation="global"`` keeps one whole-graph fingerprint: any
  commit rotates it and the cache drops everything.  Either way a stale tree
  can never be served.  Cache lookups, inserts and evictions take an
  internal lock so reader threads can share one cache.

* :class:`Materializer` — executes plans against the :class:`ObjectStore`,
  feeding every decoded tree through the cache, and exposes hit/decode
  statistics.

Torch tensors carry no read-only flag, so where the JAX package freezes the
arrays it hands out, :meth:`Materializer.checkout_many` hands out storage
that nothing else holds: a leaf that the cache, or another result of the
same call, also holds goes out as a copy, and a leaf held by nothing else
goes out as it is (an uncached cold checkout pays no copy).  A caller may
write into any tree it was given.  Internal read-only callers (commit's
base, repack's measure, ``diff``) take :meth:`Materializer.checkout_shared`,
which copies nothing.

The cache budget is the ``cache_budget_bytes`` knob on
:class:`~repro_torch.store.version_store.VersionStore` (default 256 MiB; 0
disables caching but keeps within-batch prefix sharing).
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import threading
from typing import (
    TYPE_CHECKING,
    Any,
    Dict,
    Iterable,
    List,
    Optional,
    Sequence,
    Tuple,
)

from ..obs.tracer import span as _span
from .delta import (
    BlockedTree,
    FlatTree,
    apply_delta,
    apply_delta_chains,
    decode_full,
)

if TYPE_CHECKING:  # pragma: no cover - import cycle guard (store owns us)
    from .version_store import VersionStore


def tree_nbytes(flat: FlatTree) -> int:
    """Resident bytes of a materialized tree (what the cache budget counts).

    Charges every leaf in full even though unchanged leaves are shared by
    reference between chain-adjacent trees — the budget over-, not
    under-estimates resident memory, so eviction errs toward too early.
    """
    return sum(t.nbytes for t in flat.values())


def storage_fingerprint(versions: Dict[int, Any]) -> str:
    """Hash of the whole storage graph: every (vid, stored_base, object_key).

    Any commit or metadata edit changes at least one triple, so a cache keyed
    by this fingerprint can never serve a stale tree.
    """
    h = hashlib.sha256()
    for vid in sorted(versions):
        meta = versions[vid]
        h.update(
            f"{vid}:{meta.stored_base}:{meta.object_key};".encode()
        )
    return h.hexdigest()


# ------------------------------------------------------------------- planner
@dataclasses.dataclass(frozen=True)
class CheckoutStep:
    """One decode in a plan: full decode (base None) or delta apply."""

    vid: int
    base: Optional[int]
    object_key: str


@dataclasses.dataclass
class CheckoutPlan:
    """Topologically ordered decode schedule for a batch of checkouts.

    ``steps`` lists every decode needed, bases strictly before dependents,
    each vid at most once — shared chain prefixes across the batch appear a
    single time.  ``from_cache`` are vids (requested or chain bases) the
    planner found already materialized; they need no decoding at all.
    """

    requested: List[int]
    steps: List[CheckoutStep]
    from_cache: List[int]

    @property
    def decode_count(self) -> int:
        return len(self.steps)


class CheckoutPlanner:
    """Plans checkouts over the storage graph (a forest: ≤1 base per vid)."""

    def __init__(self, store: "VersionStore") -> None:
        self._store = store

    def plan(
        self, vids: Sequence[int], *, cached: Iterable[int] = ()
    ) -> CheckoutPlan:
        """Plan a batch checkout of ``vids``.

        ``cached`` names vids whose trees are already materialized; chains
        are walked only down to the nearest cached vid (or a full object).
        The walk is bounded by the version count, so a ``stored_base`` cycle
        in corrupted metadata raises ``RuntimeError`` instead of hanging.
        """
        versions = self._store.versions
        cached_set = set(cached)
        needed: Dict[int, CheckoutStep] = {}
        from_cache: List[int] = []
        order: List[int] = []  # needed vids, deepest-base-first per chain

        for vid in vids:
            if vid not in versions:
                raise KeyError(f"unknown version id {vid}")
            chain: List[int] = []
            v: Optional[int] = vid
            while v is not None and v not in needed and v not in cached_set:
                meta = versions[v]
                chain.append(v)
                v = meta.stored_base
                if len(chain) > len(versions):
                    raise RuntimeError("storage graph cycle")
            if v is not None and v in cached_set and v not in from_cache:
                from_cache.append(v)
            for v in reversed(chain):
                meta = versions[v]
                needed[v] = CheckoutStep(
                    vid=v, base=meta.stored_base, object_key=meta.object_key
                )
                order.append(v)

        return CheckoutPlan(
            requested=list(vids),
            steps=[needed[v] for v in order],
            from_cache=from_cache,
        )


# --------------------------------------------------------------------- cache
class MaterializationCache:
    """Byte-budgeted LRU of FlatTrees keyed by vid, fingerprint-validated.

    Every entry is tagged with the fingerprint it was decoded under; a
    lookup returns it only when the caller's fingerprint matches, so a stale
    tree can never be served.  The tag discipline belongs to the
    :class:`Materializer`:

    * *chain* (append-aware) — tags are per-vid decode-chain fingerprints;
      a mismatched entry is dropped individually (``invalidations`` counts
      them) while the rest of the cache stays warm.
    * *global* — tags are implicit: :meth:`ensure_fingerprint` adopts one
      whole-graph fingerprint at a time and the first operation under a new
      one drops every entry.

    Entries are evicted least-recently-used once resident bytes exceed
    ``budget_bytes``; a tree larger than the whole budget is simply not
    cached.  All access goes through one internal lock.
    """

    def __init__(self, budget_bytes: int) -> None:
        self.budget_bytes = int(budget_bytes)
        self._lock = threading.RLock()
        self._fp: Optional[str] = None
        self._entries: (
            "collections.OrderedDict[int, Tuple[FlatTree, int, Optional[str]]]"
        ) = collections.OrderedDict()
        self.current_bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0
        self.purges = 0

    # -- fingerprint handling ------------------------------------------------
    @property
    def epoch(self) -> Optional[str]:
        """The live whole-graph fingerprint (global discipline only)."""
        return self._fp

    def ensure_fingerprint(self, fp: str) -> None:
        """Adopt ``fp`` as the live storage graph, clearing stale entries."""
        with self._lock:
            if fp != self._fp:
                if self._entries:
                    self.invalidations += 1
                self._entries.clear()
                self.current_bytes = 0
                self._fp = fp

    def purge(self) -> None:
        """Drop every entry (repack rewrites chains wholesale; a full purge
        beats lazily discovering n stale tags one lookup at a time)."""
        with self._lock:
            if self._entries:
                self.purges += 1
            self._entries.clear()
            self.current_bytes = 0
            self._fp = None

    # -- lookup / insert -----------------------------------------------------
    def vids(self) -> List[int]:
        with self._lock:
            return list(self._entries.keys())

    def __contains__(self, vid: int) -> bool:
        with self._lock:
            return vid in self._entries

    def probe(self, vid: int, fp: Optional[str] = None) -> bool:
        """Non-counting validity check: is ``vid`` servable under ``fp``?"""
        with self._lock:
            ent = self._entries.get(vid)
            return ent is not None and ent[2] == fp

    def get(
        self, vid: int, fp: Optional[str] = None, *, count: bool = True
    ) -> Optional[FlatTree]:
        with self._lock:
            ent = self._entries.get(vid)
            if ent is not None and ent[2] != fp:
                # stale chain tag: this entry alone is dead, drop it
                self._entries.pop(vid)
                self.current_bytes -= ent[1]
                self.invalidations += 1
                ent = None
            if ent is None:
                if count:
                    self.misses += 1
                return None
            self._entries.move_to_end(vid)
            if count:
                self.hits += 1
            return ent[0]

    def put(
        self, vid: int, tree: FlatTree, fp: Optional[str] = None
    ) -> None:
        if self.budget_bytes <= 0:
            return
        nbytes = tree_nbytes(tree)
        if nbytes > self.budget_bytes:
            return
        with self._lock:
            if vid in self._entries:
                self.current_bytes -= self._entries.pop(vid)[1]
            self._entries[vid] = (tree, nbytes, fp)
            self.current_bytes += nbytes
            while self.current_bytes > self.budget_bytes:
                _, (_, old_bytes, _) = self._entries.popitem(last=False)
                self.current_bytes -= old_bytes
                self.evictions += 1

    def trees(self) -> List[FlatTree]:
        """Every resident tree, stale or not (what the cache holds)."""
        with self._lock:
            return [ent[0] for ent in self._entries.values()]

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
                "purges": self.purges,
                "entries": len(self._entries),
                "current_bytes": self.current_bytes,
                "budget_bytes": self.budget_bytes,
            }


# --------------------------------------------------------------- materializer
@dataclasses.dataclass(eq=False)
class _Segment:
    """A maximal run of delta steps fused into one chain application.

    ``base`` is the tree the run starts from (cached, full-decoded, or an
    earlier segment's terminal); ``steps`` are applied in chain order and
    only the terminal vid's tree is materialized host-side.
    """

    base: int
    steps: List[CheckoutStep]

    @property
    def terminal(self) -> int:
        return self.steps[-1].vid


class Materializer:
    """Executes checkout plans against the object store, through the cache.

    With ``fuse_chains`` (the default) delta chains run through the fused
    pipeline (:func:`repro_torch.store.delta.apply_delta_chains`):
    intermediate trees stay in blocked form on the store's device between
    steps, runs of steps through vids nobody else needs collapse into single
    fused launches, and same-shaped leaves across a batch's chains share
    kernel launches.  Segment *endpoints* — vids that must exist as host
    trees — are the requested vids, vids with multiple dependents in the
    plan, and (when the cache budget is positive) every vid, so caching
    semantics are unchanged: a warm cache sees exactly the trees it would
    have seen stepwise.  ``fuse_chains=False`` keeps the one-hop-at-a-time
    path; both are bit-identical.
    """

    def __init__(
        self,
        store: "VersionStore",
        *,
        budget_bytes: int,
        fuse_chains: bool = True,
        invalidation: str = "chain",
    ) -> None:
        if invalidation not in ("chain", "global"):
            raise ValueError(
                f"invalidation must be 'chain' or 'global', got {invalidation!r}"
            )
        self._store = store
        self.planner = CheckoutPlanner(store)
        self.cache = MaterializationCache(budget_bytes)
        self.fuse_chains = bool(fuse_chains)
        self.invalidation = invalidation
        # decode counters; guarded by _stats_lock (reader threads share one
        # Materializer)
        self._stats_lock = threading.Lock()
        self.full_decodes = 0
        self.delta_applies = 0
        self.fused_segments = 0
        self.fused_stats: Dict[str, int] = {}

    # -- fingerprint discipline ----------------------------------------------
    def _entry_fp(self, vid: int) -> Optional[str]:
        """The tag a cache entry for ``vid`` must carry to be servable."""
        if self.invalidation == "chain":
            return self._store.chain_fingerprint(vid)
        return None  # global mode: validity is the epoch, entries untagged

    def _cached_vids(self) -> List[int]:
        """Vids the planner may treat as materialized (global mode rotates
        the epoch first, purging on change).  The list is *optimistic* in
        chain mode: entries are validated lazily at lookup, and the execute
        paths rebuild anything that vanished between plan and execute."""
        if self.invalidation == "global":
            self.cache.ensure_fingerprint(self._store.storage_fingerprint())
        return self.cache.vids()

    def probe(self, vid: int) -> bool:
        """Non-counting warm check: would ``checkout(vid)`` be a cache hit?
        (The service tier's warm-hit attribution.)"""
        try:
            if self.invalidation == "global":
                return (
                    self.cache.epoch == self._store.storage_fingerprint()
                    and vid in self.cache
                )
            return self.cache.probe(vid, self._store.chain_fingerprint(vid))
        except (KeyError, RuntimeError):
            return False  # unknown vid / corrupted chain: not servable

    # -- public API ----------------------------------------------------------
    def checkout(self, vid: int) -> FlatTree:
        """Materialize one version (bit-identical to the raw chain walk)."""
        return self.checkout_many([vid])[0]

    def checkout_many(self, vids: Sequence[int]) -> List[FlatTree]:
        """Materialize a batch, decoding each shared chain prefix once.

        Returns one tree per requested vid, in request order, bit-identical
        to ``[checkout(v) for v in vids]``.  Each tree is the caller's own,
        to write into: a leaf that the cache or another result of this call
        also holds (a vid requested twice, a leaf two versions share) is
        copied; a leaf that only this result holds goes out as it is.
        """
        trees, out = self._checkout(vids)
        # a leaf's memory is named by its first byte: a leaf that another
        # tree holds is that tree's tensor itself (delta passes unchanged
        # leaves through by reference), never a part of one
        held_trees = self.cache.trees()
        # every tree this call decoded was offered to the cache, and another
        # reader may have taken one from it before it was evicted again
        if self.cache.budget_bytes > 0:
            held_trees += [t for t in trees.values()
                           if tree_nbytes(t) <= self.cache.budget_bytes]
        held = {t.data_ptr() for tree in held_trees for t in tree.values() if t.numel()}
        for tree in out:
            for key, t in tree.items():
                if not t.numel():
                    continue
                if t.data_ptr() in held:
                    tree[key] = t.clone()
                else:
                    held.add(t.data_ptr())
        return out

    def checkout_shared(self, vids: Sequence[int]) -> List[FlatTree]:
        """:meth:`checkout_many` without the copies, for read-only internal
        callers: the tensors may be the cache's and other results'."""
        return self._checkout(vids)[1]

    def _checkout(
        self, vids: Sequence[int]
    ) -> Tuple[Dict[int, FlatTree], List[FlatTree]]:
        """The plan's trees by vid, and a fresh dict per requested vid."""
        with _span("mat.checkout_many", vids=len(vids)) as msp:
            with _span("mat.plan") as psp:
                plan = self.planner.plan(vids, cached=self._cached_vids())
                if psp:
                    psp.set(
                        steps=plan.decode_count,
                        from_cache=len(plan.from_cache),
                    )
            trees = self._execute(plan)
            out: List[FlatTree] = []
            for vid in plan.requested:
                tree = trees.get(vid)
                if tree is None:
                    tree = self.cache.get(
                        vid, self._entry_fp(vid), count=False
                    )
                    if tree is not None:
                        trees[vid] = tree
                if tree is None:
                    # the planner saw this vid cached but its entry was
                    # evicted or its chain tag went stale between plan and
                    # execute: rebuild
                    tree = self._materialize_chain(vid, trees)
                out.append(dict(tree))
            if msp:
                planned = {s.vid for s in plan.steps}
                msp.set(
                    decode_steps=plan.decode_count,
                    cache_hits=sum(
                        1 for v in plan.requested if v not in planned
                    ),
                )
            return trees, out

    def prefetch(self, vids: Sequence[int]) -> int:
        """Warm the cache with ``vids`` (hottest first); returns trees cached.

        Used after ``repack(use_access_frequencies=True)``: the top-k most
        accessed versions go straight back into the cache so the first
        post-repack request for a hot version is already warm.
        """
        if self.cache.budget_bytes <= 0:
            return 0
        self._cached_vids()  # global mode: rotate the epoch before warming
        warmed = 0
        # reversed: LRU evicts oldest inserts first, so load coldest→hottest
        for vid in reversed(list(vids)):
            # validated lookup, not bare containment: a stale-tagged entry
            # must be dropped and re-warmed, not treated as present
            if self.cache.get(vid, self._entry_fp(vid), count=False) is not None:
                continue
            plan = self.planner.plan([vid], cached=self.cache.vids())
            self._execute(plan)
            warmed += 1
        return warmed

    def stats(self) -> Dict[str, int]:
        with self._stats_lock:
            return {
                **self.cache.stats(),
                "full_decodes": self.full_decodes,
                "delta_applies": self.delta_applies,
                "fused_segments": self.fused_segments,
                "fused_launches": self.fused_stats.get("launches", 0),
            }

    # -- plan execution ------------------------------------------------------
    def _execute(self, plan: CheckoutPlan) -> Dict[int, FlatTree]:
        """Run a plan's decode steps; returns every tree it materialized.

        Within the plan, intermediate trees live in a local dict so prefix
        sharing works even with a zero cache budget; everything decoded is
        also offered to the cache (budget permitting) for future requests.
        """
        if self.fuse_chains:
            trees = self._execute_fused(plan)
        else:
            trees = self._execute_stepwise(plan)
        planned = {s.vid for s in plan.steps}
        n_miss = sum(1 for vid in plan.requested if vid in planned)
        with self.cache._lock:
            self.cache.misses += n_miss
            self.cache.hits += len(plan.requested) - n_miss
        return trees

    def _load_cached(self, plan: CheckoutPlan) -> Dict[int, FlatTree]:
        trees: Dict[int, FlatTree] = {}
        for vid in plan.from_cache:
            tree = self.cache.get(vid, self._entry_fp(vid), count=False)
            if tree is not None:
                trees[vid] = tree
        return trees

    def _execute_stepwise(self, plan: CheckoutPlan) -> Dict[int, FlatTree]:
        """One-hop-at-a-time execution (``fuse_chains=False``)."""
        objects = self._store.objects
        device = self._store.device
        with _span("mat.execute_stepwise", steps=len(plan.steps)) as esp:
            trees = self._load_cached(plan)
            n_full = n_delta = 0
            for step in plan.steps:
                if step.base is None:
                    tree = decode_full(objects.get(step.object_key))
                    n_full += 1
                else:
                    base_tree = trees.get(step.base)
                    if base_tree is None:  # base evicted plan→execute
                        base_tree = self._materialize_chain(step.base, trees)
                    tree = apply_delta(
                        base_tree, objects.get(step.object_key), device=device
                    )
                    n_delta += 1
                trees[step.vid] = tree
                self.cache.put(step.vid, tree, self._entry_fp(step.vid))
            if esp:
                esp.set(full_decodes=n_full, delta_applies=n_delta)
        with self._stats_lock:
            self.full_decodes += n_full
            self.delta_applies += n_delta
        return trees

    def _execute_fused(self, plan: CheckoutPlan) -> Dict[int, FlatTree]:
        """Segment-fused execution through the fused delta pipeline.

        Delta steps are grouped into :class:`_Segment` runs ending at
        endpoints (requested vids, shared bases, every vid when caching);
        segments whose base tree is ready are batched into one
        :func:`apply_delta_chains` call per wave, so same-shaped leaves
        across independent chains share fused kernel launches.  Blocked
        device forms of segment terminals are memoized locally and fed back
        as ``base_blocked``, so a chain's intermediate trees never pay
        ``to_blocks`` twice; the kernels never write into them, so one memo
        can feed every segment that starts at a shared base.
        """
        objects = self._store.objects
        device = self._store.device
        with _span("mat.execute_fused", steps=len(plan.steps)) as esp:
            trees = self._load_cached(plan)
            blocked: Dict[int, BlockedTree] = {}
            n_full = n_delta = n_segments = 0
            wave_stats: Dict[str, int] = {}

            requested = set(plan.requested)
            dependents = collections.Counter(
                s.base for s in plan.steps if s.base is not None
            )
            caching = self.cache.budget_bytes > 0

            def endpoint(vid: int) -> bool:
                return caching or vid in requested or dependents[vid] > 1

            segments: List[_Segment] = []
            open_at: Dict[int, _Segment] = {}
            for step in plan.steps:
                if step.base is None:
                    tree = decode_full(objects.get(step.object_key))
                    n_full += 1
                    trees[step.vid] = tree
                    self.cache.put(step.vid, tree, self._entry_fp(step.vid))
                    continue
                seg = open_at.pop(step.base, None)
                if seg is None:
                    seg = _Segment(base=step.base, steps=[])
                seg.steps.append(step)
                if endpoint(step.vid):
                    segments.append(seg)
                else:
                    open_at[step.vid] = seg
            # a chain tail is always requested (hence an endpoint), but close
            # any stragglers defensively so no planned step is dropped
            segments.extend(open_at.values())

            pending = segments
            while pending:
                ready = [s for s in pending if s.base in trees]
                if not ready:
                    # base evicted between plan and execute: stepwise
                    # fallback rebuilds it (and anything under it), then the
                    # wave retries
                    self._materialize_chain(pending[0].base, trees)
                    continue
                done = {id(s) for s in ready}
                pending = [s for s in pending if id(s) not in done]
                requests = [
                    (
                        trees[s.base],
                        [objects.get(st.object_key) for st in s.steps],
                        blocked.get(s.base),
                    )
                    for s in ready
                ]
                # wave_stats is plan-local: apply_delta_chains mutates the
                # dict it is given, and self.fused_stats is shared across
                # threads
                results = apply_delta_chains(
                    requests, stats=wave_stats, device=device
                )
                for s, (tree, blk) in zip(ready, results):
                    trees[s.terminal] = tree
                    blocked[s.terminal] = blk
                    self.cache.put(
                        s.terminal, tree, self._entry_fp(s.terminal)
                    )
                    n_delta += len(s.steps)
                    n_segments += 1
            if esp:
                esp.set(
                    full_decodes=n_full,
                    delta_applies=n_delta,
                    fused_segments=n_segments,
                    fused_launches=wave_stats.get("launches", 0),
                )
        with self._stats_lock:
            self.full_decodes += n_full
            self.delta_applies += n_delta
            self.fused_segments += n_segments
            for k, v in wave_stats.items():
                self.fused_stats[k] = self.fused_stats.get(k, 0) + v
        return trees

    def _materialize_chain(
        self, vid: int, trees: Dict[int, FlatTree]
    ) -> FlatTree:
        """Fallback chain walk for a base missing from cache and plan."""
        plan = self.planner.plan([vid], cached=trees.keys())
        objects = self._store.objects
        n_full = n_delta = 0
        for step in plan.steps:
            if step.base is None:
                tree = decode_full(objects.get(step.object_key))
                n_full += 1
            else:
                tree = apply_delta(
                    trees[step.base],
                    objects.get(step.object_key),
                    device=self._store.device,
                )
                n_delta += 1
            trees[step.vid] = tree
            self.cache.put(step.vid, tree, self._entry_fp(step.vid))
        with self._stats_lock:
            self.full_decodes += n_full
            self.delta_applies += n_delta
        return trees[vid]
