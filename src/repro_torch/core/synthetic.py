"""Synthetic dataset-versioning workload generator (paper §5.1).

Two-step approach, exactly as the paper describes:

1. generate a *version graph* with the desired shape, controlled by
   ``commits``, ``branch_interval``, ``branch_prob``, ``branch_limit``,
   ``branch_length`` (merges close a fraction of branches back to trunk);
2. generate versions' *contents* and derive Δ/Φ from them.

Contents are modelled as sets of content blocks (block id → size).  Each
commit applies edit commands to its parent — add / delete / modify blocks —
mirroring the paper's six CSV edit instructions at block granularity.  Deltas
are then *measured* from the block sets:

* directed Δ_ij  = Σ size(blocks in j \\ i) + per-edit overhead
  (what must be stored to turn V_i into V_j);
* undirected Δ_ij = Σ size(sym-diff) + overhead — a metric, so the paper's
  §3 triangle inequalities hold by construction;
* Φ = Δ · io_factor for the proportional scenarios, or Δ · per-edge random
  compute factor for Scenario 3 (Φ ≠ Δ, e.g. compressed deltas).

Presets `dc_like` / `lc_like` reproduce the flat/linear shapes of the paper's
DC and LC datasets (at configurable scale); deltas are revealed within a
``reveal_hops`` BFS radius of the version graph, like the paper's 10/25-hop
matrices.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from .version_graph import VersionGraph


@dataclasses.dataclass
class WorkloadSpec:
    commits: int = 200
    branch_interval: int = 5
    branch_prob: float = 0.4
    branch_limit: int = 3
    branch_length: int = 8
    merge_prob: float = 0.3
    # content model
    init_blocks: int = 400
    block_size_mean: float = 2048.0
    edit_rate: float = 0.05          # fraction of blocks touched per commit
    grow_rate: float = 0.01          # net growth per commit
    edit_overhead: float = 64.0      # bytes of bookkeeping per stored delta
    # cost model
    io_factor: float = 1.0           # Φ = io_factor·Δ when proportional
    phi_independent: bool = False    # Scenario 3: Φ ≠ Δ
    compute_factor_range: Tuple[float, float] = (0.2, 5.0)
    reveal_hops: int = 10
    directed: bool = True
    seed: int = 0


def dc_like(n: int = 200, seed: int = 0, **kw) -> WorkloadSpec:
    """Densely-connected: frequent short branches (paper's DC shape)."""
    return WorkloadSpec(
        commits=n, branch_interval=3, branch_prob=0.7, branch_limit=4,
        branch_length=4, reveal_hops=10, seed=seed, **kw,
    )


def lc_like(n: int = 200, seed: int = 0, **kw) -> WorkloadSpec:
    """Linear-chain: rare, long branches (paper's LC shape)."""
    return WorkloadSpec(
        commits=n, branch_interval=25, branch_prob=0.2, branch_limit=1,
        branch_length=40, reveal_hops=25, seed=seed, **kw,
    )


@dataclasses.dataclass
class SyntheticWorkload:
    graph: VersionGraph
    version_dag: Dict[int, List[int]]      # derivation edges (parents per version)
    sizes: Dict[int, float]                # full size of each version
    blocks: Optional[Dict[int, Dict[int, float]]] = None


def _build_dag(spec: WorkloadSpec, rng: random.Random) -> Dict[int, List[int]]:
    """Step 1: the version DAG — trunk + branches (+ occasional merges)."""
    parents: Dict[int, List[int]] = {1: []}
    trunk = [1]
    open_branches: List[List[int]] = []
    next_id = 2
    while next_id <= spec.commits:
        # advance trunk
        v = next_id
        next_id += 1
        parents[v] = [trunk[-1]]
        trunk.append(v)
        # maybe branch off
        if len(trunk) % spec.branch_interval == 0 and rng.random() < spec.branch_prob:
            n_branches = rng.randint(1, spec.branch_limit)
            for _ in range(n_branches):
                if next_id > spec.commits:
                    break
                length = rng.randint(1, spec.branch_length)
                prev = trunk[-1]
                branch = []
                for _ in range(length):
                    if next_id > spec.commits:
                        break
                    b = next_id
                    next_id += 1
                    parents[b] = [prev]
                    branch.append(b)
                    prev = b
                if branch:
                    open_branches.append(branch)
        # maybe merge a finished branch into trunk
        if open_branches and rng.random() < spec.merge_prob and next_id <= spec.commits:
            branch = open_branches.pop(rng.randrange(len(open_branches)))
            m = next_id
            next_id += 1
            parents[m] = [trunk[-1], branch[-1]]
            trunk.append(m)
    return parents


def generate(spec: WorkloadSpec) -> SyntheticWorkload:
    rng = random.Random(spec.seed)

    parents = _build_dag(spec, rng)
    n = len(parents)

    # ---------------------------------------------------------------- step 2
    # contents: block sets evolved by edit commands
    blocks: Dict[int, Dict[int, float]] = {}
    block_id = [0]

    def new_block() -> Tuple[int, float]:
        block_id[0] += 1
        size = max(64.0, rng.gauss(spec.block_size_mean, spec.block_size_mean / 4))
        return block_id[0], size

    for v in sorted(parents):
        ps = parents[v]
        if not ps:
            blk = dict(new_block() for _ in range(spec.init_blocks))
        else:
            base = dict(blocks[ps[0]])
            if len(ps) > 1:  # merge: union of parents
                for b, s in blocks[ps[1]].items():
                    base.setdefault(b, s)
            n_edit = max(1, int(len(base) * spec.edit_rate))
            ids = list(base)
            # modify: delete + re-add as new ids
            for b in rng.sample(ids, min(n_edit, len(ids))):
                del base[b]
                nb, s = new_block()
                base[nb] = s
            # net growth: linear in the base size (compounding on the current
            # size explodes exponentially over long histories)
            for _ in range(max(0, int(spec.init_blocks * spec.grow_rate))):
                nb, s = new_block()
                base[nb] = s
            blk = base
        blocks[v] = blk

    sizes = {v: sum(blk.values()) for v, blk in blocks.items()}

    # ------------------------------------------------------------- reveal Δ/Φ
    g = VersionGraph(n, directed=spec.directed)

    def phi_of(delta: float) -> float:
        if spec.phi_independent:
            lo, hi = spec.compute_factor_range
            return delta * rng.uniform(lo, hi)
        return delta * spec.io_factor

    for v in g.versions():
        g.set_materialization(v, sizes[v], phi_of(sizes[v]))

    # BFS within reveal_hops over the *undirected* version DAG
    adj: Dict[int, Set[int]] = {v: set() for v in parents}
    for v, ps in parents.items():
        for p in ps:
            adj[v].add(p)
            adj[p].add(v)

    revealed = set()
    for src in g.versions():
        frontier = {src}
        seen = {src}
        for _ in range(spec.reveal_hops):
            frontier = {y for x in frontier for y in adj[x]} - seen
            seen |= frontier
            if not frontier:
                break
        for dst in seen - {src}:
            key = (src, dst) if spec.directed else (min(src, dst), max(src, dst))
            if key in revealed:
                continue
            revealed.add(key)
            a, b = blocks[src], blocks[dst]
            fwd = sum(s for bid, s in b.items() if bid not in a)
            if spec.directed:
                d = fwd + spec.edit_overhead
                g.set_delta(src, dst, d, phi_of(d))
                bwd = sum(s for bid, s in a.items() if bid not in b) + spec.edit_overhead
                if (dst, src) not in revealed:
                    revealed.add((dst, src))
                    g.set_delta(dst, src, bwd, phi_of(bwd))
            else:
                bwd = sum(s for bid, s in a.items() if bid not in b)
                d = fwd + bwd + spec.edit_overhead
                g.set_delta(src, dst, d, phi_of(d))

    dag = {v: list(ps) for v, ps in parents.items()}
    return SyntheticWorkload(graph=g, version_dag=dag, sizes=sizes, blocks=blocks)


def generate_flat(spec: WorkloadSpec) -> SyntheticWorkload:
    """Array-native workload generator for 500k–1M-version instances.

    Same two-step shape as :func:`generate` — identical version-DAG construction,
    then Δ/Φ revealed within a ``reveal_hops`` ball — but the content model
    is scalar instead of per-block: each commit carries an *added* and a
    *deleted* byte volume relative to its first parent, and a delta between
    two versions accumulates those volumes along the DAG path between them
    (down-steps contribute the child's additions, up-steps the departed
    version's deletions).  That keeps the path-metric structure (undirected
    deltas satisfy the §3 triangle inequalities by construction) while
    skipping the per-version block dictionaries that make :func:`generate`
    infeasible beyond a few thousand commits.

    The reveal ball itself is computed as an *all-sources* vectorized hop
    expansion over a CSR adjacency of the DAG: each hop expands the whole
    ``(src, node)`` frontier with ``np.repeat`` gathers and dedups first
    reaches by ``src·(n+1)+node`` key against a sorted seen-array — no
    per-source Python BFS, no per-edge Python objects.  First-reach
    tie-breaks and float accumulation order match the scalar reference
    semantics exactly (the JAX package's tests pin its copy of this code
    against a naive per-source BFS, and the port's tests hold this copy to
    the JAX package's graphs), so instances are byte-identical to what the
    old Python loop produced.

    Edges are bulk-loaded straight into the flat
    :class:`~repro_torch.core.edge_arrays.EdgeArrays` representation, so
    solver-scale sweeps reach 1M-version graphs.  ``blocks``
    is ``None`` in the returned workload.
    """
    rng = random.Random(spec.seed)
    parents = _build_dag(spec, rng)
    n = len(parents)

    # scalar content model: per-commit added/deleted volumes and full sizes
    nrng = np.random.default_rng(spec.seed)
    base_size = spec.init_blocks * spec.block_size_mean
    n_edit = max(1, int(spec.init_blocks * spec.edit_rate))
    n_grow = max(0, int(spec.init_blocks * spec.grow_rate))
    noise = spec.block_size_mean / 4
    # modify = delete + re-add (both sides of the diff); growth adds only
    mod_vol = np.maximum(
        64.0, nrng.normal(spec.block_size_mean, noise, size=n + 1)
    ) * n_edit
    grow_vol = np.maximum(
        64.0, nrng.normal(spec.block_size_mean, noise, size=n + 1)
    ) * n_grow
    added = np.zeros(n + 1)
    deleted = np.zeros(n + 1)
    sizes_arr = np.zeros(n + 1)
    sizes_arr[1] = base_size
    for v in range(2, n + 1):
        p0 = parents[v][0]
        added[v] = mod_vol[v] + grow_vol[v]
        deleted[v] = mod_vol[v]
        sizes_arr[v] = sizes_arr[p0] + grow_vol[v]

    def phi_of(delta: np.ndarray) -> np.ndarray:
        if spec.phi_independent:
            lo, hi = spec.compute_factor_range
            return delta * nrng.uniform(lo, hi, size=delta.shape)
        return delta * spec.io_factor

    g = VersionGraph(n, directed=spec.directed)
    vs = np.arange(1, n + 1, dtype=np.int64)
    g.add_edges_bulk(
        np.zeros(n, dtype=np.int64), vs, sizes_arr[1:], phi_of(sizes_arr[1:])
    )

    # reveal within reveal_hops over the *undirected* version DAG, carrying
    # the (fwd, bwd) accumulated volumes per reached (src, node) pair; all
    # sources expand together, one vectorized hop at a time
    src_a, dst_a, fwd_a, bwd_a = _reveal_ball_arrays(
        parents, added, deleted, n, spec.reveal_hops, spec.directed
    )
    if spec.directed:
        d_fwd = fwd_a + spec.edit_overhead
        d_bwd = bwd_a + spec.edit_overhead
        g.add_edges_bulk(src_a, dst_a, d_fwd, phi_of(d_fwd))
        g.add_edges_bulk(dst_a, src_a, d_bwd, phi_of(d_bwd))
    else:
        d_sym = fwd_a + bwd_a + spec.edit_overhead
        g.add_edges_bulk(src_a, dst_a, d_sym, phi_of(d_sym), mirror=True)

    dag = {v: list(ps) for v, ps in parents.items()}
    sizes = {v: float(sizes_arr[v]) for v in range(1, n + 1)}
    return SyntheticWorkload(graph=g, version_dag=dag, sizes=sizes, blocks=None)


def _reveal_ball_arrays(
    parents: Dict[int, List[int]],
    added: np.ndarray,
    deleted: np.ndarray,
    n: int,
    reveal_hops: int,
    directed: bool,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """All-sources vectorized reveal-ball expansion; see :func:`generate_flat`.

    Returns ``(src, dst, fwd, bwd)`` arrays of every first-reach within
    ``reveal_hops`` (undirected specs keep only ``src < dst``), in the exact
    order the per-source Python BFS used to append them (source-major, hops
    ascending within a source) — downstream Φ draws consume the arrays in
    that order, so instance bytes are unchanged.

    Semantics pinned to the reference BFS: within a hop, a node reached by
    several frontier entries keeps the *first* in (frontier-position,
    adjacency-order); its accumulated volumes are ``parent's + step's``, one
    float add per hop, so values are bit-equal to the sequential loop.
    """
    # flatten the undirected adjacency, preserving the reference insertion
    # order (the v-ascending parents iteration) for tie-break parity
    a_node: List[int] = []
    a_nbr: List[int] = []
    a_fwd: List[float] = []
    a_bwd: List[float] = []
    for v, ps in parents.items():
        av = float(added[v])
        dv = float(deleted[v])
        for p in ps:
            # step p→v descends to v ; step v→p ascends out of v
            a_node.append(p)
            a_nbr.append(v)
            a_fwd.append(av)
            a_bwd.append(dv)
            a_node.append(v)
            a_nbr.append(p)
            a_fwd.append(dv)
            a_bwd.append(av)
    node_arr = np.asarray(a_node, dtype=np.int64)
    adj_order = np.argsort(node_arr, kind="stable")
    adj_nbr = np.asarray(a_nbr, dtype=np.int64)[adj_order]
    adj_fwd = np.asarray(a_fwd, dtype=np.float64)[adj_order]
    adj_bwd = np.asarray(a_bwd, dtype=np.float64)[adj_order]
    adj_ptr = np.searchsorted(
        node_arr[adj_order], np.arange(n + 2, dtype=np.int64)
    )

    stride = np.int64(n + 1)  # (src, node) -> scalar dedup key
    fsrc = np.arange(1, n + 1, dtype=np.int64)
    fnode = fsrc.copy()
    ffwd = np.zeros(n, dtype=np.float64)
    fbwd = np.zeros(n, dtype=np.float64)
    seen = np.sort(fsrc * stride + fnode)

    chunks: List[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]] = []
    for _ in range(reveal_hops):
        deg = adj_ptr[fnode + 1] - adj_ptr[fnode]
        total = int(deg.sum())
        if total == 0:
            break
        rep = np.repeat(np.arange(fnode.shape[0], dtype=np.int64), deg)
        base = np.concatenate(
            ([0], np.cumsum(deg[:-1]))
        ) if deg.shape[0] else np.zeros(0, dtype=np.int64)
        eidx = adj_ptr[fnode][rep] + (np.arange(total, dtype=np.int64) - base[rep])
        cand_src = fsrc[rep]
        cand_node = adj_nbr[eidx]
        key = cand_src * stride + cand_node
        # first reaches only: not seen in earlier hops, first in-batch winner
        pos = np.minimum(np.searchsorted(seen, key), seen.shape[0] - 1)
        fresh = np.nonzero(seen[pos] != key)[0]
        uniq_keys, first = np.unique(key[fresh], return_index=True)
        sel = fresh[np.sort(first)]
        if sel.shape[0] == 0:
            break
        fsrc = cand_src[sel]
        fnode = cand_node[sel]
        ffwd = ffwd[rep[sel]] + adj_fwd[eidx[sel]]
        fbwd = fbwd[rep[sel]] + adj_bwd[eidx[sel]]
        seen = np.sort(np.concatenate([seen, uniq_keys]))
        if directed:
            chunks.append((fsrc, fnode, ffwd, fbwd))
        else:
            m = fsrc < fnode  # undirected pairs revealed once
            chunks.append((fsrc[m], fnode[m], ffwd[m], fbwd[m]))

    if not chunks:
        z = np.zeros(0, dtype=np.int64)
        return z, z.copy(), np.zeros(0), np.zeros(0)
    src_a = np.concatenate([c[0] for c in chunks])
    dst_a = np.concatenate([c[1] for c in chunks])
    fwd_a = np.concatenate([c[2] for c in chunks])
    bwd_a = np.concatenate([c[3] for c in chunks])
    # hop-major -> source-major, preserving per-source hop order (the exact
    # append order of the reference BFS, which the Φ RNG stream depends on)
    out = np.argsort(src_a, kind="stable")
    return src_a[out], dst_a[out], fwd_a[out], bwd_a[out]


def zipf_weights(n: int, exponent: float = 2.0, seed: int = 0) -> Dict[int, float]:
    """Zipfian access frequencies over versions (paper Fig. 16 workload)."""
    rng = random.Random(seed)
    ranks = list(range(1, n + 1))
    rng.shuffle(ranks)
    raw = [1.0 / (r ** exponent) for r in ranks]
    z = sum(raw)
    return {i + 1: raw[i] / z for i in range(n)}
