"""Device solver backend: SSSP / Prim / Modified-Prim / LMG scoring on
PyTorch over the flat :class:`~repro_torch.core.edge_arrays.EdgeArrays`.

Every solver in this package takes ``backend="numpy"|"torch"``; this module
is the ``"torch"`` implementation, the port of the JAX package's
``jax_backend``.  It runs on ``device`` (default ``"cuda"``): on a card the
reductions launch the hand-written kernels of
:mod:`repro_torch.kernels.segment_ops`, on the CPU their plain PyTorch
versions, and nothing else decides the route.

* :func:`sssp` — whole-graph Bellman-Ford relaxation to fixpoint: each round
  gathers ``dist[src] + w`` over the padded in-edge rows and reduces with
  the segment-min kernel, accepting only >EPS improvements — the same slack
  the heap Dijkstra applies.  Parents are then extracted per vertex with the
  segment-argmin kernel as the in-edge minimizing ``(dist[u], u)`` among
  those attaining the final distance — the heap's pop-order tie-break.  One
  host sync per round (the fixpoint test).
* :func:`prim` — Prim over the undirected instance as ``n`` steps in one
  :func:`~repro_torch.kernels.segment_ops.prim_loop` launch: vertex
  selection is the (min, first argmin) of the masked key (first-min ==
  smallest id, the heap's ``(w, v)`` order), and each accepted vertex
  relaxes its padded out-row.
* :func:`modified_prim_core` — the MP loop (Algorithm 2), likewise one
  :func:`~repro_torch.kernels.segment_ops.mp_loop` launch, in-tree
  re-parenting (lines 10–17) included.  The rare unreached-version SPT
  splice stays host-side in :mod:`.mp` (shared with the NumPy path).
* :class:`LmgScorer` — the LMG per-round candidate scoring (ρ reduction +
  argmax) on device, one host sync per round; the splice bookkeeping stays
  host-side in :mod:`.lmg`.

JAX's out-of-bounds scatter with ``mode="drop"`` becomes a scatter into a
trash slot: every scattered loop array has ``nvp + 2`` entries and index
``nvp + 1`` is written but never read.  Boolean-mask indexing, which would
synchronise, is not used in the step loops.

Dtype regime: every device tensor is 32-bit in what it computes — costs
f32, ids int32 (gathers index with int64 copies of the ids) — and every f32
expression is the JAX package's, term for term, including the tolerance adds
(``theta + CONSTRAINT_TOL`` is an f32 add on the device).  The device
therefore performs *selection*, and every authoritative cost is recomputed
host-side in f64 from the selected structure.  Trees match the NumPy oracle
and the JAX package's ``backend="jax"``; instances engineered with cost gaps
below f32 resolution may legitimately pick a different tree of equal
f64-rounded quality.

Layout: CSR rows are padded to dense ``(rows, max_degree)`` matrices (+inf /
sentinel-id filled) so every reduction is a fixed-shape row op — the root's
out-row (degree ``n``) is handled separately before the main loops.  Shapes
are bucketed (rows to powers of two, widths to multiples of 8), as in the
JAX package, so both hand their reductions the same shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ...kernels import resolve_device
from ...kernels.segment_ops import (
    min_argmin_1d,
    mp_loop,
    prim_loop,
    segment_argmin_rows,
    segment_min_rows,
)
from ..edge_arrays import EdgeArrays
from . import CONSTRAINT_TOL, EPS, BackendUnsupported

Device = Union[str, torch.device]

# the padded layouts are dense (rows × max_degree): refuse instances whose
# degree skew would blow that up (a hub vertex that is delta-base for a
# large fraction of versions) instead of silently exhausting memory — the
# NumPy backend handles those in CSR form
MAX_PADDED_CELLS = 1 << 25


def _check_padded_size(nvp: int, width: int, what: str) -> None:
    if nvp * width > MAX_PADDED_CELLS:
        raise BackendUnsupported(
            f"backend='torch' padded {what} layout would need {nvp}x{width} "
            f"cells (> {MAX_PADDED_CELLS}): instance degree skew too high "
            f"for the dense row padding — use backend='numpy' (same trees)"
        )


def _bucket_rows(k: int) -> int:
    """Next power of two ≥ k (≥ 8)."""
    b = 8
    while b < k:
        b *= 2
    return b


def _bucket_width(k: int) -> int:
    """Row widths padded to multiples of 8."""
    return max(8, -(-k // 8) * 8)


# ------------------------------------------------------------- padded layouts
@dataclasses.dataclass(frozen=True)
class PaddedRows:
    """Dense padded view of CSR rows: ``ids[r, c]`` is the c-th neighbour of
    row r (sentinel ``nvp`` past the end), weights +inf-padded.  Host arrays,
    32-bit (f32 costs, i32 ids)."""

    nvp: int                 # bucketed row count (real rows are 0..nv-1)
    ids: np.ndarray          # int32 [nvp, D]
    w: np.ndarray            # float32 [nvp, D]
    w2: Optional[np.ndarray] = None  # second cost component, same layout


def padded_in_rows(ea: EdgeArrays, *, weight: str = "phi") -> PaddedRows:
    """In-edges per vertex (the SSSP relaxation layout): ``ids`` holds edge
    sources, ``w`` the chosen cost component."""
    nv = ea.n + 1
    nvp = _bucket_rows(nv)
    indeg = np.diff(ea.rrow_ptr[: nv + 1])
    d = _bucket_width(int(indeg.max()) if ea.m else 1)
    _check_padded_size(nvp, d, "in-edge")
    ids = np.full((nvp, d), nvp, dtype=np.int32)
    w = np.full((nvp, d), np.inf, dtype=np.float32)
    if ea.m:
        rows = np.repeat(np.arange(nv), indeg)
        cols = np.arange(ea.m) - ea.rrow_ptr[rows]
        wsrc = ea.phi if weight == "phi" else ea.delta
        ids[rows, cols] = ea.src[ea.rperm]
        w[rows, cols] = wsrc[ea.rperm]
    return PaddedRows(nvp=nvp, ids=ids, w=w)


def padded_out_rows(ea: EdgeArrays) -> Tuple[PaddedRows, np.ndarray, np.ndarray, np.ndarray]:
    """Out-edges per non-root vertex, plus the root's (degree-n) row dense:
    ``(rows, root_dst, root_delta, root_phi)`` — root arrays padded to nvp."""
    nv = ea.n + 1
    nvp = _bucket_rows(nv)
    outdeg = np.diff(ea.row_ptr[: nv + 1])
    d = _bucket_width(int(outdeg[1:].max()) if nv > 1 and outdeg[1:].size else 1)
    _check_padded_size(nvp, d, "out-edge")
    ids = np.full((nvp, d), nvp, dtype=np.int32)
    delta = np.full((nvp, d), np.inf, dtype=np.float32)
    phi = np.full((nvp, d), np.inf, dtype=np.float32)
    s1 = int(ea.row_ptr[1])
    m1 = ea.m - s1
    if m1:
        rows = np.repeat(np.arange(1, nv), outdeg[1:])
        cols = np.arange(s1, ea.m) - ea.row_ptr[rows]
        ids[rows, cols] = ea.dst[s1:]
        delta[rows, cols] = ea.delta[s1:]
        phi[rows, cols] = ea.phi[s1:]
    root_dst = np.full(nvp, nvp + 1, dtype=np.int32)  # nvp+1 => trash slot
    root_delta = np.full(nvp, np.inf, dtype=np.float32)
    root_phi = np.full(nvp, np.inf, dtype=np.float32)
    root_dst[:s1] = ea.dst[:s1]
    root_delta[:s1] = ea.delta[:s1]
    root_phi[:s1] = ea.phi[:s1]
    return (
        PaddedRows(nvp=nvp, ids=ids, w=delta, w2=phi),
        root_dst, root_delta, root_phi,
    )


def _f32(value: float, dev: torch.device) -> torch.Tensor:
    """A 0-d f32 tensor: ``value`` rounded to f32, as ``jnp.float32`` does."""
    return torch.tensor(value, dtype=torch.float32, device=dev)


# ------------------------------------------------------------------- (a) SSSP
def sssp(
    ea: EdgeArrays, *, weight: str = "phi", device: Device = "cuda"
) -> Tuple[np.ndarray, np.ndarray]:
    """Single-source shortest paths from the root — the device counterpart
    of :func:`repro_torch.core.solvers.spt.dijkstra_arrays`.  The parent tree
    matches the heap Dijkstra (same EPS tie semantics, f32 selection); the
    returned ``dist`` is the f32 fixpoint — callers wanting exact costs
    derive them from the tree (as
    :class:`~repro_torch.core.version_graph.StorageSolution` does)."""
    dev = resolve_device(device)
    rows = padded_in_rows(ea, weight=weight)
    nvp = rows.nvp
    ps = torch.from_numpy(rows.ids).to(dev)
    pw = torch.from_numpy(rows.w).to(dev)
    eps = _f32(EPS, dev)
    inf = torch.tensor(np.inf, dtype=torch.float32, device=dev)
    dist = torch.full((nvp + 1,), np.inf, dtype=torch.float32, device=dev)
    dist[0] = 0.0
    while True:
        cur = dist[:nvp]
        row = segment_min_rows(dist[ps] + pw)
        new = torch.where(row < cur - eps, row, cur)
        changed = (new < cur).any()
        dist[:nvp] = new
        if not bool(changed):  # the round's one host sync
            break
    # parent: among in-edges attaining dist[v], the min-(dist[u], u) source —
    # exactly the first entry the heap Dijkstra would have popped.  A row
    # lists its in-edges by ascending source id (EdgeArrays.rperm sorts by
    # (dst, src)), so the first column holding the row's least eligible
    # dist[u] is that source; a row with none (m1 = +inf) has no parent
    du = dist[ps]
    dv = dist[:nvp, None]
    elig = (du + pw == dv) & torch.isfinite(dv)
    key = torch.where(elig, du, inf)
    col = segment_argmin_rows(key)[:, None]
    m1 = key.gather(1, col)[:, 0]
    pu = ps.gather(1, col)[:, 0]
    parent = torch.where(torch.isfinite(dist[:nvp]) & torch.isfinite(m1), pu, -1)
    parent[0] = -1
    nv = ea.n + 1
    return dist[:nv].cpu().numpy(), parent[:nv].cpu().numpy()


# ------------------------------------------------------------------- (b) Prim
def prim_state(ea: EdgeArrays, dev: torch.device):
    """Prim's loop inputs on ``dev``: ``(pd, pw, best, bp, in_tree)``, the
    padded out-rows (int32 ids, f32 weights) and the state after the root's
    step (its whole out-row relaxed; its pop is always step 0)."""
    rows, root_dst, root_delta, _ = padded_out_rows(ea)
    nvp = rows.nvp
    pd = torch.from_numpy(rows.ids).to(dev)
    pw = torch.from_numpy(rows.w).to(dev)
    best = torch.full((nvp + 2,), np.inf, dtype=torch.float32, device=dev)
    bp = torch.full((nvp + 2,), -1, dtype=torch.int32, device=dev)
    in_tree = torch.zeros((nvp + 2,), dtype=torch.bool, device=dev)
    in_tree[0] = True
    ridx = torch.from_numpy(root_dst).to(dev)
    best[ridx] = torch.from_numpy(root_delta).to(dev)
    bp[ridx] = 0
    return pd, pw, best, bp, in_tree


def prim(ea: EdgeArrays, *, device: Device = "cuda") -> np.ndarray:
    """Prim over the undirected instance; returns the parent array (index 0
    and unreachable vertices hold ``-1``)."""
    dev = resolve_device(device)
    pd, pw, best, bp, in_tree = prim_state(ea, dev)
    prim_loop(pd, pw, best, bp, in_tree, ea.n)
    return bp[: ea.n + 1].cpu().numpy()


# -------------------------------------------------------- (c) Modified Prim
def mp_state(ea: EdgeArrays, theta: float, dev: torch.device):
    """The MP loop's inputs on ``dev``: ``(pd, pdelta, pphi, bound, l, d, p,
    in_tree)``, the padded out-rows, θ + CONSTRAINT_TOL and the state after
    the root's step (its out-row relaxed under θ)."""
    rows, root_dst, root_delta, root_phi = padded_out_rows(ea)
    nvp = rows.nvp
    pd = torch.from_numpy(rows.ids).to(dev)
    pdelta = torch.from_numpy(rows.w).to(dev)
    pphi = torch.from_numpy(rows.w2).to(dev)
    trash = torch.tensor(nvp + 1, dtype=torch.int32, device=dev)
    # θ + CONSTRAINT_TOL as the JAX package computes it: an f32 add of θ
    # rounded to f32 and the tolerance rounded to f32
    bound = _f32(theta, dev) + CONSTRAINT_TOL
    l = torch.full((nvp + 2,), np.inf, dtype=torch.float32, device=dev)
    d = torch.full((nvp + 2,), np.inf, dtype=torch.float32, device=dev)
    l[0] = 0.0
    d[0] = 0.0
    p = torch.full((nvp + 2,), -1, dtype=torch.int32, device=dev)
    in_tree = torch.zeros((nvp + 2,), dtype=torch.bool, device=dev)
    in_tree[0] = True
    rphi = torch.from_numpy(root_phi).to(dev)
    rdst = torch.from_numpy(root_dst).to(dev)
    ridx = torch.where(rphi <= bound, rdst, trash)
    d[ridx] = rphi
    l[ridx] = torch.from_numpy(root_delta).to(dev)
    p[ridx] = 0
    return pd, pdelta, pphi, bound, l, d, p, in_tree


def modified_prim_core(
    ea: EdgeArrays, theta: float, *, device: Device = "cuda"
) -> Tuple[np.ndarray, np.ndarray]:
    """The device MP main loop; returns ``(p, in_tree)`` host arrays.

    The f32 ``l``/``d`` loop state stays on the device — the caller
    (:mod:`.mp`) rebuilds both in f64 from the returned structure, and
    routes any vertex whose exact recreation cost overshoots θ (possible
    when a borderline acceptance rounds the other way in f32) through the
    SPT splice it already has for unreached versions."""
    dev = resolve_device(device)
    pd, pdelta, pphi, bound, l, d, p, in_tree = mp_state(ea, theta, dev)
    mp_loop(pd, pdelta, pphi, bound, l, d, p, in_tree, ea.n)
    nv = ea.n + 1
    # writable copies: the caller's SPT splice mutates these in place
    return (
        p[:nv].cpu().numpy().astype(np.intp),
        in_tree[:nv].cpu().numpy().copy(),
    )


# ------------------------------------------------------------ (d) LMG scoring
class LmgScorer:
    """Device-resident candidate set ξ; scores one LMG round per call.

    The candidate tensors are uploaded once (f32/i32); per-round tree state
    (d / mass / tin / size / current edge Δ) is shipped each call — the
    splice bookkeeping that mutates it stays host-side in :mod:`.lmg`.  The
    device output is a *selection*: the caller recomputes the chosen move's
    Δw/Δd/ρ in f64 and re-checks feasibility before committing (the returned
    ρ/Δw/Δd here are the f32 scores, advisory only).
    """

    def __init__(self, cu, cv, cand_delta, cand_phi, *, device: Device = "cuda"):
        self._dev = dev = resolve_device(device)
        self._nc = nc = cu.shape[0]
        self._ncp = ncp = _bucket_rows(max(1, nc))

        def pad(a, fill, dt):
            full = np.concatenate([a, np.full(ncp - nc, fill, dt)]).astype(dt)
            return torch.from_numpy(full).to(dev)

        self._cu = pad(cu, 0, np.int32)
        self._cv = pad(cv, 0, np.int32)
        self._cdelta = pad(cand_delta, 0.0, np.float32)
        self._cphi = pad(cand_phi, 0.0, np.float32)
        self._inf = torch.tensor(np.inf, dtype=torch.float32, device=dev)
        self._neg1 = torch.tensor(-1.0, dtype=torch.float32, device=dev)
        self._one = torch.tensor(1.0, dtype=torch.float32, device=dev)

    def score(self, active, cur_delta, d, mass, tin, size, w_total, budget):
        """Returns ``(i, rho_i, dw_i, dd_i, any_feasible)`` as host scalars;
        ``i`` indexes the un-padded candidate arrays; the floats are f32
        scores (selection only — recompute in f64 before mutating state)."""
        dev = self._dev
        full_active = np.zeros(self._ncp, bool)
        full_active[: self._nc] = active
        nvp = _bucket_rows(d.shape[0])

        def padv(a, dt):
            out = np.zeros(nvp, dt)
            out[: a.shape[0]] = a
            return torch.from_numpy(out).to(dev)

        ok = torch.from_numpy(full_active).to(dev)
        cur_delta, d, mass = (padv(a, np.float32) for a in (cur_delta, d, mass))
        tin, size = padv(tin, np.int32), padv(size, np.int32)
        cu, cv = self._cu, self._cv
        dw = self._cdelta - cur_delta[cv]
        ok = ok & (_f32(w_total, dev) + dw <= _f32(budget, dev) + CONSTRAINT_TOL)
        dd = (d[cu] + self._cphi) - d[cv]
        reduction = -dd * mass[cv]
        ok = ok & (reduction > 0)
        # cycle test: u inside subtree(v) ⇔ tin[v] ≤ tin[u] < tin[v]+size[v]
        ok = ok & ~((tin[cv] <= tin[cu]) & (tin[cu] < tin[cv] + size[cv]))
        pos = ok & (dw > 0)
        rho = torch.where(
            pos,
            reduction / torch.where(pos, dw, self._one),
            torch.where(ok & (dw <= 0), self._inf, self._neg1),
        )
        _, i = min_argmin_1d(-rho)
        i1 = i.view(1)
        # the f32 scores travel as their int32 bits beside i and the flag
        picked = torch.cat([
            i.view(1), rho[i1].view(torch.int32), dw[i1].view(torch.int32),
            dd[i1].view(torch.int32), ok.any().view(1).to(torch.int32),
        ]).cpu()  # the round's one host sync
        rho_i, dw_i, dd_i = picked[1:4].view(torch.float32).tolist()
        return int(picked[0]), rho_i, dw_i, dd_i, bool(picked[4])
