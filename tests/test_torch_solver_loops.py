"""The Prim and Modified-Prim step loops of the port, on the CPU.

* The plain versions of the two loop kernels (``prim_loop_ref``,
  ``mp_loop_ref``) against the JAX package's jitted loops (``_prim_jit``,
  ``_mp_jit``) on ``generate_flat`` graphs of a few hundred versions: the
  same padded rows, the same f32 state, bit for bit.
* The rule by which the CUDA ``mp_loop`` kernel re-parents a step's in-tree
  neighbours in parallel (every slot's cost tests against the state at the
  step's start, the selected vertex's parent chain walked once, the
  candidates on it rejected), emulated here in numpy, against the
  sequential ``mp_reparent_ref`` on MP states drawn from runs of the loop:
  bit for bit.
* The rule's precondition: every padded out-row lists distinct real ids.
"""

import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core.solvers import jax_backend

from repro_torch.core.edge_arrays import EdgeArrays
from repro_torch.core.solvers import torch_backend
from repro_torch.kernels import ref as tref
from repro_torch.kernels import segment_ops as tseg

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # the seeded loop below stands in
    given = None

THETA_MULTS = (1.05, 1.5, 3.0)


def _flat(n: int, seed: int, directed: bool):
    """A DC-like ``generate_flat`` graph (the solver-scale sweep's shape)."""
    return jcore.generate_flat(jcore.WorkloadSpec(
        commits=n, branch_interval=3, branch_prob=0.7, branch_limit=4,
        branch_length=4, reveal_hops=3, seed=seed, directed=directed,
    )).graph


def _port_arrays(g) -> EdgeArrays:
    ea = g.arrays()
    return EdgeArrays.from_edges(g.n, ea.src, ea.dst, ea.delta, ea.phi)


def _theta(g, mult: float) -> float:
    return jcore.shortest_path_tree(g, backend="numpy").max_recreation() * mult


# ------------------------------------------- (a) the plain loops against JAX
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prim_loop_ref_matches_jax(seed):
    g = _flat(250 + 50 * seed, seed, directed=False)
    ea = _port_arrays(g)
    pd, pw, best, bp, in_tree = torch_backend.prim_state(ea, torch.device("cpu"))
    tref.prim_loop_ref(pd, pw, best, bp, in_tree, ea.n)
    want = jax_backend.prim(g.arrays())
    np.testing.assert_array_equal(bp[: ea.n + 1].numpy(), want)
    assert (want[1:] >= 0).all()  # every version reached: the loop ran its steps
    # the wrapper takes the plain version for CPU tensors, step for step
    again = torch_backend.prim_state(ea, torch.device("cpu"))
    tseg.prim_loop(*again, ea.n)
    assert tseg.prim_loop.launches == 0
    for got, exp in zip(again[2:], (best, bp, in_tree)):
        assert torch.equal(got, exp)


@pytest.mark.parametrize("mult", THETA_MULTS)
@pytest.mark.parametrize("directed", [True, False])
def test_mp_loop_ref_matches_jax(directed, mult):
    g = _flat(300, 7 if directed else 8, directed)
    theta = _theta(g, mult)
    ea = _port_arrays(g)
    pd, pdelta, pphi, bound, l, d, p, in_tree = torch_backend.mp_state(
        ea, theta, torch.device("cpu"))
    tref.mp_loop_ref(pd, pdelta, pphi, bound, l, d, p, in_tree, ea.n)
    rows, root_dst, root_delta, root_phi = jax_backend.padded_out_rows(g.arrays())
    want = jax_backend._mp_jit(
        *(np.asarray(a) for a in (rows.ids, rows.w, rows.w2, root_dst, root_delta,
                                  root_phi)),
        np.int32(ea.n), np.float32(theta), False)
    nvp = rows.nvp
    for name, got, exp in zip("l d p in_tree".split(), (l, d, p, in_tree), want):
        np.testing.assert_array_equal(got[:nvp].numpy(), np.asarray(exp), err_msg=name)
    assert int(in_tree[1: ea.n + 1].sum()) > ea.n // 2  # the loop ran its steps


# ----------------------------------- (b) the kernel's parallel re-parenting
def _parallel_reparent(pd, pdelta, pphi, vi, in_tree, l, d, p):
    """The CUDA kernel's rule, in numpy f32, in place on l / d / p.  Returns
    (accepted, rejected on the chain)."""
    nvp = pd.shape[0]
    eps = np.float32(tref.EPS)
    dvi = d[vi]
    cand = []
    for k, vj in enumerate(pd[vi]):
        if vj >= nvp or not (vj == vi or in_tree[vj]):
            continue
        dn = pphi[vi, k] + dvi
        if dn <= d[vj] + eps and pdelta[vi, k] <= l[vj] - eps:
            cand.append((vj, dn, pdelta[vi, k]))
    chain, x = set(), vi
    while cand:
        chain.add(x)
        if x <= 0:
            break
        x = max(int(p[x]), 0)
    accepted = [(vj, dn, cdel) for vj, dn, cdel in cand if vj not in chain]
    for vj, dn, cdel in accepted:
        p[vj], d[vj], l[vj] = vi, dn, cdel
    return len(accepted), len(cand) - len(accepted)


_GRAPHS = {}


def _mp_graph(idx: int):
    """Small undirected graphs (a parent is in its child's row, so chain
    rejections happen), with their loop inputs; built once per process."""
    if idx not in _GRAPHS:
        g = _flat(120 + 40 * idx, 20 + idx, directed=False)
        ea = _port_arrays(g)
        _GRAPHS[idx] = (ea, torch_backend.mp_state(ea, _theta(g, 2.0), torch.device("cpu")))
    return _GRAPHS[idx]


def _check_rule(graph: int, frac: float, seed: int):
    """Run the loop part way, then put one step's re-parenting through both
    rules, from the selected vertex and from a random tree vertex, on a state
    whose in-tree l / d are raised at random so that many slots pass the
    cost tests."""
    ea, state = _mp_graph(graph)
    pd, pdelta, pphi, bound, l, d, p, in_tree = (t.clone() for t in state)
    tref.mp_loop_ref(pd, pdelta, pphi, bound, l, d, p, in_tree, int(frac * ea.n))
    nvp = pd.shape[0]
    rng = np.random.RandomState(seed)
    up = torch.from_numpy(rng.choice([1.0, 1.0, 1.5, 4.0], nvp + 2).astype(np.float32))
    tree = in_tree.clone()
    tree[0] = False
    l = torch.where(tree, l * up, l)
    d = torch.where(tree, d * torch.from_numpy(rng.choice([1.0, 2.0], nvp + 2).astype(np.float32)), d)
    key = torch.where(in_tree[:nvp], torch.inf, l[:nvp])
    picks = [int(torch.argmin(key))] if torch.isfinite(key.min()) else []
    members = torch.nonzero(tree[:nvp]).flatten().numpy()
    if members.size:
        picks.append(int(rng.choice(members)))
    counts = np.zeros(2, int)
    for vi in picks:
        it = in_tree.clone()
        it[vi] = True
        want = [t.clone() for t in (l, d, p)]
        tref.mp_reparent_ref(pd, pdelta, pphi, torch.tensor(vi, dtype=torch.int32),
                             torch.tensor(True), it, *want)
        got = [t.numpy().copy() for t in (l, d, p)]
        counts += _parallel_reparent(pd.numpy(), pdelta.numpy(), pphi.numpy(), vi,
                                     it.numpy(), *got)
        for name, g_, w in zip("ldp", got, want):
            np.testing.assert_array_equal(g_, w.numpy(), err_msg=f"{name}, vi {vi}")
    return counts


if given is not None:
    @settings(max_examples=40, deadline=None, database=None, derandomize=True)
    @given(st.integers(0, 2), st.floats(0.0, 0.99), st.integers(0, 2**31 - 1))
    def test_parallel_reparent_rule(graph, frac, seed):
        _check_rule(graph, frac, seed)
else:
    @pytest.mark.parametrize("case", range(40))
    def test_parallel_reparent_rule(case):
        rng = np.random.RandomState(case)
        _check_rule(case % 3, float(rng.uniform(0, 0.99)), case)


def test_parallel_reparent_rule_is_exercised():
    """The states above accept candidates and reject some on the chain."""
    counts = sum(_check_rule(graph, frac, seed) for graph in range(3)
                 for seed, frac in enumerate((0.2, 0.5, 0.8)))
    assert counts[0] > 0 and counts[1] > 0, counts


# -------------------------------------------- (c) the rule's precondition
@pytest.mark.parametrize("directed", [True, False])
def test_padded_out_rows_hold_distinct_ids(directed):
    graphs = [_flat(400, s, directed) for s in range(3)]
    g = jcore.VersionGraph(6, directed=directed)  # a row with one slot per id
    for i in g.versions():
        g.set_materialization(i, 100.0 + i, 50.0 + i)
    for a, b in ((1, 2), (1, 3), (1, 2), (2, 3), (3, 1)):  # (1, 2) set twice
        g.set_delta(a, b, 5.0 + a, 4.0 + b)
    for g in graphs + [g]:
        rows, *_ = torch_backend.padded_out_rows(_port_arrays(g))
        for row in rows.ids:
            real = row[row != rows.nvp]
            assert np.unique(real).size == real.size
            assert ((real >= 0) & (real < rows.nvp)).all()


def test_loop_wrappers_check_their_arguments():
    pd, pw, best, bp, in_tree = torch_backend.prim_state(
        _port_arrays(_flat(20, 3, False)), torch.device("cpu"))
    with pytest.raises(ValueError, match="int32"):
        tseg.prim_loop(pd.long(), pw, best, bp, in_tree, 3)
    with pytest.raises(ValueError, match="nvp \\+ 2"):
        tseg.prim_loop(pd, pw, best[:-1], bp, in_tree, 3)
    with pytest.raises(ValueError, match="steps"):
        tseg.prim_loop(pd, pw, best, bp, in_tree, -1)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        tseg.prim_loop(pd, pw, best.to("meta"), bp, in_tree, 3)
    assert tseg.loop_chunk(1 << 17) == 256
    assert tseg.loop_chunk(1 << 22) == 2048  # the most rows the layouts admit
    assert -(-(1 << 22) // tseg.loop_chunk(1 << 22)) <= tseg.MAX_LOOP_CHUNKS
