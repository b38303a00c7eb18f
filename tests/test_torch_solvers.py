"""The port's solvers and segment kernels against the JAX package's.

The same instances and inputs (numpy, from seeds) go through the JAX
package — its ``backend="jax"`` solvers on the CPU, and its Pallas segment
kernels in interpret mode — and through the port's ``backend="torch"`` with
``device="cpu"``, where every kernel wrapper takes its plain PyTorch
version.  Trees, f64 costs and reduction results must be equal exactly:
both sides compute the same f32 selection, term for term.

The instances are the 56-instance suite of ``test_array_refactor`` (four
synthetic families and dense random graphs, directed and undirected) plus
the corner cases of ``test_jax_backend``.  Graphs cross over as edge arrays
through ``repro_torch.core.graph_from_arrays``.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import repro.core as jcore
from repro.core.solvers import jax_backend
from repro.kernels import segment_ops as jseg
from test_array_refactor import _instances

import repro_torch.core as tcore
from repro_torch.core import solvers as tsolvers
from repro_torch.core.solvers import BackendUnsupported, torch_backend
from repro_torch.kernels import ref as tref
from repro_torch.kernels import segment_ops as tseg

SOLVERS = ("spt", "mst", "lmg", "mp")
LMG_MULT, MP_MULT = 1.2, 1.5


def _port_graph(g):
    ea = g.arrays()
    return tcore.graph_from_arrays(g.n, g.directed, ea.src, ea.dst, ea.delta, ea.phi)


@pytest.fixture(scope="module")
def pairs():
    return [(g, _port_graph(g)) for g in _instances()]


def _solve(core, g, solver, **kw):
    """One solver of one package; bounds come from the package's own numpy
    trees, which agree (the JAX package's tests pin them)."""
    if solver == "spt":
        return core.shortest_path_tree(g, **kw)
    if solver == "mst":
        return core.minimum_storage_tree(g, **kw)
    if solver == "lmg":
        budget = core.minimum_storage_tree(g, backend="numpy").storage_cost() * LMG_MULT
        return core.local_move_greedy(g, budget, **kw)
    theta = core.shortest_path_tree(g, backend="numpy").max_recreation() * MP_MULT
    return core.modified_prim(g, theta, **kw)


def _assert_same_solution(a, b):
    assert a.parent == b.parent
    assert a.storage_cost() == b.storage_cost()
    assert a.recreation_costs() == b.recreation_costs()


# -------------------------------------------------------------- solvers
class TestSolversMatchJax:
    @pytest.mark.parametrize("idx", range(56))
    @pytest.mark.parametrize("solver", SOLVERS)
    def test_suite_instance(self, pairs, solver, idx):
        g, h = pairs[idx]
        want = _solve(jcore, g, solver, backend="jax", pallas=False)
        got = _solve(tcore, h, solver, backend="torch", device="cpu")
        _assert_same_solution(got, want)

    @pytest.mark.parametrize("idx", [0, 3, 41, 48])
    def test_against_pallas_kernels(self, pairs, idx):
        # the JAX side through its Pallas segment kernels (interpret mode)
        g, h = pairs[idx]
        for solver in SOLVERS:
            want = _solve(jcore, g, solver, backend="jax", pallas=True)
            got = _solve(tcore, h, solver, backend="torch", device="cpu")
            _assert_same_solution(got, want)

    @pytest.mark.parametrize("idx", [1, 4, 7, 30])
    def test_backend_functions(self, pairs, idx):
        # the backend modules themselves: f32 fixpoint, parent arrays, MP
        # structure and one LMG scoring round
        g, h = pairs[idx]
        ea, eb = g.arrays(), h.arrays()
        jd, jp = jax_backend.sssp(ea)
        td, tp = torch_backend.sssp(eb, device="cpu")
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tp, jp)
        theta = jcore.shortest_path_tree(g).max_recreation() * MP_MULT
        jmp, jin = jax_backend.modified_prim_core(ea, theta)
        tmp, tin = torch_backend.modified_prim_core(eb, theta, device="cpu")
        np.testing.assert_array_equal(tmp, jmp)
        np.testing.assert_array_equal(tin, jin)
        if not g.directed:
            np.testing.assert_array_equal(
                torch_backend.prim(eb, device="cpu"), jax_backend.prim(ea))
        rng = np.random.RandomState(idx)
        nc, nv = 50, g.n + 1
        cu = rng.randint(0, nv, nc)
        cv = rng.randint(1, nv, nc)
        cd, cp = rng.uniform(1, 1e3, nc), rng.uniform(1, 1e3, nc)
        state = (
            rng.rand(nc) < 0.8, rng.uniform(1, 1e3, nv), rng.uniform(0, 1e4, nv),
            rng.uniform(0, 5, nv), rng.permutation(nv), rng.randint(1, 4, nv),
            float(rng.uniform(1e4, 2e4)), float(rng.uniform(2e4, 3e4)),
        )
        want = jax_backend.LmgScorer(cu, cv, cd, cp).score(*state)
        got = torch_backend.LmgScorer(cu, cv, cd, cp, device="cpu").score(*state)
        assert got == want


    @pytest.mark.parametrize("idx", [1, 4, 7, 30])
    def test_int32_indices_same_bits_as_int64(self, pairs, idx, monkeypatch):
        # the backend indexes with the int32 tensors it uploads; the same
        # functions fed int64 copies (as they indexed before) give the same bits
        g, h = pairs[idx]
        eb = h.arrays()
        theta = jcore.shortest_path_tree(g).max_recreation() * MP_MULT
        dev = torch.device("cpu")
        got = (torch_backend.sssp(eb, device="cpu"),
               torch_backend.mp_state(eb, theta, dev),
               torch_backend.prim_state(eb, dev) if not g.directed else ())
        in_rows, out_rows = torch_backend.padded_in_rows, torch_backend.padded_out_rows

        def wide_in(ea, **kw):
            r = in_rows(ea, **kw)
            return torch_backend.PaddedRows(r.nvp, r.ids.astype(np.int64), r.w, r.w2)

        def wide_out(ea):
            rows, dst, delta, phi = out_rows(ea)
            return rows, dst.astype(np.int64), delta, phi

        monkeypatch.setattr(torch_backend, "padded_in_rows", wide_in)
        monkeypatch.setattr(torch_backend, "padded_out_rows", wide_out)
        want = (torch_backend.sssp(eb, device="cpu"),
                torch_backend.mp_state(eb, theta, dev),
                torch_backend.prim_state(eb, dev) if not g.directed else ())
        for a, b in zip(got[0], want[0]):
            np.testing.assert_array_equal(a, b)
        for part_got, part_want in zip(got[1:], want[1:]):
            for a, b in zip(part_got, part_want):
                assert torch.equal(a, b)

        rng = np.random.RandomState(idx)
        nc, nv = 50, g.n + 1
        scorer = torch_backend.LmgScorer(
            rng.randint(0, nv, nc), rng.randint(1, nv, nc),
            rng.uniform(1, 1e3, nc), rng.uniform(1, 1e3, nc), device="cpu")
        state = (
            rng.rand(nc) < 0.8, rng.uniform(1, 1e3, nv), rng.uniform(0, 1e4, nv),
            rng.uniform(0, 5, nv), rng.permutation(nv), rng.randint(1, 4, nv),
            float(rng.uniform(1e4, 2e4)), float(rng.uniform(2e4, 3e4)),
        )
        got_score = scorer.score(*state)
        assert scorer._cu.dtype == scorer._cv.dtype == torch.int32
        scorer._cu, scorer._cv = scorer._cu.long(), scorer._cv.long()
        assert scorer.score(*state) == got_score


# --------------------------------------------------------- corner cases
def _star(core, n, directed):
    g = core.VersionGraph(n, directed=directed)
    for i in g.versions():
        g.set_materialization(i, 100.0 + i, 50.0 + i)
    return g


def _disconnected_but_for_root(core, directed):
    g = core.VersionGraph(6, directed=directed)
    for i in g.versions():
        g.set_materialization(i, 1000.0 + 10 * i, 900.0 + 10 * i)
    for a, b, d, p in ((1, 2, 5.0, 4.0), (2, 3, 6.0, 5.0), (4, 5, 7.0, 6.0),
                       (5, 6, 8.0, 7.0)):
        g.set_delta(a, b, d, p)
    return g


def _single(core, directed):
    g = core.VersionGraph(1, directed=directed)
    g.set_materialization(1, 42.0, 17.0)
    return g


def _near_tie(core, directed):
    # a 2-hop path undercutting the direct edge by ~5e-17 (< the 1e-15
    # relaxation slack): both Bellman-Fords must reject the improvement
    g = core.VersionGraph(2, directed=directed)
    g.set_materialization(1, 10.0, 0.15)
    g.set_materialization(2, 10.0, float(np.nextafter(0.3, 1)))
    g.set_delta(1, 2, 1.0, 0.15)
    return g


CORNERS = {
    "single": (_single, 1.5, 2.0),
    "star": (lambda core, d: _star(core, 9, d), 1.5, 1.0),
    "disconnected_but_for_root": (_disconnected_but_for_root, 1.3, 1.4),
    "near_tie": (_near_tie, 1.5, 1.5),
}


class TestCornerCases:
    @pytest.mark.parametrize("directed", [True, False])
    @pytest.mark.parametrize("name", sorted(CORNERS))
    def test_corner(self, name, directed):
        build, lmg_mult, mp_mult = CORNERS[name]
        g, h = build(jcore, directed), build(tcore, directed)
        for solver in ("spt", "mst"):
            _assert_same_solution(
                _solve(tcore, h, solver, backend="torch", device="cpu"),
                _solve(jcore, g, solver, backend="jax"),
            )
        budget = jcore.minimum_storage_tree(g).storage_cost() * lmg_mult
        _assert_same_solution(
            tcore.local_move_greedy(h, budget, backend="torch", device="cpu"),
            jcore.local_move_greedy(g, budget, backend="jax"),
        )
        theta = jcore.shortest_path_tree(g).max_recreation() * mp_mult
        _assert_same_solution(
            tcore.modified_prim(h, theta, backend="torch", device="cpu"),
            jcore.modified_prim(g, theta, backend="jax"),
        )
        if name == "near_tie" and directed:
            assert tcore.shortest_path_tree(
                h, backend="torch", device="cpu").parent == {1: 0, 2: 0}

    def test_unreachable_version_raises_like_numpy(self):
        g = tcore.VersionGraph(2, directed=True)
        g.set_materialization(1, 10.0, 10.0)
        for kw in ({"backend": "numpy"}, {"backend": "torch", "device": "cpu"}):
            with pytest.raises(ValueError, match="unreachable"):
                tcore.shortest_path_tree(g, **kw)

    def test_degree_skew_falls_back_to_numpy(self):
        n = 8192
        g = tcore.VersionGraph(n, directed=True)
        ids = np.arange(1, n + 1, dtype=np.int64)
        ones = np.ones(n, dtype=np.float64)
        g.add_edges_bulk(np.zeros(n, dtype=np.int64), ids, 100 * ones, ones)
        g.add_edges_bulk(np.full(n - 1, 1, dtype=np.int64), ids[1:],
                         ones[1:], ones[1:])
        assert 16384 * (n - 1) > torch_backend.MAX_PADDED_CELLS
        with pytest.raises(BackendUnsupported, match="degree skew"):
            tcore.modified_prim(g, 1e9, backend="torch", device="cpu")
        res = tcore.optimize(
            g, tcore.OptimizeSpec.problem(6, theta=1e9, backend="torch"),
            device="cpu")
        assert res.backend_used == "numpy"
        assert "degree skew" in res.diagnostics["backend_fallback"]
        assert res.solution.parent == tcore.modified_prim(g, 1e9, backend="numpy").parent


class TestOptimizeSurface:
    def test_backend_used_and_directed_mca(self, pairs):
        g, h = pairs[0]  # directed
        for problem in (1, 2):
            spec_t = tcore.OptimizeSpec.problem(problem, backend="torch")
            spec_j = jcore.OptimizeSpec.problem(problem, backend="jax")
            got, want = tcore.optimize(h, spec_t, device="cpu"), jcore.optimize(g, spec_j)
            assert got.solution.parent == want.solution.parent
            assert got.objective_value == want.objective_value
            # directed Problem 1 is host Edmonds in both packages
            assert got.backend_used == ("numpy" if problem == 1 else "torch")
            assert want.backend_used == ("numpy" if problem == 1 else "jax")

    def test_pallas_is_refused(self):
        with pytest.raises(ValueError, match="pallas"):
            tcore.OptimizeSpec.problem(1, backend="torch", pallas=True)
        with pytest.raises(ValueError, match="pallas"):
            tcore.run_solver("mp", tcore.VersionGraph(1), theta=1.0, pallas=False)
        with pytest.raises(ValueError, match="unknown backend"):
            tcore.OptimizeSpec.problem(2, backend="jax")
        # the spec names no route and defaults to the device backend
        assert tcore.OptimizeSpec.problem(2).backend == "torch"
        assert tcore.OptimizeSpec.heuristic("last").backend == "torch"

    def test_default_device_needs_a_card(self, pairs):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default runs there")
        _, h = pairs[0]
        # the default spec and the default device: the card, or an error
        for spec in (tcore.OptimizeSpec.problem(2),
                     tcore.OptimizeSpec.problem(2, backend="torch")):
            with pytest.raises(RuntimeError, match="CUDA"):
                tcore.optimize(h, spec)
        with pytest.raises(RuntimeError, match="CUDA"):
            tcore.shortest_path_tree(h)
        # only an explicit numpy spec runs on the host whatever the device
        spec = tcore.OptimizeSpec.problem(2, backend="numpy")
        assert tcore.optimize(h, spec).backend_used == "numpy"


# ------------------------------------------------------------ segment ops
def _rows(seed, shape):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-100, 100, size=shape).astype(np.float32)
    x[rng.rand(*shape) < 0.15] = np.inf  # padding-like entries
    return x


def _segment_cases():
    x = _rows(0, (37, 19))
    x[3, :] = np.inf                       # all-+inf row
    x[4, [2, 9]] = x[4].min() - 1          # tie at the row minimum
    x[5, 6] = np.nan
    x[6, [1, 11]] = np.nan                 # two NaNs: the first wins
    x[7, :] = 2.5                          # a row of ties
    z = np.float32(0.0)
    return {
        "mixed": x,
        "width_33": _rows(1, (64, 33)),
        "width_1": _rows(2, (10, 1)),
        "one_row": _rows(3, (1, 40)),
        "all_inf": np.full((5, 8), np.inf, np.float32),
        "wide": _rows(4, (3, 300)),
        # XLA's min returns -0.0 for a row that holds both zeros, in any order;
        # the argmin keeps them equal and takes the first
        "signed_zero": np.array([[z, -z, 1], [-z, z, 1], [z, z, -z]], np.float32),
        "neg_inf": np.array([[1, -np.inf, 3, -np.inf], [np.inf] * 4, [-np.inf, 0, 2, 2]],
                            np.float32),
        # the solvers' widths (multiples of 8)
        "width_8": _rows(6, (50, 8)),
        "width_24": _rows(7, (50, 24)),
        "width_32": _rows(8, (50, 32)),
        "width_40": _rows(9, (50, 40)),
    }


SEGMENT_CASES = _segment_cases()


class TestSegmentOpsMatchJax:
    @pytest.mark.parametrize("name", sorted(SEGMENT_CASES))
    @pytest.mark.parametrize("use_pallas", [True, False])
    def test_rows(self, name, use_pallas):
        x = SEGMENT_CASES[name]
        jx, tx = jnp.asarray(x), torch.from_numpy(x.copy())
        jmin = np.asarray(jseg.segment_min_rows(jx, use_pallas=use_pallas))
        jarg = np.asarray(jseg.segment_argmin_rows(jx, use_pallas=use_pallas))
        tmin, targ = tseg.segment_min_rows(tx), tseg.segment_argmin_rows(tx)
        assert targ.dtype == torch.int32 and jarg.dtype == np.int32
        np.testing.assert_array_equal(targ.numpy(), jarg)
        assert tmin.dtype == torch.float32 and jmin.dtype == np.float32
        # by bits: -0.0 == +0.0 as floats (the NaNs here are all np.nan's bits)
        np.testing.assert_array_equal(tmin.numpy().view(np.int32), jmin.view(np.int32))

    @pytest.mark.parametrize("name", sorted(SEGMENT_CASES))
    @pytest.mark.parametrize("use_pallas", [True, False])
    def test_min_argmin_1d(self, name, use_pallas):
        x = SEGMENT_CASES[name].reshape(-1)
        jv, ji = jseg.min_argmin_1d(jnp.asarray(x), use_pallas=use_pallas)
        tv, ti = tseg.min_argmin_1d(torch.from_numpy(x.copy()))
        assert ti.dtype == torch.int32 and tv.dtype == torch.float32
        assert int(ti) == int(ji)
        # The value is held by bits against the XLA form's, x[i], whichever
        # form is under test: the Pallas form returns the XLA min of the
        # winning 128-lane row, which can be -0.0 where x[i] is +0.0 (it
        # differs in the sign of a zero only, and no solver reads it).
        xv, xi = jseg.min_argmin_1d(jnp.asarray(x), use_pallas=False)
        assert int(xi) == int(ji)
        np.testing.assert_array_equal(tv.numpy().view(np.int32),
                                      np.asarray(xv).view(np.int32))
        if not np.isnan(np.asarray(jv)):
            assert float(jv) == float(xv)  # equal as floats in both forms

    def test_mp_slack_is_one_value(self):
        # the re-parenting slack of the CUDA kernel, of its plain version and
        # of the solvers' f32 comparisons
        src = (Path(tseg.__file__).parent / "csrc" / "segment_kernels.cu").read_text()
        lit = re.search(r"constexpr float kEps = ([0-9.eE+-]+)f;", src).group(1)
        assert tref.EPS == tsolvers.EPS
        assert np.float32(lit) == np.float32(tref.EPS) > 0

    def test_inputs_are_checked_and_left_alone(self):
        x = torch.from_numpy(_rows(5, (9, 7)))
        keep = x.clone()
        tseg.segment_min_rows(x), tseg.segment_argmin_rows(x), tseg.min_argmin_1d(x[0])
        assert torch.equal(x, keep)
        with pytest.raises(ValueError, match="float32"):
            tseg.segment_min_rows(x.double())
        with pytest.raises(ValueError, match="float32"):
            tseg.min_argmin_1d(torch.zeros(0))
        meta = torch.empty((4, 8), device="meta")
        with pytest.raises(ValueError, match="CPU or all on one CUDA"):
            tseg.segment_min_rows(meta)
