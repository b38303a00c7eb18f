"""The paper's optimization problems behind one declarative entry point.

§2.1 poses six problems, but they are all points on a single
(objective, constraint) grid — which is exactly how the public API now
exposes them: build an :class:`~repro_torch.core.spec.OptimizeSpec` and call
:func:`optimize`.

::

    spec                                              problem  solver
    ------------------------------------------------  -------  --------------
    OptimizeSpec.problem(1)
      = min storage                                   1        MST / MCA
    OptimizeSpec.problem(2)
      = min every_recreation                          2        SPT
    OptimizeSpec.problem(3, beta=B)
      = min sum_recreation  s.t. storage <= B         3        LMG
    OptimizeSpec.problem(4, beta=B)
      = min max_recreation  s.t. storage <= B         4        MP + bisection
    OptimizeSpec.problem(5, theta=T)
      = min storage  s.t. sum_recreation <= T         5        LMG + bin search
    OptimizeSpec.problem(6, theta=T)
      = min storage  s.t. max_recreation <= T         6        MP

Specs may be built from parts too —
``OptimizeSpec(Objective.sum_recreation(), (Constraint.storage_at_most(B),))``
is the same grid point as ``OptimizeSpec.problem(3, beta=B)``.  ``optimize``
maps the spec onto the right problem, runs the solver (``backend="torch"``,
the default, on the ``device`` passed to ``optimize``, or ``"numpy"`` on the
host), transparently falls
back to the NumPy path (the same trees) where the device formulation does
not apply (directed MCA cycle contraction; degree-skew instances whose dense
padded layout would OOM), validates every constraint on the returned tree,
and wraps the :class:`~repro_torch.core.version_graph.StorageSolution` in an
:class:`~repro_torch.core.spec.OptimizeResult` carrying the problem id, solver and
backend actually used, objective values, constraint slack, and wall time.

``workload={vid: weight}`` turns the recreation objective into
``sum_i w_i R_i`` (paper Fig. 16); only the LMG-based grid points (Problems
3 and 5) honor it, and every other point refuses loudly instead of silently
dropping the weights.

The legacy surfaces remain: ``solve_problem1..6`` are the positional
entry points (bit-identical to ``optimize`` on the corresponding spec — a
property test enforces this), and the ``SOLVERS`` registry / ``run_solver``
dispatch by name with validated kwargs — unknown solver names and
unsupported kwargs raise ``ValueError`` naming the offender and the
accepted set.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, FrozenSet, Optional, Tuple

from ..obs.tracer import start as _trace_start
from .solvers import CONSTRAINT_TOL, BackendUnsupported
from .solvers.gith import git_heuristic
from .solvers.last import last_tree
from .solvers.lmg import local_move_greedy, minimize_storage_sum_recreation
from .solvers.mp import min_max_recreation_under_budget, modified_prim
from .solvers.mst import minimum_storage_tree
from .solvers.spt import shortest_path_tree
from .spec import OptimizeResult, OptimizeSpec, _refuse_pallas
from .version_graph import StorageSolution, VersionGraph

__all__ = [
    "optimize",
    "ConstraintViolation",
    "run_solver",
    "solve_problem1",
    "solve_problem2",
    "solve_problem3",
    "solve_problem4",
    "solve_problem5",
    "solve_problem6",
    "SOLVERS",
]


class ConstraintViolation(RuntimeError):
    """A solver returned a tree violating the spec's constraints — a solver
    bug by definition (``optimize`` refuses to return such a solution)."""


# --------------------------------------------------------------- legacy API
def solve_problem1(g: VersionGraph) -> StorageSolution:
    """Minimize total storage; recreation costs merely finite."""
    return minimum_storage_tree(g)


def solve_problem2(g: VersionGraph) -> StorageSolution:
    """Minimize every R_i (the SPT minimizes all of them simultaneously)."""
    return shortest_path_tree(g)


def solve_problem3(
    g: VersionGraph, beta: float, *, weights: Optional[Dict[int, float]] = None
) -> StorageSolution:
    """Minimize Σ R_i subject to C ≤ β (LMG; workload-aware via weights)."""
    return local_move_greedy(g, beta, weights=weights)


def solve_problem4(g: VersionGraph, beta: float) -> StorageSolution:
    """Minimize max R_i subject to C ≤ β."""
    return min_max_recreation_under_budget(g, beta)


def solve_problem5(
    g: VersionGraph, theta: float, *, weights: Optional[Dict[int, float]] = None
) -> StorageSolution:
    """Minimize C subject to Σ R_i ≤ θ."""
    return minimize_storage_sum_recreation(g, theta, weights=weights)


def solve_problem6(g: VersionGraph, theta: float) -> StorageSolution:
    """Minimize C subject to max R_i ≤ θ."""
    return modified_prim(g, theta)


# ---------------------------------------------------------- named dispatch
# per-solver contract: callable, required kwargs, accepted kwargs
_SOLVER_TABLE: Dict[str, Tuple[Callable, FrozenSet[str], FrozenSet[str]]] = {
    "mca": (
        minimum_storage_tree,
        frozenset(),
        frozenset({"backend", "device"}),
    ),
    "spt": (
        shortest_path_tree,
        frozenset(),
        frozenset({"weight", "backend", "device"}),
    ),
    "lmg": (
        lambda g, budget, **kw: local_move_greedy(g, budget, **kw),
        frozenset({"budget"}),
        frozenset({"budget", "weights", "base", "spt", "backend", "device"}),
    ),
    "mp": (
        lambda g, theta, **kw: modified_prim(g, theta, **kw),
        frozenset({"theta"}),
        frozenset({"theta", "backend", "device"}),
    ),
    "last": (
        lambda g, alpha=2.0, **kw: last_tree(g, alpha, **kw),
        frozenset(),
        frozenset({"alpha", "base"}),
    ),
    "gith": (
        git_heuristic,
        frozenset(),
        frozenset({"window", "max_depth"}),
    ),
}


def _validate_solver_kwargs(name: str, kwargs: Dict[str, Any]) -> Callable:
    """Validation for ``run_solver``; returns the solver callable.  Unknown names and unsupported/missing kwargs raise
    ``ValueError`` naming the solver, the offending kwarg, and the accepted
    set — never a bare ``KeyError``/``TypeError``."""
    _refuse_pallas(kwargs)
    entry = _SOLVER_TABLE.get(name)
    if entry is None:
        raise ValueError(
            f"unknown solver {name!r}: accepted solvers are "
            f"{sorted(_SOLVER_TABLE)}"
        )
    fn, required, accepted = entry
    unknown = set(kwargs) - accepted
    if unknown:
        raise ValueError(
            f"solver {name!r} does not accept kwarg(s) {sorted(unknown)}; "
            f"accepted: {sorted(accepted)}"
        )
    missing = required - set(kwargs)
    if missing:
        raise ValueError(
            f"solver {name!r} requires kwarg(s) {sorted(missing)}"
        )
    return fn


def run_solver(name: str, g: VersionGraph, **kwargs: Any) -> StorageSolution:
    """Dispatch a solver by name with validated kwargs (see
    :func:`_validate_solver_kwargs` for the failure modes)."""
    return _validate_solver_kwargs(name, kwargs)(g, **kwargs)


class _SolverRegistry(dict):
    """Name -> callable registry whose misses explain themselves."""

    def __missing__(self, key):
        raise ValueError(
            f"unknown solver {key!r}: accepted solvers are {sorted(self)}"
        )


def _make_entry(name: str) -> Callable:
    def call(g: VersionGraph, **kwargs: Any) -> StorageSolution:
        return run_solver(name, g, **kwargs)

    call.__name__ = f"solver_{name}"
    return call


# registry of the solvers by name; each entry validates its kwargs (see ``run_solver``) and the registry itself
# turns unknown names into a ValueError listing the accepted set
SOLVERS = _SolverRegistry({name: _make_entry(name) for name in _SOLVER_TABLE})


# ------------------------------------------------------------ optimize(...)
# solver options each grid point accepts (beyond backend, a spec field)
_PROBLEM_OPTIONS: Dict[int, FrozenSet[str]] = {
    1: frozenset(),
    2: frozenset(),
    3: frozenset({"base", "spt"}),
    4: frozenset({"tol", "max_iters"}),
    5: frozenset({"tol", "max_iters"}),
    6: frozenset(),
}
_HEURISTIC_OPTIONS: Dict[str, FrozenSet[str]] = {
    "last": frozenset({"alpha", "base"}),
    "gith": frozenset({"window", "max_depth"}),
}


def _check_options(opts: Dict[str, Any], accepted: FrozenSet[str], who: str) -> None:
    unknown = set(opts) - accepted
    if unknown:
        raise ValueError(
            f"{who} does not accept option(s) {sorted(unknown)}; "
            f"accepted: {sorted(accepted)}"
        )


def optimize(
    g: VersionGraph, spec: OptimizeSpec, *, device: str = "cuda"
) -> OptimizeResult:
    """Solve the grid point named by ``spec`` on ``g``.

    ``device`` is where ``backend="torch"`` (a spec's default) computes:
    ``"cuda"`` (the default; raises without a card) runs the hand-written
    kernels, ``"cpu"`` their plain PyTorch versions.  Only a spec that asks
    for ``backend="numpy"`` runs on the host whatever the device.

    Returns an :class:`~repro_torch.core.spec.OptimizeResult`; the wrapped
    ``StorageSolution`` is bit-identical to the corresponding legacy
    ``solve_problemN`` call (same tree, same float costs).  Raises
    ``ValueError`` for infeasible bounds (propagated from the solvers) and
    :class:`ConstraintViolation` if a solver ever returned a tree violating
    the spec — the latter is a bug trap, not an expected path.
    """
    if not isinstance(spec, OptimizeSpec):
        raise TypeError(
            f"optimize() takes an OptimizeSpec, got {type(spec).__name__}; "
            f"solvers by name go through run_solver()"
        )
    t0 = time.monotonic()
    _sp = _trace_start("core.optimize", n=g.n)
    weights = spec.weights()
    opts = spec.options_dict()
    diagnostics: Dict[str, Any] = {}
    backend_used = spec.backend

    problem = spec.problem_id()
    solver_name = spec.solver_name()
    if problem is None:
        _check_options(opts, _HEURISTIC_OPTIONS[spec.solver], f"solver {spec.solver!r}")
        sol = run_solver(spec.solver, g, **opts)
        backend_used = "numpy"  # heuristics are host-only
        if spec.backend != "numpy":
            diagnostics["backend_fallback"] = (
                f"heuristic solver {spec.solver!r} has no device formulation"
            )
    else:
        _check_options(opts, _PROBLEM_OPTIONS[problem], f"Problem {problem}")

        def run(backend: str) -> StorageSolution:
            if problem == 1:
                return minimum_storage_tree(g, backend=backend,
                                            device=device)
            if problem == 2:
                return shortest_path_tree(g, backend=backend, device=device)
            if problem == 3:
                return local_move_greedy(
                    g, spec.bound("storage"), weights=weights,
                    backend=backend, device=device, **opts,
                )
            if problem == 4:
                return min_max_recreation_under_budget(
                    g, spec.bound("storage"), backend=backend,
                    device=device, **opts,
                )
            if problem == 5:
                return minimize_storage_sum_recreation(
                    g, spec.bound("sum_recreation"), weights=weights,
                    backend=backend, device=device, **opts,
                )
            return modified_prim(
                g, spec.bound("max_recreation"), backend=backend,
                device=device,
            )

        try:
            sol = run(spec.backend)
        except BackendUnsupported as e:
            # the torch backend refuses instances its formulation cannot run
            # (degree skew blowing up the dense padded layout); the NumPy
            # CSR path selects the same trees, so fall back transparently
            diagnostics["backend_fallback"] = str(e)
            backend_used = "numpy"
            sol = run("numpy")
        if problem == 1 and g.directed and spec.backend == "torch":
            # MCA cycle contraction is host-only; minimum_storage_tree took
            # the Edmonds path regardless of the requested backend
            backend_used = "numpy"
            diagnostics.setdefault(
                "backend_fallback",
                "directed Problem 1 uses the host mergeable-heap Edmonds "
                "MCA (near-linear run-heap contraction; cycle contraction "
                "has no device formulation)",
            )

    sol.validate()

    # objective values + constraint validation on the *returned* tree
    values: Dict[str, float] = {
        "storage": sol.storage_cost(),
        "sum_recreation": sol.sum_recreation(),
        "max_recreation": sol.max_recreation(),
    }
    if weights is not None:
        values["weighted_sum_recreation"] = sol.sum_recreation(weights)

    def achieved(metric: str) -> float:
        if metric == "sum_recreation" and weights is not None:
            return values["weighted_sum_recreation"]
        return values[metric]

    slack: Dict[str, float] = {}
    for c in spec.constraints:
        got = achieved(c.metric)
        slack[c.metric] = c.bound - got
        tol = CONSTRAINT_TOL + 1e-9 * abs(c.bound)
        if got > c.bound + tol:
            raise ConstraintViolation(
                f"solver {solver_name!r} returned {c.metric}={got!r} above "
                f"the bound {c.bound!r} (slack {slack[c.metric]:.3g}) — "
                f"this is a solver bug"
            )

    obj_metric = spec.objective.metric
    if obj_metric == "every_recreation":
        objective_value = values["sum_recreation"]
    elif obj_metric == "sum_recreation" and weights is not None:
        objective_value = values["weighted_sum_recreation"]
    else:
        objective_value = values[obj_metric]

    if _sp:
        _sp.set(
            problem=problem,
            solver=solver_name,
            backend=spec.backend,
            backend_used=backend_used,
            fallback="backend_fallback" in diagnostics,
            objective=obj_metric,
            objective_value=float(objective_value),
        )
    _sp.end()
    return OptimizeResult(
        solution=sol,
        spec=spec,
        problem=problem,
        solver=solver_name,
        backend_used=backend_used,
        objective_value=objective_value,
        objective_values=values,
        constraint_slack=slack,
        wall_time_s=time.monotonic() - t0,
        diagnostics=diagnostics,
    )
