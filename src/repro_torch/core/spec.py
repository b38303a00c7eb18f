"""Declarative optimization specs — the paper's (objective, constraint) grid.

The six problems of §2.1 are not six APIs: they are the points of one grid
spanned by *what to minimize* and *what to bound*.  An :class:`OptimizeSpec`
names a grid point declaratively; :func:`repro_torch.core.problems.optimize` maps
it onto the correct paper problem, picks the solver, and returns the
:class:`OptimizeResult` wrapper (solution + diagnostics).

::

    minimize            subject to               paper problem   solver
    ------------------  -----------------------  -------------   ----------------
    storage             (nothing)                1               MST / MCA
    every_recreation    (nothing)                2               SPT
    sum_recreation      storage      <= beta     3               LMG
    max_recreation      storage      <= beta     4               MP + bisection
    storage             sum_recreation <= theta  5               LMG + bin search
    storage             max_recreation <= theta  6               MP

Any other (objective, constraints) combination is off the grid and rejected
at spec construction time.  ``workload`` attaches access-frequency weights
``w_i`` (the Fig. 16 experiment): the recreation objective becomes
``sum_i w_i * R_i``; only problems 3 and 5 can honor it, every other grid
point raises.  ``solver="last"|"gith"`` forces one of the paper's
storage/recreation *balance heuristics* instead of a grid solver — those
take no constraints (their knobs ride in ``options``).

Specs are frozen and hashable: mapping-valued inputs (``workload``,
``options``) are normalized to sorted tuples at construction.

The spec names a compute ``backend`` (``"torch"``, the default, or
``"numpy"``) but no kernel route: the device the caller passes to
:func:`~repro_torch.core.problems.optimize` chooses it (the hand-written
CUDA kernels for a CUDA device, their plain PyTorch versions for the CPU),
so a spec that names no backend runs where the caller's device is.
A ``pallas`` field or option, which the JAX package's specs carry, is
refused with a ``ValueError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Mapping, Optional, Tuple

from .solvers import BACKENDS
from .version_graph import StorageSolution

__all__ = [
    "Objective",
    "Constraint",
    "OptimizeSpec",
    "OptimizeResult",
    "OBJECTIVES",
    "CONSTRAINT_METRICS",
    "HEURISTIC_SOLVERS",
]

#: objective metrics: what a spec minimizes
OBJECTIVES = ("storage", "sum_recreation", "max_recreation", "every_recreation")

#: constraint metrics: what a spec may bound (``every_recreation`` is an
#: objective only — "each R_i finite" is the implicit Problem-1 constraint)
CONSTRAINT_METRICS = ("storage", "sum_recreation", "max_recreation")

#: solvers selectable via ``OptimizeSpec(solver=...)`` — balance heuristics
#: outside the six-problem grid (grid solvers are always auto-picked)
HEURISTIC_SOLVERS = ("last", "gith")

# (objective, sorted constraint metrics) -> paper problem id
_GRID: Dict[Tuple[str, Tuple[str, ...]], int] = {
    ("storage", ()): 1,
    ("every_recreation", ()): 2,
    ("sum_recreation", ("storage",)): 3,
    ("max_recreation", ("storage",)): 4,
    ("storage", ("sum_recreation",)): 5,
    ("storage", ("max_recreation",)): 6,
}

#: grid points whose solver honors per-version workload weights
_WORKLOAD_PROBLEMS = (3, 5)


def _grid_table() -> str:
    return (
        "the grid is: min storage (Problem 1); min every_recreation "
        "(Problem 2); min sum_recreation s.t. storage<=beta (Problem 3); "
        "min max_recreation s.t. storage<=beta (Problem 4); min storage "
        "s.t. sum_recreation<=theta (Problem 5); min storage s.t. "
        "max_recreation<=theta (Problem 6)"
    )


@dataclasses.dataclass(frozen=True)
class Objective:
    """What to minimize: one of :data:`OBJECTIVES`.

    ``every_recreation`` is the Problem-2 objective — minimize *each* ``R_i``
    simultaneously (the SPT achieves all of them at once).
    """

    metric: str

    def __post_init__(self) -> None:
        if self.metric not in OBJECTIVES:
            raise ValueError(
                f"unknown objective metric {self.metric!r}: "
                f"expected one of {list(OBJECTIVES)}"
            )

    # -- constructors ------------------------------------------------------
    @classmethod
    def storage(cls) -> "Objective":
        """Minimize total storage C."""
        return cls("storage")

    @classmethod
    def sum_recreation(cls) -> "Objective":
        """Minimize sum_i R_i (weighted by the spec's workload, if any)."""
        return cls("sum_recreation")

    @classmethod
    def max_recreation(cls) -> "Objective":
        """Minimize max_i R_i."""
        return cls("max_recreation")

    @classmethod
    def every_recreation(cls) -> "Objective":
        """Minimize each R_i simultaneously (Problem 2; the SPT)."""
        return cls("every_recreation")


@dataclasses.dataclass(frozen=True)
class Constraint:
    """An upper bound on one of :data:`CONSTRAINT_METRICS`."""

    metric: str
    bound: float

    def __post_init__(self) -> None:
        if self.metric not in CONSTRAINT_METRICS:
            raise ValueError(
                f"unknown constraint metric {self.metric!r}: "
                f"expected one of {list(CONSTRAINT_METRICS)}"
            )
        bound = float(self.bound)
        if bound != bound or bound in (float("inf"), float("-inf")):
            raise ValueError(
                f"constraint bound on {self.metric!r} must be finite, "
                f"got {self.bound!r}"
            )
        object.__setattr__(self, "bound", bound)

    # -- constructors ------------------------------------------------------
    @classmethod
    def storage_at_most(cls, beta: float) -> "Constraint":
        """C <= beta (the storage budget of Problems 3/4)."""
        return cls("storage", beta)

    @classmethod
    def sum_recreation_at_most(cls, theta: float) -> "Constraint":
        """sum_i R_i <= theta (Problem 5)."""
        return cls("sum_recreation", theta)

    @classmethod
    def max_recreation_at_most(cls, theta: float) -> "Constraint":
        """max_i R_i <= theta (Problem 6; the restore-latency SLA)."""
        return cls("max_recreation", theta)


def _refuse_pallas(options: Mapping[str, Any]) -> None:
    """Raise ``ValueError`` if ``options`` carries the JAX package's
    ``pallas`` switch: in the port the device chooses the kernel route."""
    if "pallas" in options:
        raise ValueError(
            "'pallas' is not an option of the PyTorch port: the device "
            "chooses the route (the CUDA kernels for a CUDA device, their "
            "plain PyTorch versions for the CPU); pass device= to "
            "optimize() instead"
        )


def _as_sorted_items(
    value: Any, what: str, *, key_type: type = str
) -> Tuple[Tuple[Any, Any], ...]:
    """Normalize a mapping / iterable of pairs to a sorted tuple of pairs."""
    if value is None:
        return ()
    items = value.items() if isinstance(value, Mapping) else value
    out = []
    for pair in items:
        k, v = pair
        if key_type is int:
            try:
                k = int(k)  # accept numpy integer ids
            except (TypeError, ValueError):
                raise ValueError(f"{what} keys must be ints, got {k!r}")
        elif not isinstance(k, key_type):
            raise ValueError(
                f"{what} keys must be {key_type.__name__}, got {k!r}"
            )
        out.append((k, v))
    out.sort(key=lambda kv: kv[0])
    keys = [k for k, _ in out]
    if len(set(keys)) != len(keys):
        raise ValueError(f"duplicate {what} keys: {keys}")
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class OptimizeSpec:
    """A declarative request: objective + constraints + execution knobs.

    Fields
    ------
    objective / constraints
        The grid point (see module docstring).  At most one constraint per
        metric; the objective's own metric cannot also be constrained.
    workload
        Optional per-version access weights ``{vid: w}``; the recreation
        objective becomes ``sum_i w_i R_i``.  Only grid points whose solver
        is LMG-based (Problems 3 and 5) honor weights — any other point
        raises at construction.
    solver
        ``None`` (auto-pick from the grid) or one of
        :data:`HEURISTIC_SOLVERS` to force a balance heuristic; forced
        heuristics take ``objective=storage`` and no constraints.
    backend
        Compute backend for the solver inner loops: ``"torch"`` (the
        default; on the device ``optimize`` is given) or ``"numpy"`` (the
        host).  ``optimize`` transparently falls back to the NumPy
        path — the same trees by contract — where the device formulation
        does not apply (directed MCA, degree-skew instances) and records the
        fallback in the result diagnostics.
    options
        Solver-specific knobs (``alpha``, ``window``, ``max_depth``,
        ``tol``, ``max_iters``, precomputed ``base``/``spt`` trees);
        validated against the chosen solver by ``optimize``.
    """

    objective: Objective
    constraints: Tuple[Constraint, ...] = ()
    workload: Optional[Tuple[Tuple[int, float], ...]] = None
    solver: Optional[str] = None
    backend: str = "torch"
    options: Tuple[Tuple[str, Any], ...] = ()

    def __post_init__(self) -> None:
        if isinstance(self.objective, str):
            object.__setattr__(self, "objective", Objective(self.objective))
        cons = self.constraints
        if isinstance(cons, Constraint):
            cons = (cons,)
        cons = tuple(cons)
        object.__setattr__(self, "constraints", cons)
        metrics = [c.metric for c in cons]
        if len(set(metrics)) != len(metrics):
            raise ValueError(f"duplicate constraint metrics: {metrics}")
        if self.objective.metric in metrics:
            raise ValueError(
                f"objective {self.objective.metric!r} cannot also be "
                f"constrained; {_grid_table()}"
            )
        # normalize mapping-valued fields so specs are hashable
        wl = self.workload
        if wl is not None:
            wl = _as_sorted_items(wl, "workload", key_type=int)
            for vid, w in wl:
                w = float(w)
                if vid < 1 or not w == w or w < 0:
                    raise ValueError(
                        f"workload weights must map version ids >= 1 to "
                        f"finite weights >= 0, got {vid}: {w!r}"
                    )
            wl = tuple((vid, float(w)) for vid, w in wl)
        object.__setattr__(self, "workload", wl)
        object.__setattr__(
            self, "options", _as_sorted_items(self.options, "options")
        )
        _refuse_pallas(dict(self.options))
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {self.backend!r}: expected one of "
                f"{list(BACKENDS)}"
            )
        if self.solver is not None:
            if self.solver not in HEURISTIC_SOLVERS:
                raise ValueError(
                    f"solver={self.solver!r} is not a forcible heuristic "
                    f"(accepted: {list(HEURISTIC_SOLVERS)}); grid solvers "
                    f"are picked automatically from (objective, constraints)"
                )
            if self.objective.metric != "storage" or cons:
                raise ValueError(
                    f"heuristic solver {self.solver!r} takes "
                    f"objective=storage and no constraints (its knobs go in "
                    f"options=); got objective={self.objective.metric!r}, "
                    f"constraints={metrics}"
                )
            if wl is not None:
                raise ValueError(
                    f"heuristic solver {self.solver!r} cannot honor workload "
                    f"weights; use Problem 3 or 5 (LMG) for workload-aware "
                    f"optimization"
                )
        else:
            pid = self.problem_id()  # raises for off-grid combinations
            if wl is not None and pid not in _WORKLOAD_PROBLEMS:
                raise ValueError(
                    f"Problem {pid} ({self.solver_name()}) cannot honor "
                    f"workload weights — only Problems "
                    f"{list(_WORKLOAD_PROBLEMS)} (LMG-based) are "
                    f"workload-aware; drop the workload or change the spec"
                )

    def __hash__(self) -> int:
        # option *values* may be unhashable execution hints (precomputed
        # base/spt StorageSolutions); collapse those to a constant so the
        # spec itself always hashes — equal specs still hash equal, and the
        # declarative fields keep their full discrimination
        def h(v: Any) -> int:
            try:
                return hash(v)
            except TypeError:
                return 0
        return hash((
            self.objective, self.constraints, self.workload, self.solver,
            self.backend,
            tuple((k, h(v)) for k, v in self.options),
        ))

    # ------------------------------------------------------------- accessors
    def problem_id(self) -> Optional[int]:
        """The paper problem this spec maps to (None for forced heuristics)."""
        if self.solver is not None:
            return None
        key = (
            self.objective.metric,
            tuple(sorted(c.metric for c in self.constraints)),
        )
        pid = _GRID.get(key)
        if pid is None:
            raise ValueError(
                f"objective={self.objective.metric!r} with constraints on "
                f"{list(key[1])} is off the paper grid; {_grid_table()}"
            )
        return pid

    def solver_name(self) -> str:
        """The solver this spec resolves to (forced heuristic or grid pick)."""
        if self.solver is not None:
            return self.solver
        return {1: "mca", 2: "spt", 3: "lmg", 4: "mp+bisect",
                5: "lmg+binsearch", 6: "mp"}[self.problem_id()]

    def supports_workload(self) -> bool:
        """True when this grid point's solver honors workload weights."""
        return self.solver is None and self.problem_id() in _WORKLOAD_PROBLEMS

    def bound(self, metric: str) -> Optional[float]:
        """The constraint bound on ``metric``, or None."""
        for c in self.constraints:
            if c.metric == metric:
                return c.bound
        return None

    def weights(self) -> Optional[Dict[int, float]]:
        """The workload as a plain ``{vid: weight}`` dict (or None)."""
        if self.workload is None:
            return None
        return dict(self.workload)

    def options_dict(self) -> Dict[str, Any]:
        return dict(self.options)

    def with_workload(self, weights: Optional[Mapping[int, float]]) -> "OptimizeSpec":
        """A copy of this spec with the workload replaced (re-validated)."""
        return dataclasses.replace(self, workload=weights)

    # ---------------------------------------------------------- constructors
    @classmethod
    def problem(
        cls,
        n: int,
        *,
        beta: Optional[float] = None,
        theta: Optional[float] = None,
        workload: Optional[Mapping[int, float]] = None,
        backend: str = "torch",
        **options: Any,
    ) -> "OptimizeSpec":
        """The spec for paper problem ``n`` (1-6).

        ``beta`` is the storage budget (Problems 3/4); ``theta`` the
        recreation bound (Problems 5/6); extra kwargs become solver options.
        """
        def need(name: str, value: Optional[float]) -> float:
            if value is None:
                raise ValueError(f"Problem {n} requires {name}=")
            return value

        def reject(name: str, value: Optional[float]) -> None:
            if value is not None:
                raise ValueError(f"Problem {n} does not take {name}=")

        if n == 1:
            reject("beta", beta), reject("theta", theta)
            obj, cons = Objective.storage(), ()
        elif n == 2:
            reject("beta", beta), reject("theta", theta)
            obj, cons = Objective.every_recreation(), ()
        elif n == 3:
            reject("theta", theta)
            obj = Objective.sum_recreation()
            cons = (Constraint.storage_at_most(need("beta", beta)),)
        elif n == 4:
            reject("theta", theta)
            obj = Objective.max_recreation()
            cons = (Constraint.storage_at_most(need("beta", beta)),)
        elif n == 5:
            reject("beta", beta)
            obj = Objective.storage()
            cons = (Constraint.sum_recreation_at_most(need("theta", theta)),)
        elif n == 6:
            reject("beta", beta)
            obj = Objective.storage()
            cons = (Constraint.max_recreation_at_most(need("theta", theta)),)
        else:
            raise ValueError(f"paper problems are 1..6, got {n}")
        return cls(
            objective=obj, constraints=cons, workload=workload,
            backend=backend, options=options,
        )

    @classmethod
    def heuristic(
        cls,
        solver: str,
        *,
        backend: str = "torch",
        **options: Any,
    ) -> "OptimizeSpec":
        """A spec forcing one of the balance heuristics (:data:`HEURISTIC_SOLVERS`)."""
        return cls(
            objective=Objective.storage(), solver=solver,
            backend=backend, options=options,
        )

    def describe(self) -> str:
        cons = ", ".join(f"{c.metric}<={c.bound:g}" for c in self.constraints)
        parts = [f"min {self.objective.metric}"]
        if cons:
            parts.append(f"s.t. {cons}")
        if self.workload is not None:
            parts.append(f"workload({len(self.workload)} weights)")
        if self.solver:
            parts.append(f"solver={self.solver}")
        pid = self.problem_id()
        if pid is not None:
            parts.append(f"[Problem {pid}]")
        return " ".join(parts)


@dataclasses.dataclass
class OptimizeResult:
    """What :func:`repro_torch.core.problems.optimize` returns: the solution plus
    everything needed to audit how it was obtained.

    ``objective_value`` is the spec's objective metric evaluated on the
    solution (``every_recreation`` reports the sum — the SPT minimizes each
    term, so the sum is the natural scalar); ``objective_values`` always
    carries all three metrics (plus ``weighted_sum_recreation`` when a
    workload was attached).  ``constraint_slack[metric] = bound - achieved``
    is >= -tolerance by construction — ``optimize`` re-validates every
    constraint on the returned tree and refuses to return a violating
    solution.  ``backend_used`` differs from ``spec.backend`` exactly when a
    documented fallback fired (directed MCA, degree skew); the reason is in
    ``diagnostics["backend_fallback"]``.
    """

    solution: StorageSolution
    spec: OptimizeSpec
    problem: Optional[int]
    solver: str
    backend_used: str
    objective_value: float
    objective_values: Dict[str, float]
    constraint_slack: Dict[str, float]
    wall_time_s: float
    diagnostics: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def summary(self) -> str:
        pid = f"P{self.problem}" if self.problem else self.solver
        slack = ", ".join(
            f"{m} slack={s:.4g}" for m, s in self.constraint_slack.items()
        )
        return (
            f"[{pid}/{self.solver}/{self.backend_used}] "
            f"{self.spec.objective.metric}={self.objective_value:.6g}"
            + (f" ({slack})" if slack else "")
            + f" in {self.wall_time_s:.3f}s"
        )
