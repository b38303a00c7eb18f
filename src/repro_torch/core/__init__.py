"""Paper core: dataset-versioning storage/recreation tradeoff.

Implements "Principles of Dataset Versioning: Exploring the Recreation/
Storage Tradeoff" (Bhattacherjee et al., 2015): version graphs, the Δ/Φ cost
matrices, the six optimization problems, and the LMG / MP / LAST / GitH /
MCA / SPT / exact solvers.

A copy of the JAX package's ``repro.core`` for the PyTorch port: the same
public names, with ``backend="torch"`` (the default: the device solver
backend over the hand-written CUDA segment kernels) or ``"numpy"`` and
``device=`` in place of the JAX package's ``"jax"`` backend and ``pallas``
switch.  The JAX package's ``spec_from_solver`` shim for string-named
repacks is left out: the port's ``repack`` takes an ``OptimizeSpec``.
:func:`graph_from_arrays` builds a graph from another package's edge arrays.
"""

from .problems import (
    SOLVERS,
    ConstraintViolation,
    optimize,
    run_solver,
    solve_problem1,
    solve_problem2,
    solve_problem3,
    solve_problem4,
    solve_problem5,
    solve_problem6,
)
from .spec import Constraint, Objective, OptimizeResult, OptimizeSpec
from .solvers.exact import ExactResult, exact_min_storage
from .solvers.gith import git_heuristic
from .solvers.last import last_tree
from .solvers.lmg import local_move_greedy, minimize_storage_sum_recreation
from .solvers.mp import InfeasibleError, min_max_recreation_under_budget, modified_prim
from .solvers.mst import minimum_storage_tree
from .solvers.spt import dijkstra, dijkstra_arrays, shortest_path_tree
from .convert import graph_from_arrays
from .edge_arrays import EdgeArrays
from .synthetic import (
    SyntheticWorkload,
    WorkloadSpec,
    dc_like,
    generate,
    generate_flat,
    lc_like,
    zipf_weights,
)
from .version_graph import EdgeCost, StorageSolution, VersionGraph

__all__ = [
    "VersionGraph",
    "StorageSolution",
    "EdgeCost",
    "EdgeArrays",
    "graph_from_arrays",
    "dijkstra_arrays",
    "generate_flat",
    "minimum_storage_tree",
    "shortest_path_tree",
    "dijkstra",
    "local_move_greedy",
    "minimize_storage_sum_recreation",
    "modified_prim",
    "min_max_recreation_under_budget",
    "InfeasibleError",
    "last_tree",
    "git_heuristic",
    "exact_min_storage",
    "ExactResult",
    "solve_problem1",
    "solve_problem2",
    "solve_problem3",
    "solve_problem4",
    "solve_problem5",
    "solve_problem6",
    "SOLVERS",
    "Objective",
    "Constraint",
    "OptimizeSpec",
    "OptimizeResult",
    "optimize",
    "run_solver",
    "ConstraintViolation",
    "WorkloadSpec",
    "SyntheticWorkload",
    "generate",
    "dc_like",
    "lc_like",
    "zipf_weights",
]
