"""The port's CPU solver trees against the JAX package's at solver scale.

Not a pytest module (it takes minutes): run it by hand on a CPU,

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_solver_scale_check.py 100000

It builds the DC-like graph of ``chip_smoke.py``'s phase (f) (the
solver-scale sweep's shape, same seed), solves Problems 2, 3 and 6 on the
directed graph and Problem 1 on the undirected one with ``repro``'s
``backend="jax"`` and with the port's ``backend="torch", device="cpu"``,
and prints whether the trees are equal, with both f64 objectives.  Phase
(f) shows the card's trees equal the port's CPU trees; together the two
tie the card to the reference at full size.
"""

import sys
import time

import repro.core as J
import repro_torch.core as T

SEED = 1505_05211 % 1000  # chip_smoke.py's phase (f) seed


def main(n: int) -> int:
    same_everywhere = True
    for directed in (True, False):
        g = J.generate_flat(J.WorkloadSpec(
            commits=n, branch_interval=3, branch_prob=0.7, branch_limit=4,
            branch_length=4, reveal_hops=3, seed=SEED, directed=directed,
        )).graph
        ea = g.arrays()
        h = T.graph_from_arrays(g.n, g.directed, ea.src, ea.dst, ea.delta, ea.phi)
        if directed:
            base = J.optimize(g, J.OptimizeSpec.problem(1)).solution
            spt = J.optimize(g, J.OptimizeSpec.problem(2)).solution
            problems = [(2, {}), (3, {"beta": base.storage_cost() * 1.05}),
                        (6, {"theta": spt.max_recreation() * 1.5})]
        else:
            problems = [(1, {})]
        for p, kw in problems:
            t0 = time.perf_counter()
            a = J.optimize(g, J.OptimizeSpec.problem(p, backend="jax", **kw))
            t1 = time.perf_counter()
            b = T.optimize(h, T.OptimizeSpec.problem(p, backend="torch", **kw),
                           device="cpu")
            t2 = time.perf_counter()
            same = a.solution.parent == b.solution.parent
            same_everywhere &= same
            print(f"n={n} directed={directed} P{p}: same_tree={same} objective "
                  f"jax {a.objective_value!r} torch {b.objective_value!r} "
                  f"(backend_used {a.backend_used}/{b.backend_used}; "
                  f"{t1 - t0:.1f} s / {t2 - t1:.1f} s on this host)", flush=True)
    return 0 if same_everywhere else 1


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 100_000))
