"""The paper's storage-graph solvers (§4), with selectable compute backends.

Every array-native solver takes ``backend="torch"`` (default) or
``backend="numpy"``:

* ``numpy`` — the heap-driven host implementations; the reference/oracle
  path, always available, and the fallback wherever the device formulation
  does not apply (directed MCA cycle contraction, degree-skew instances).
* ``torch`` — device loops in :mod:`.torch_backend`: whole-graph
  Bellman-Ford SSSP, Prim and Modified-Prim step loops with no host sync
  per step, and the LMG per-round candidate scoring.  Device tensors are
  f32/i32; the device output is a *structure selection*, and every
  authoritative cost is recomputed host-side in f64 from the selected tree.
  The torch backend takes ``device`` (default ``"cuda"``): CUDA tensors run
  the hand-written segment-min/argmin kernels of
  :mod:`repro_torch.kernels.segment_ops`, CPU tensors their plain PyTorch
  versions.  There is no other switch.

Host complexity, per solver: Prim / SPT / MP are O(E log V) binary-heap
loops with vectorized CSR row relaxation; directed MCA is mergeable-heap
Edmonds (:mod:`.mst`); LMG is O(rounds · ξ) with vectorized scoring; GitH is
linear in the walked window.  Cheapest-edge ties break to the lowest edge id
everywhere, which is what keeps backends and oracles in agreement.

Solvers: :mod:`.spt` (Problem 2), :mod:`.mst` (Problem 1 — Prim / Edmonds
MCA), :mod:`.lmg` (Problems 3/5), :mod:`.mp` (Problems 4/6), :mod:`.last`,
:mod:`.gith`, :mod:`.exact`.
"""

BACKENDS = ("numpy", "torch")


class BackendUnsupported(ValueError):
    """The requested compute backend cannot run this instance (e.g. the
    torch dense padded layout would exhaust memory on degree-skew graphs).
    The NumPy path selects the same trees, so ``optimize`` catches this and
    falls back; direct solver callers see it as the documented clear
    error."""


def check_backend(backend: str) -> None:
    """Raise ``ValueError`` unless ``backend`` is one of :data:`BACKENDS`."""
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown solver backend {backend!r}: expected one of "
            f"{list(BACKENDS)}"
        )


# Shared numerical slacks.  Both backends apply identical tolerances in
# every relaxation and feasibility check, so they live here rather than as
# per-module literals.  On the f32 device path EPS sits below float32
# resolution, so those guards degrade to strict comparisons there — exact
# tolerance semantics are restored by the host-side f64 recompute.
EPS = 1e-15            # relaxation acceptance slack (improvements ≤ EPS are
                       # rejected; ties within (0, EPS] are order-dependent
                       # and outside the parity contract)
CONSTRAINT_TOL = 1e-9  # θ / budget feasibility slack
