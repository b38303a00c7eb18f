"""repro_torch.analysis — the port's analyses and their finding framework.

The port's copy of the JAX package's ``repro.analysis``:

* :mod:`.findings` — :class:`Finding`, :class:`Severity`, :class:`Report`,
  the baseline file and :func:`partition`, as in the JAX package;
* :mod:`.fsck` — :func:`fsck_store`, the storage-graph fsck (also
  ``VersionStore.fsck()`` / ``Repository.fsck()``): dangling parents and
  bases, ``stored_base`` cycles, missing and orphaned objects, an
  independent chain re-decode with content-fingerprint recomputation on the
  store's device, ref validity, and the constraint bounds recorded by the
  last ``repack``.  Same rule ids, severities and subjects as the JAX
  package's fsck;
* :mod:`.kernel_audit` — :func:`run_audit`, the kernel and dispatch
  auditor: it runs every kernel wrapper and solver entry point on a device
  and lints 64-bit values (``audit.dtype64``, ``audit.dtype64-source``),
  host syncs in the checkout hot path (``audit.host-sync``), the shape
  buckets (``audit.shape-bucket``) and writes into arguments
  (``audit.arg-write``, the port's rule in place of ``audit.io-alias``);
* :mod:`.cli` — ``python -m repro_torch.analysis {audit,fsck}``, gated on
  the port's own baseline, ``analysis_baseline_torch.json``.
"""

from .findings import (
    GATE_SEVERITY,
    Finding,
    Report,
    Severity,
    load_baseline,
    partition,
    write_baseline,
)
from .fsck import fsck_store

__all__ = [
    "Finding",
    "Severity",
    "Report",
    "GATE_SEVERITY",
    "load_baseline",
    "write_baseline",
    "partition",
    "fsck_store",
    "run_audit",
]


def run_audit(device="cuda"):
    """Lazy re-export of :func:`repro_torch.analysis.kernel_audit.run_audit`
    (the auditor's targets import the kernels and solvers only when it runs)."""
    from .kernel_audit import run_audit as _run

    return _run(device)
