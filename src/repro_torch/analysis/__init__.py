"""repro_torch.analysis — the storage-graph fsck and its finding framework.

The port's copy of the JAX package's ``repro.analysis`` without the kernel
auditor (which traces jaxprs; a torch auditor is still to come):

* :mod:`.findings` — :class:`Finding`, :class:`Severity`, :class:`Report`,
  the baseline file and :func:`partition`, as in the JAX package;
* :mod:`.fsck` — :func:`fsck_store`, the storage-graph fsck (also
  ``VersionStore.fsck()`` / ``Repository.fsck()``): dangling parents and
  bases, ``stored_base`` cycles, missing and orphaned objects, an
  independent chain re-decode with content-fingerprint recomputation on the
  store's device, ref validity, and the constraint bounds recorded by the
  last ``repack``.  Same rule ids, severities and subjects as the JAX
  package's fsck.
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
]
