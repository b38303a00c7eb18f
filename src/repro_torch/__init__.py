"""PyTorch and CUDA port of the dataset-versioning system (``repro``).

The JAX package ``repro`` is the reference; this package reimplements its
commit and checkout path on PyTorch, with hand-written CUDA kernels for the
block-sparse delta path (``repro_torch.kernels``), and reads and writes the
same on-disk stores (``repro_torch.store``).  It imports neither JAX nor
anything of ``repro``.  Entry points run on the card unless the caller
passes ``device="cpu"``.
"""

from .store import Repository, VersionStore

__all__ = ["Repository", "VersionStore"]
