"""PyTorch and CUDA port of the dataset-versioning system (``repro``).

The JAX package ``repro`` is the reference; this package reimplements its
commit and checkout path, its solvers and repack, and its dense-LM serving
path on PyTorch, with hand-written CUDA kernels (``repro_torch.kernels``),
and reads and writes the same on-disk stores (``repro_torch.store``).  The
models (``repro_torch.models``, ``repro_torch.configs``) keep the JAX
package's parameter tree; ``repro_torch.serving`` and
``repro_torch.launch.serve`` serve them.  ``repro_torch.service`` serves a
repository to many clients, ``repro_torch.analysis`` checks its storage
graph (fsck), and ``repro_torch.obs`` traces both.  It imports neither JAX
nor anything of ``repro``.  Entry points run on the card unless the caller
passes ``device="cpu"``.
"""

from .store import Repository, VersionStore

__all__ = ["Repository", "VersionStore"]
