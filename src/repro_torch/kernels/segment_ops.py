"""Segment min / argmin over padded rows, and the Modified-Prim re-parenting.

The device solver backend (:mod:`repro_torch.core.solvers.torch_backend`)
lays the version graph's CSR rows out as dense ``(rows, width)`` f32
matrices padded with ``+inf``; the reductions over that layout are the
solvers' inner loops:

* :func:`segment_min_rows`    — per-row minimum (the Bellman-Ford relaxation);
* :func:`segment_argmin_rows` — per-row first-minimum index, int32;
* :func:`min_argmin_1d`       — global ``(min, first argmin)`` of a flat
  vector as device scalars (vertex selection in Prim / MP, ρ-argmax in LMG);
* :func:`mp_reparent`         — MP's sequential in-tree re-parenting of one
  step, in place on the loop's own ``l`` / ``d`` / ``p`` buffers.

The first three replace ``_row_call`` (``pl.pallas_call``) of the JAX
package's ``src/repro/kernels/segment_ops.py`` as reached from its
``segment_min_rows``, ``segment_argmin_rows`` and ``min_argmin_1d``;
``mp_reparent`` is the re-parenting ``fori_loop`` of its ``_mp_jit``.  The
CUDA kernels are in ``csrc/segment_kernels.cu``, where their bound and
design are noted.  NaN is the minimum and propagates, ties go to the first
index, and an all-``+inf`` input gives ``(+inf, 0)``, as with XLA's
reductions.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import count_launch, is_cpu, launch
from .ref import (
    min_argmin_1d_ref,
    mp_reparent_ref,
    segment_argmin_rows_ref,
    segment_min_rows_ref,
)

LANE = 128  # the JAX form's row width for 1d reductions (TPU lane width)

# largest flat vector min_argmin_1d can index with int32 math (the JAX form's
# padded length r * LANE + col must not wrap); refused before any launch
MAX_INT32_ELEMS = (1 << 31) - 1 - LANE

_MAX_PARTS = 256   # first-stage blocks of the 1d reduction (as in the .cu)
_PER_PART = 2048   # elements per first-stage block, at least


def _check_matrix(x: torch.Tensor) -> None:
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(
            f"expected a (rows, width) float32 matrix, got {x.dtype} "
            f"{tuple(x.shape)}"
        )
    if x.shape[1] == 0 or x.shape[1] > MAX_INT32_ELEMS:
        raise ValueError(f"row width must be 1..{MAX_INT32_ELEMS}, got {x.shape[1]}")


def _check_contiguous(**tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def segment_min_rows(x: torch.Tensor) -> torch.Tensor:
    """Per-row minimum of a padded ``(rows, width)`` f32 matrix: ``(rows,)``."""
    _check_matrix(x)
    if is_cpu(x):
        return segment_min_rows_ref(x)
    _check_contiguous(x=x)
    rows, width = x.shape
    out = torch.empty((rows,), dtype=torch.float32, device=x.device)
    if rows:
        launch("segment_min_rows", x.device, x.data_ptr(), out.data_ptr(),
               rows, width)
        count_launch(segment_min_rows)
    return out


def segment_argmin_rows(x: torch.Tensor) -> torch.Tensor:
    """Per-row index of the first minimum, int32 ``(rows,)``."""
    _check_matrix(x)
    if is_cpu(x):
        return segment_argmin_rows_ref(x)
    _check_contiguous(x=x)
    rows, width = x.shape
    out = torch.empty((rows,), dtype=torch.int32, device=x.device)
    if rows:
        launch("segment_argmin_rows", x.device, x.data_ptr(), out.data_ptr(),
               rows, width)
        count_launch(segment_argmin_rows)
    return out


def min_argmin_1d(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global ``(min, first argmin)`` of a flat f32 vector, as 0-d tensors
    (f32, int32) on ``x``'s device: on a CUDA device no value reaches the
    host, so a loop of calls never synchronises."""
    if x.dtype != torch.float32 or x.dim() != 1 or x.shape[0] == 0:
        raise ValueError(
            f"expected a non-empty flat float32 vector, got {x.dtype} "
            f"{tuple(x.shape)}"
        )
    n = x.shape[0]
    if n > MAX_INT32_ELEMS:
        raise ValueError(
            f"min_argmin_1d int32 index capacity exceeded: {n} elements > "
            f"{MAX_INT32_ELEMS}"
        )
    if is_cpu(x):
        return min_argmin_1d_ref(x)
    _check_contiguous(x=x)
    parts = min(_MAX_PARTS, -(-n // _PER_PART))
    part_val = torch.empty((parts,), dtype=torch.float32, device=x.device)
    part_idx = torch.empty((parts,), dtype=torch.int32, device=x.device)
    val = torch.empty((), dtype=torch.float32, device=x.device)
    idx = torch.empty((), dtype=torch.int32, device=x.device)
    launch("segment_min_argmin_1d", x.device, x.data_ptr(), part_val.data_ptr(),
           part_idx.data_ptr(), val.data_ptr(), idx.data_ptr(), n, parts)
    count_launch(min_argmin_1d)
    return val, idx


def mp_reparent(
    pd: torch.Tensor,
    pdelta: torch.Tensor,
    pphi: torch.Tensor,
    vi: torch.Tensor,
    active: torch.Tensor,
    in_tree: torch.Tensor,
    l: torch.Tensor,
    d: torch.Tensor,
    p: torch.Tensor,
) -> None:
    """One MP step's in-tree re-parenting over the selected vertex's row.

    pd / pdelta / pphi : (nvp, width) int32 / f32 / f32 padded out-rows
                         (padding ids are ``nvp``)
    vi, active         : 0-d int32 selected vertex and 0-d bool step flag,
                         read where they lie (device memory on a card)
    in_tree            : (nvp + 2,) bool
    l, d, p            : (nvp + 2,) f32 / f32 / int32 loop state, updated in
                         place — the caller's own loop buffers
    """
    nvp, width = pd.shape
    if pd.dtype != torch.int32 or p.dtype != torch.int32 or vi.dtype != torch.int32:
        raise ValueError("pd, p and vi must be int32")
    if active.dtype != torch.bool or in_tree.dtype != torch.bool:
        raise ValueError("active and in_tree must be bool")
    if not all(t.dtype == torch.float32 for t in (pdelta, pphi, l, d)):
        raise ValueError("pdelta, pphi, l and d must be float32")
    if pdelta.shape != pd.shape or pphi.shape != pd.shape:
        raise ValueError("pd, pdelta and pphi must share one (nvp, width) shape")
    if vi.numel() != 1 or active.numel() != 1:
        raise ValueError("vi and active must be single elements")
    for name, t in (("in_tree", in_tree), ("l", l), ("d", d), ("p", p)):
        if tuple(t.shape) != (nvp + 2,):
            raise ValueError(f"{name} must have nvp + 2 = {nvp + 2} entries")
    if is_cpu(pd, pdelta, pphi, vi, active, in_tree, l, d, p):
        mp_reparent_ref(pd, pdelta, pphi, vi, active, in_tree, l, d, p)
        return
    _check_contiguous(pd=pd, pdelta=pdelta, pphi=pphi, in_tree=in_tree,
                      l=l, d=d, p=p)
    launch("segment_mp_reparent", pd.device, pd.data_ptr(), pdelta.data_ptr(),
           pphi.data_ptr(), vi.data_ptr(), active.data_ptr(),
           in_tree.data_ptr(), l.data_ptr(), d.data_ptr(), p.data_ptr(),
           nvp, width)
    count_launch(mp_reparent)


segment_min_rows.launches = 0
segment_argmin_rows.launches = 0
min_argmin_1d.launches = 0
mp_reparent.launches = 0
