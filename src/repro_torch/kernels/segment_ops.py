"""Segment min / argmin over padded rows, and the Prim / Modified-Prim loops.

The device solver backend (:mod:`repro_torch.core.solvers.torch_backend`)
lays the version graph's CSR rows out as dense ``(rows, width)`` f32
matrices padded with ``+inf``; the reductions over that layout are the
solvers' inner loops:

* :func:`segment_min_rows`    — per-row minimum (the Bellman-Ford relaxation);
* :func:`segment_argmin_rows` — per-row first-minimum index, int32;
* :func:`min_argmin_1d`       — global ``(min, first argmin)`` of a flat
  vector as device scalars (the ρ-argmax of LMG);
* :func:`prim_loop`, :func:`mp_loop` — the whole Prim / Modified-Prim step
  loop (vertex selection, re-parenting, relaxation) in one launch, in place
  on the solver's own loop buffers.

The first three replace ``_row_call`` (``pl.pallas_call``) of the JAX
package's ``src/repro/kernels/segment_ops.py`` as reached from its
``segment_min_rows``, ``segment_argmin_rows`` and ``min_argmin_1d``; the
loops are the ``fori_loop`` s of its ``core/solvers/jax_backend.py``
``_prim_jit`` and ``_mp_jit``, whose selection is that ``min_argmin_1d``.
The CUDA kernels are in ``csrc/segment_kernels.cu``, where their bound and
design are noted: the row reductions are one template with a min and an
argmin body, and ``min_argmin_1d`` is one launch a call.  NaN is the minimum
and propagates, ties go to the first index, and an all-``+inf`` input gives
``(+inf, 0)``, as with XLA's reductions; the min orders ``-0.0`` below
``+0.0`` as XLA's does, the argmin holds them equal, and ``min_argmin_1d``
returns ``x[i]`` for the first argmin ``i``, as the JAX package's XLA form.
Rows and vectors may be any contiguous view: the kernels take 16-byte loads
where the width and the address allow, 4-byte loads elsewhere.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

import torch

from . import count_launch, is_cpu, launch
from .ref import (
    min_argmin_1d_ref,
    mp_loop_ref,
    prim_loop_ref,
    segment_argmin_rows_ref,
    segment_min_rows_ref,
)

LANE = 128  # the JAX form's row width for 1d reductions (TPU lane width)

# largest flat vector min_argmin_1d can index with int32 math (the JAX form's
# padded length r * LANE + col must not wrap); refused before any launch
MAX_INT32_ELEMS = (1 << 31) - 1 - LANE

#: bytes of min_argmin_1d's workspace: a ticket, then one 12-byte part a
#: block (the kernel caps its grid at what this holds, far above the card's
#: resident blocks)
WORKSPACE_BYTES = 1 << 16
_workspaces: Dict[Tuple[int, int], torch.Tensor] = {}
_workspace_lock = threading.Lock()

LOOP_CHUNK = 256          # keys per chunk of the loops' selection, at least
MAX_LOOP_CHUNKS = 2048    # chunk minima the loop kernels hold (kMaxChunks)


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
    ws = _workspace(x.device)
    val = torch.empty((), dtype=torch.float32, device=x.device)
    idx = torch.empty((), dtype=torch.int32, device=x.device)
    launch("segment_min_argmin_1d", x.device, x.data_ptr(), val.data_ptr(),
           idx.data_ptr(), ws.data_ptr(), n, ws.numel())
    count_launch(min_argmin_1d)
    return val, idx


def _workspace(device: torch.device) -> torch.Tensor:
    """min_argmin_1d's workspace on ``device``'s current stream: made and
    zeroed on that stream at its first call there, then kept.  The kernel
    leaves its ticket at 0, so no later call sets memory; calls on one stream
    run in order, and two streams never share a ticket."""
    stream = torch.cuda.current_stream(device)
    key = (device.index, stream.cuda_stream)
    with _workspace_lock:
        ws = _workspaces.get(key)
        if ws is None:
            ws = torch.zeros(WORKSPACE_BYTES, dtype=torch.uint8, device=device)
            _workspaces[key] = ws
    return ws


def loop_chunk(nvp: int) -> int:
    """Keys per chunk of the step loops' selection: 256, or more where that
    would give more chunks than the kernels hold in shared memory (2,048:
    ``kMaxChunks``), so that every row count the padded layouts admit
    (up to 2**22) is taken."""
    return max(LOOP_CHUNK, -(-nvp // MAX_LOOP_CHUNKS))


def _check_loop(pd: torch.Tensor, costs, state: dict, steps: int) -> None:
    if pd.dtype != torch.int32 or pd.dim() != 2 or pd.numel() == 0:
        raise ValueError(f"pd must be a non-empty (nvp, width) int32 matrix, got "
                         f"{pd.dtype} {tuple(pd.shape)}")
    nvp = pd.shape[0]
    for name, t in costs.items():
        if t.dtype != torch.float32 or t.shape != pd.shape:
            raise ValueError(f"{name} must be float32 of pd's shape {tuple(pd.shape)}")
    for name, (t, dtype) in state.items():
        if t.dtype != dtype or tuple(t.shape) != (nvp + 2,):
            raise ValueError(f"{name} must be {dtype} of nvp + 2 = {nvp + 2} entries, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")


def prim_loop(
    pd: torch.Tensor,
    pw: torch.Tensor,
    best: torch.Tensor,
    bp: torch.Tensor,
    in_tree: torch.Tensor,
    steps: int,
) -> None:
    """Prim's ``steps`` steps over the padded out-rows, in one launch.

    pd, pw        : (nvp, width) int32 ids (padding ``nvp``) / f32 weights
                    (padding +inf) of the undirected instance's out-rows
    best, bp      : (nvp + 2,) f32 / int32 key and parent of each vertex
    in_tree       : (nvp + 2,) bool
    best, bp and in_tree are the caller's loop state, updated in place (the
    root's row already relaxed, as before step 0).
    """
    _check_loop(pd, {"pw": pw}, {"best": (best, torch.float32),
                                 "bp": (bp, torch.int32),
                                 "in_tree": (in_tree, torch.bool)}, steps)
    if is_cpu(pd, pw, best, bp, in_tree):
        prim_loop_ref(pd, pw, best, bp, in_tree, steps)
        return
    _check_contiguous(pd=pd, pw=pw, best=best, bp=bp, in_tree=in_tree)
    nvp, width = pd.shape
    launch("segment_prim_loop", pd.device, pd.data_ptr(), pw.data_ptr(),
           best.data_ptr(), bp.data_ptr(), in_tree.data_ptr(), nvp, width,
           steps, loop_chunk(nvp))
    count_launch(prim_loop)


def mp_loop(
    pd: torch.Tensor,
    pdelta: torch.Tensor,
    pphi: torch.Tensor,
    bound: torch.Tensor,
    l: torch.Tensor,
    d: torch.Tensor,
    p: torch.Tensor,
    in_tree: torch.Tensor,
    steps: int,
) -> None:
    """Modified Prim's ``steps`` steps over the padded out-rows, in one
    launch.

    pd, pdelta, pphi : (nvp, width) int32 ids (padding ``nvp``) / f32 Δ / f32
                       Φ (padding +inf) of the out-rows
    bound            : 0-d f32, θ + CONSTRAINT_TOL as an f32 add, read where
                       it lies (device memory on a card)
    l, d, p, in_tree : (nvp + 2,) f32 / f32 / int32 / bool loop state, updated
                       in place (the root's row already relaxed)
    """
    _check_loop(pd, {"pdelta": pdelta, "pphi": pphi},
                {"l": (l, torch.float32), "d": (d, torch.float32),
                 "p": (p, torch.int32), "in_tree": (in_tree, torch.bool)}, steps)
    if bound.dtype != torch.float32 or bound.numel() != 1:
        raise ValueError("bound must be a single float32 element")
    if is_cpu(pd, pdelta, pphi, bound, l, d, p, in_tree):
        mp_loop_ref(pd, pdelta, pphi, bound, l, d, p, in_tree, steps)
        return
    _check_contiguous(pd=pd, pdelta=pdelta, pphi=pphi, l=l, d=d, p=p,
                      in_tree=in_tree)
    nvp, width = pd.shape
    # the chain walk's marks: a step stamps its vertices with its own number
    mark = torch.zeros((nvp + 2,), dtype=torch.int32, device=pd.device)
    launch("segment_mp_loop", pd.device, pd.data_ptr(), pdelta.data_ptr(),
           pphi.data_ptr(), bound.data_ptr(), l.data_ptr(), d.data_ptr(),
           p.data_ptr(), in_tree.data_ptr(), mark.data_ptr(), nvp, width,
           steps, loop_chunk(nvp))
    count_launch(mp_loop)


segment_min_rows.launches = 0
segment_argmin_rows.launches = 0
min_argmin_1d.launches = 0
prim_loop.launches = 0
mp_loop.launches = 0
