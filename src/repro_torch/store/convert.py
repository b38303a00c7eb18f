"""Dtypes and conversions between the port's FlatTrees and the JAX package's.

The port's FlatTree maps leaf paths to CPU ``torch.Tensor``\\ s; the JAX
package's maps them to numpy arrays, with bfloat16 as ml_dtypes' numpy
dtype.  On the wire both name a dtype by numpy's ``dtype.str`` (``'<f4'``,
``'|b1'``, ...) or ``"bfloat16"``; :func:`wire_dtype` / :func:`torch_dtype`
hold that table, and dtypes outside it are refused.

:func:`flat_from_numpy` and :func:`flat_to_numpy` move a FlatTree between
the two packages, so both compute on the same data.  ml_dtypes' bfloat16 is
recognised by ``dtype.name`` and moved through a ``uint16`` view, so the
port itself never needs ml_dtypes.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_WIRE_OF_TORCH = {
    torch.bool: "|b1",
    torch.uint8: "|u1",
    torch.int8: "|i1",
    torch.int16: "<i2",
    torch.uint16: "<u2",
    torch.int32: "<i4",
    torch.uint32: "<u4",
    torch.int64: "<i8",
    torch.uint64: "<u8",
    torch.float16: "<f2",
    torch.float32: "<f4",
    torch.float64: "<f8",
    torch.complex64: "<c8",
    torch.complex128: "<c16",
    torch.bfloat16: "bfloat16",
}
_TORCH_OF_WIRE = {w: t for t, w in _WIRE_OF_TORCH.items()}


def wire_dtype(dtype: torch.dtype) -> str:
    """The wire name of a tensor dtype (numpy's ``dtype.str``, or
    ``"bfloat16"``)."""
    try:
        return _WIRE_OF_TORCH[dtype]
    except KeyError:
        raise TypeError(
            f"unsupported leaf dtype {dtype}; the store holds "
            f"{sorted(str(d) for d in _WIRE_OF_TORCH)}"
        ) from None


def torch_dtype(wire: str) -> torch.dtype:
    """Inverse of :func:`wire_dtype`."""
    try:
        return _TORCH_OF_WIRE[wire]
    except KeyError:
        raise TypeError(
            f"unsupported wire dtype {wire!r}; the store holds "
            f"{sorted(_TORCH_OF_WIRE)}"
        ) from None


def tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor with ``a``'s dtype, shape and bytes.  Shares ``a``'s
    memory when ``a`` is contiguous and writable."""
    a = np.asarray(a)
    # a copy where torch.from_numpy cannot share: it needs C order, and it
    # warns on read-only arrays (the JAX package freezes its checkouts),
    # since a tensor over them would still be writable
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = a.copy(order="C")
    if a.dtype.name == "bfloat16":  # ml_dtypes
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    torch_dtype(a.dtype.str)  # refuse what the wire cannot name
    return torch.from_numpy(a)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A numpy array with ``t``'s dtype, shape and bytes (bfloat16 as
    ml_dtypes' dtype, imported only when a bfloat16 leaf needs it)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    wire_dtype(t.dtype)
    return t.numpy()


def flat_from_numpy(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """A JAX-package FlatTree as the port's FlatTree (same key order)."""
    return {k: tensor_from_numpy(v) for k, v in flat.items()}


def flat_to_numpy(flat: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The port's FlatTree as a JAX-package FlatTree (same key order)."""
    return {k: tensor_to_numpy(v) for k, v in flat.items()}
