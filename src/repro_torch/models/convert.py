"""Carry model parameters between the JAX package's tree and the port's.

Both packages keep the same tree (dicts and lists, leaves of the same
shapes and dtypes).  The JAX package's side arrives as numpy arrays
(``jax.tree.map(np.asarray, params)``), with bfloat16 as ml_dtypes' dtype;
:mod:`repro_torch.store.convert` moves each leaf through a ``uint16`` view,
so the port needs ml_dtypes only to hand bf16 back.  With these, the tests
run both packages on the same weights.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..store.convert import tensor_from_numpy, tensor_to_numpy


def _map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def params_from_numpy(tree: Any, device="cuda") -> Any:
    """The port's tree, on ``device``, from a tree of numpy arrays."""
    return _map(lambda a: tensor_from_numpy(np.asarray(a)).to(device), tree)


def params_to_numpy(tree: Any) -> Any:
    """A tree of numpy arrays (bf16 as ml_dtypes') from the port's tree."""
    return _map(tensor_to_numpy, tree)
