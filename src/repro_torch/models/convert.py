"""Carry model parameters, or a whole train state, between the JAX
package's tree and the port's.

Both packages keep the same tree (dicts and lists, leaves of the same
shapes and dtypes); a train state is ``{"params", "opt": {"mu", "nu",
"step"}, "error_fb"}``, ``error_fb`` None until gradient compression makes
one.  The JAX package's side arrives as numpy arrays
(``jax.tree.map(np.asarray, params)``), with bfloat16 as ml_dtypes' dtype;
:mod:`repro_torch.store.convert` moves each leaf through a ``uint16`` view,
so the port needs ml_dtypes only to hand bf16 back.  With these, the tests
run both packages on the same weights.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ..store.convert import tensor_from_numpy, tensor_to_numpy
from ..tree import tree_map


def params_from_numpy(tree: Any, device="cuda") -> Any:
    """The port's tree, on ``device``, from a tree of numpy arrays."""
    return tree_map(lambda a: tensor_from_numpy(np.asarray(a)).to(device), tree)


def params_to_numpy(tree: Any) -> Any:
    """A tree of numpy arrays (bf16 as ml_dtypes') from the port's tree."""
    return tree_map(tensor_to_numpy, tree)


STATE_KEYS = ("params", "opt", "error_fb")


def train_state_from_numpy(state: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """The port's train state, on ``device``, from a tree of numpy arrays.
    The leaves are copies: the train step updates them in place."""
    return params_from_numpy({k: tree_map(np.array, state.get(k)) for k in STATE_KEYS}, device)


def train_state_to_numpy(state: Dict[str, Any]) -> Dict[str, Any]:
    """A tree of numpy arrays (bf16 as ml_dtypes') from the port's state."""
    return params_to_numpy({k: state.get(k) for k in STATE_KEYS})
