"""Dense decoder LMs in PyTorch: a copy of ``repro.models`` for the
all-attention families, with the JAX package's parameter tree."""

from .registry import ModelBundle, count_params, get_model

__all__ = ["get_model", "ModelBundle", "count_params"]
