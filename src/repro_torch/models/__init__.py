"""LMs in PyTorch: a copy of ``repro.models`` for the attention
families (dense GQA, MoE, DeepSeek's MLA and MTP head), the recurrent
families and the encoder-decoder family, with the JAX package's parameter
trees."""

from .registry import ModelBundle, count_params, get_model

__all__ = ["get_model", "ModelBundle", "count_params"]
