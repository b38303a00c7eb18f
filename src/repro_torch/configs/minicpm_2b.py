"""MiniCPM-2B — llama-like, trained with the WSD schedule. [arXiv:2404.06395; hf]

The WSD (warmup-stable-decay) schedule itself lives in
``repro.training.optimizer``; arch-wise this is a dense GQA transformer
(kv=36 == MHA), tied embeddings.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab=122753,
    mlp_kind="swiglu",
    tie_embeddings=True,
)
