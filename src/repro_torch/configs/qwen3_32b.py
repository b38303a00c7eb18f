"""Qwen3-32B — dense, GQA(kv=8), qk-norm. [hf:Qwen/Qwen3-32B family; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab=151936,
    qk_norm=True,
    rope_theta=1e6,
    mlp_kind="swiglu",
)
