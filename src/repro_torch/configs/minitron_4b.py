"""Minitron-4B — pruned Nemotron, GQA(kv=8). [arXiv:2407.14679; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab=256000,
    mlp_kind="swiglu",
)
