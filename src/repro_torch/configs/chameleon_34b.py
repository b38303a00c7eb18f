"""Chameleon-34B — early-fusion VLM backbone, unified text+VQ vocab, qk-norm.
VQ image tokenizer is a stub frontend per spec (tokens arrive pre-quantized).
[arXiv:2405.09818; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab=65536,
    qk_norm=True,
    mlp_kind="swiglu",
    frontend="vq_stub",
)
