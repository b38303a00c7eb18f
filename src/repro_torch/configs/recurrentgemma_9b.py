"""RecurrentGemma-9B (Griffin) — RG-LRU + local attention 1:2, window 2048.
[arXiv:2402.19427; unverified]

Sub-quadratic: supports the long_500k cell (decode state = RG-LRU state +
a 2048-token local-attention window cache).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab=256000,
    layer_pattern=("rglru", "rglru", "attn"),
    lru_width=4096,
    attn_window=2048,
    mlp_kind="gelu",
    supported_shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)
