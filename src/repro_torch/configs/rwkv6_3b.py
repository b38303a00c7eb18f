"""RWKV-6 (Finch) 3B — attention-free, token-shift + data-dependent decay.
[arXiv:2404.05892; hf]

Sub-quadratic (O(1) decode state): supports the long_500k cell.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,              # d_model / rwkv_head_dim
    n_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab=65536,
    layer_pattern=("rwkv",),
    rwkv_head_dim=64,
    rwkv_decay_lora=64,
    rwkv_shift_lora=32,
    mlp_kind="rwkv_ffn",
    supported_shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)
