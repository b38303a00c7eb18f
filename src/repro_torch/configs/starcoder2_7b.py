"""StarCoder2-7B — dense, GQA(kv=4), RoPE, GELU MLP. [arXiv:2402.19173; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab=49152,
    mlp_kind="gelu",
    rope_theta=1e5,
)
