"""SeamlessM4T-medium — enc-dec backbone (12L + 12L), multimodal frontends
stubbed per spec (input_specs provides precomputed frame embeddings).
[arXiv:2308.11596; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,            # decoder layers
    enc_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab=256206,
    mlp_kind="gelu",
    frontend="audio_stub",
)
