"""DeepSeek-V3 (671B total) — MLA, 1 shared + 256 routed experts top-8,
3 leading dense layers, MTP. [arXiv:2412.19437; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,             # dense-layer ff width
    vocab=129280,
    n_experts=256,
    n_shared_experts=1,
    top_k=8,
    expert_d_ff=2048,
    n_dense_layers=3,
    layer_pattern=("mla",),
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_rope_head_dim=64,
    qk_nope_head_dim=128,
    v_head_dim=128,
    mtp=True,
    mlp_kind="swiglu",
)
