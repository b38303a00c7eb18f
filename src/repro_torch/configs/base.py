"""Architecture config schema + the four assigned input shapes.

One :class:`ModelConfig` drives every family (dense / MoE / MLA / hybrid /
SSM / enc-dec / VLM backbone); ``layer_pattern`` describes the per-layer
block sequence (e.g. RecurrentGemma's (rglru, rglru, attn) triples).  Every
field mirrors the published configuration cited in the arch file.

``reduced()`` returns the same family at smoke-test scale: the per-arch CPU
tests instantiate *that*; the full configs run on the card.  A copy of the
JAX package's configs, so that ``--arch`` resolves the same names.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


# the assigned LM shape set (seq_len × global_batch)
SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None    # default d_model // n_heads
    # block sequence, tiled to n_layers. entries: attn|mla|rglru|rwkv
    layer_pattern: Tuple[str, ...] = ("attn",)
    mlp_kind: str = "swiglu"          # swiglu | gelu
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    # --- MoE ----------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    n_dense_layers: int = 0           # leading dense layers (deepseek: 3)
    capacity_factor: float = 1.25
    moe_impl: str = "dispatch"        # dispatch (pjit scatter) | ep (shard_map all_to_all)
    # --- MLA (deepseek) -------------------------------------------------------
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_head_dim: int = 0
    qk_nope_head_dim: int = 0
    v_head_dim: int = 0
    mla_compressed_cache: bool = False   # perf variant: cache the c_kv latent
    mtp: bool = False                    # multi-token-prediction aux head
    # --- recurrent (RG-LRU / RWKV6) -------------------------------------------
    lru_width: int = 0
    conv_width: int = 4
    attn_window: int = 0              # sliding window for local attention
    rwkv_head_dim: int = 64
    rwkv_decay_lora: int = 64
    rwkv_shift_lora: int = 32
    rwkv_impl: str = "scan"           # scan (baseline) | chunked (perf variant)
    # --- enc-dec ---------------------------------------------------------------
    enc_layers: int = 0               # >0 => encoder-decoder
    frontend: str = "none"            # none | audio_stub | vq_stub
    # --- which assigned shapes apply (long_500k only for sub-quadratic) --------
    supported_shapes: Tuple[str, ...] = ("train_4k", "prefill_32k", "decode_32k")

    # ------------------------------------------------------------------ utils
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 512 so embedding/head shard
        evenly on a 16-way model axis (standard framework practice; padded
        rows are zero-init and never targeted by the loss)."""
        return -(-self.vocab // 512) * 512

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    def blocks(self) -> List[str]:
        """Per-layer block kinds, length n_layers."""
        out: List[str] = []
        i = 0
        while len(out) < self.n_layers:
            kind = self.layer_pattern[i % len(self.layer_pattern)]
            if self.n_experts and kind == "attn_moe_pair":
                pass
            out.append(kind)
            i += 1
        return out[: self.n_layers]

    def layer_uses_moe(self, layer_idx: int) -> bool:
        return bool(self.n_experts) and layer_idx >= self.n_dense_layers

    def param_count(self) -> int:
        """Approximate total parameters (used for roofline MODEL_FLOPS)."""
        from ..models.registry import count_params  # local import, no cycle

        return count_params(self)

    def active_param_count(self) -> int:
        from ..models.registry import count_params

        return count_params(self, active_only=True)

    def reduced(self) -> "ModelConfig":
        """Same family at smoke scale."""
        shrink = {
            "n_layers": min(self.n_layers, 4 if len(self.layer_pattern) < 3 else 6),
            "d_model": 128,
            "n_heads": 4,
            "n_kv_heads": min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            "head_dim": 32,
            "d_ff": 256,
            "vocab": 512,
            "enc_layers": min(self.enc_layers, 2) if self.enc_layers else 0,
        }
        if self.n_experts:
            shrink.update(
                n_experts=4, top_k=min(self.top_k, 2), expert_d_ff=64,
                n_shared_experts=min(self.n_shared_experts, 1),
                n_dense_layers=min(self.n_dense_layers, 1),
                # drop-free capacity (cf = E/K) so prefill/decode and teacher
                # forcing agree exactly; production keeps the paper's 1.25
                capacity_factor=4 / min(self.top_k, 2),
            )
        if self.q_lora_rank:
            shrink.update(
                q_lora_rank=64, kv_lora_rank=32, qk_rope_head_dim=16,
                qk_nope_head_dim=32, v_head_dim=32,
            )
        if self.lru_width:
            shrink.update(lru_width=128, attn_window=32)
        if self.family == "ssm":
            shrink.update(rwkv_head_dim=32, rwkv_decay_lora=16, rwkv_shift_lora=8)
        if self.attn_window and not self.lru_width:
            shrink.update(attn_window=32)
        return dataclasses.replace(self, name=self.name + "-smoke", **shrink)
