"""Assigned architecture registry: --arch <id> resolves here."""

from .base import SHAPES, ModelConfig, ShapeSpec
from .chameleon_34b import CONFIG as chameleon_34b
from .deepseek_v3 import CONFIG as deepseek_v3_671b
from .minicpm_2b import CONFIG as minicpm_2b
from .minitron_4b import CONFIG as minitron_4b
from .phi35_moe import CONFIG as phi35_moe
from .qwen3_32b import CONFIG as qwen3_32b
from .recurrentgemma_9b import CONFIG as recurrentgemma_9b
from .rwkv6_3b import CONFIG as rwkv6_3b
from .seamless_m4t_medium import CONFIG as seamless_m4t_medium
from .starcoder2_7b import CONFIG as starcoder2_7b

ARCHS = {
    c.name: c
    for c in [
        qwen3_32b,
        starcoder2_7b,
        minitron_4b,
        minicpm_2b,
        phi35_moe,
        deepseek_v3_671b,
        seamless_m4t_medium,
        recurrentgemma_9b,
        chameleon_34b,
        rwkv6_3b,
    ]
}

__all__ = ["ARCHS", "SHAPES", "ModelConfig", "ShapeSpec"]
