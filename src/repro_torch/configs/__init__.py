"""Architecture registry: one module per assigned architecture."""

import importlib

_ARCH_MODULES = [
    "qwen3_0_6b",
    "granite_20b",
    "deepseek_7b",
    "llama3_2_1b",
    "qwen2_moe_a2_7b",
    "deepseek_v3_671b",
    "falcon_mamba_7b",
    "zamba2_1_2b",
    "seamless_m4t_large_v2",
    "qwen2_vl_72b",
]

_loaded = False


def _load_all():
    global _loaded
    if _loaded:
        return
    _loaded = True
    for mod in _ARCH_MODULES:
        importlib.import_module(f".{mod}", __name__)


from .base import (  # noqa: E402
    SHAPES,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    ShapeConfig,
    SSMConfig,
    get_config,
    list_configs,
)

__all__ = [
    "SHAPES",
    "MLAConfig",
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "ShapeConfig",
    "get_config",
    "list_configs",
]
