"""Architecture registry: resolve an architecture by name (``repro``'s
``configs/registry.py``)."""
from __future__ import annotations

from repro_torch.configs.base import (ModelConfig, SHAPES, ShapeConfig,  # noqa: F401
                                      SUBQUADRATIC, shape_applicable)
from repro_torch.configs import (starcoder2_15b, gemma_2b, llama3_2_3b,
                                 minitron_8b, jamba_1_5_large, mamba2_780m,
                                 qwen2_moe_a2_7b, qwen3_moe_235b,
                                 whisper_medium, llama3_2_vision_11b)

_MODULES = {
    "starcoder2-15b": starcoder2_15b,
    "gemma-2b": gemma_2b,
    "llama3.2-3b": llama3_2_3b,
    "minitron-8b": minitron_8b,
    "jamba-1.5-large-398b": jamba_1_5_large,
    "mamba2-780m": mamba2_780m,
    "qwen2-moe-a2.7b": qwen2_moe_a2_7b,
    "qwen3-moe-235b-a22b": qwen3_moe_235b,
    "whisper-medium": whisper_medium,
    "llama-3.2-vision-11b": llama3_2_vision_11b,
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    return _MODULES[name].REDUCED if reduced else _MODULES[name].FULL


def cells():
    """All applicable (arch, shape) dry-run cells."""
    out = []
    for name in ARCH_NAMES:
        cfg = get_config(name)
        for shape in SHAPES.values():
            if shape_applicable(cfg, shape):
                out.append((name, shape.name))
    return out
