"""--arch <id> registry: maps arch ids to config modules."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, INPUT_SHAPES, ShapeConfig

_ARCH_MODULES = {
    "zamba2-7b":        "repro_torch.configs.zamba2_7b",
    "smollm-135m":      "repro_torch.configs.smollm_135m",
    "chameleon-34b":    "repro_torch.configs.chameleon_34b",
    "whisper-base":     "repro_torch.configs.whisper_base",
    "xlstm-1.3b":       "repro_torch.configs.xlstm_1_3b",
    "qwen2-moe-a2.7b":  "repro_torch.configs.qwen2_moe_a2_7b",
    "olmoe-1b-7b":      "repro_torch.configs.olmoe_1b_7b",
    "yi-6b":            "repro_torch.configs.yi_6b",
    "minicpm3-4b":      "repro_torch.configs.minicpm3_4b",
    "h2o-danube-1.8b":  "repro_torch.configs.h2o_danube_1_8b",
    "paper-net":        "repro_torch.configs.paper_net",
}

ARCH_IDS = [a for a in _ARCH_MODULES if a != "paper-net"]


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch]).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch]).smoke_config()


def get_shape(shape: str) -> ShapeConfig:
    return INPUT_SHAPES[shape]


def applicable(arch: str, shape: str) -> tuple[bool, str]:
    """Whether (arch, shape) is exercised; reason when skipped (DESIGN.md §5)."""
    cfg = get_config(arch)
    sh = get_shape(shape)
    if shape == "long_500k" and not cfg.supports_long_context:
        return False, "full-attention arch: 524k decode requires sub-quadratic attention (skip per spec)"
    if sh.kind == "decode" and cfg.family == "cnn":
        return False, "cnn classifier has no decode step"
    return True, ""
