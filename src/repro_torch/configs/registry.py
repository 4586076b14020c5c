"""--arch <id> registry of the port: the archs ported so far, the paper's
own CNN, the dense decoders h2o-danube-1.8b (sliding window), smollm-135m
(tied embeddings), yi-6b (GQA, RoPE theta 5e6) and minicpm3-4b
(Multi-head Latent Attention), the MoE decoders qwen2-moe-a2.7b (60
routed experts top-4 and 4 shared ones) and olmoe-1b-7b (64 experts
top-8), zamba2-7b (the Mamba2 + shared-attention hybrid), xlstm-1.3b (the
ssm family: mLSTM and sLSTM blocks) and whisper-base (the audio
encoder-decoder). chameleon-34b (the vlm family) of
``repro.configs.registry`` waits for its slice."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES = {
    "h2o-danube-1.8b":  "repro_torch.configs.h2o_danube_1_8b",
    "minicpm3-4b":      "repro_torch.configs.minicpm3_4b",
    "olmoe-1b-7b":      "repro_torch.configs.olmoe_1b_7b",
    "paper-net":        "repro_torch.configs.paper_net",
    "qwen2-moe-a2.7b":  "repro_torch.configs.qwen2_moe_a2_7b",
    "smollm-135m":      "repro_torch.configs.smollm_135m",
    "whisper-base":     "repro_torch.configs.whisper_base",
    "xlstm-1.3b":       "repro_torch.configs.xlstm_1_3b",
    "yi-6b":            "repro_torch.configs.yi_6b",
    "zamba2-7b":        "repro_torch.configs.zamba2_7b",
}

def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch])


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


# the LLM archs ``launch.serve`` runs: every ported arch but the CNN family
ARCH_IDS = [a for a in _ARCH_MODULES if get_config(a).family != "cnn"]
