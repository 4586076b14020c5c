"""zamba2-7b — Mamba2 backbone + shared attention blocks. [arXiv:2411.15242]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    ssm=SSMConfig(state_dim=64, conv_width=4, expand=2, chunk_size=128),
    shared_attn_every=6,      # one *shared* attention+MLP block, applied every 6th layer
    source="arXiv:2411.15242",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=4, d_ff=512,
        vocab_size=512, ssm=SSMConfig(state_dim=16, conv_width=4, expand=2, chunk_size=64),
        shared_attn_every=2,
    )
