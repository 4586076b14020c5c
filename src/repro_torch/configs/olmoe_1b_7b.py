"""olmoe-1b-7b — 64 experts top-8 MoE. [arXiv:2409.02060]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1024,                # per-expert hidden dim
    vocab_size=50304,
    moe=MoEConfig(num_experts=64, top_k=8, d_ff_expert=1024),
    source="arXiv:2409.02060",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=4, d_ff=128,
        vocab_size=512,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128),
    )
