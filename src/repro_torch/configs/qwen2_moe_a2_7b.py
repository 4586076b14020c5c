"""qwen2-moe-a2.7b — 4 shared + 60 routed top-4 MoE. [hf:Qwen/Qwen1.5-MoE-A2.7B]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,                # routed-expert hidden dim (per assignment)
    vocab_size=151936,
    moe=MoEConfig(num_experts=60, top_k=4, d_ff_expert=1408,
                  num_shared_experts=4, d_ff_shared=1408),
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=4, d_ff=128,
        vocab_size=512,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128,
                      num_shared_experts=1, d_ff_shared=128),
    )
