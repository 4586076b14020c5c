"""yi-6b — llama-arch GQA dense. [arXiv:2403.04652]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    rope_theta=5_000_000.0,
    source="arXiv:2403.04652",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(num_layers=2, d_model=256, num_heads=8, num_kv_heads=2,
                          d_ff=512, vocab_size=512)
