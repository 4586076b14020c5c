"""h2o-danube-1.8b — llama+mistral mix with sliding-window attention. [arXiv:2401.16818]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    attn_type="swa",
    window=4096,              # mistral-style sliding window
    source="arXiv:2401.16818",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(num_layers=2, d_model=256, num_heads=8, num_kv_heads=2,
                          d_ff=512, vocab_size=512, window=64)
