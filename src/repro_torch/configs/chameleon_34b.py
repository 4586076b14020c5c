"""chameleon-34b — early-fusion VLM, VQ image tokens. [arXiv:2405.09818]

The vision side is the spec'd stub: ``input_specs`` provides precomputed
VQ patch-token *embeddings* which are early-fused (concatenated) into the
text token stream; the language decoder below is the real implementation.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    num_patch_tokens=256,     # stub VQ frontend: 256 patch embeddings per sample
    source="arXiv:2405.09818",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(num_layers=2, d_model=256, num_heads=8, num_kv_heads=2,
                          d_ff=512, vocab_size=512, num_patch_tokens=16)
