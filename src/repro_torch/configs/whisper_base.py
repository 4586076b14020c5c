"""whisper-base — enc-dec audio, conv frontend stubbed. [arXiv:2212.04356]

The mel-spectrogram + conv feature extractor is the spec'd stub:
``input_specs`` provides precomputed frame embeddings (encoder_seq, d_model).
Encoder + decoder transformers are real.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,             # decoder layers
    encoder_layers=6,
    encoder_seq=1500,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    source="arXiv:2212.04356",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(num_layers=2, encoder_layers=2, encoder_seq=64,
                          d_model=256, num_heads=4, num_kv_heads=4,
                          d_ff=512, vocab_size=512)
