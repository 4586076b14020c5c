"""xlstm-1.3b — sLSTM + mLSTM blocks. [arXiv:2405.04517]

d_ff=0 per the assignment: xLSTM blocks carry their own up/down projections
(pre-up-projection mLSTM, post-up-projection sLSTM) instead of a separate MLP.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    ssm=SSMConfig(state_dim=512, conv_width=4, expand=2, num_ssm_heads=4,
                  chunk_size=256),   # Q=1024 (=sqrt(dk*dv)) tried in §Perf
                                     # H9: no peak-memory win — refuted
    slstm_every=8,            # every 8th block is sLSTM, rest mLSTM (≈7:1 mix)
    source="arXiv:2405.04517",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=4, vocab_size=512,
        ssm=SSMConfig(state_dim=64, conv_width=4, expand=2, num_ssm_heads=4,
                      chunk_size=64),
        slstm_every=2,
    )
