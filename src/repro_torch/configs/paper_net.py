"""The paper's own model: MNIST 'Net' — conv1, conv2, conv2_drop, fc1, fc2.

Matches §IV of the paper (the architecture printed as a TorchScript module)
and its hyperparameters: SGD(lr=0.01, momentum=0.5, dampening=0, wd=0,
nesterov=False). Used by the paper-faithful reproduction path.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paper-net",
    family="cnn",
    num_layers=2,             # conv layers
    d_model=50,               # fc1 hidden width (LeNet-style Net uses 50)
    num_heads=1,
    num_kv_heads=1,
    d_ff=0,
    vocab_size=0,
    image_size=28,
    num_classes=10,
    cnn_channels=(10, 20),
    dtype="float32",
    source="DOI 10.1109/UEMCON59035.2023.10316006 §IV",
)


def smoke_config() -> ModelConfig:
    return CONFIG
