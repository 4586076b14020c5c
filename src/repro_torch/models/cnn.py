"""The paper's MNIST 'Net' (§IV): conv1 -> pool -> conv2 -> dropout -> pool
-> fc1 -> fc2 (10/20 channels, 5x5 kernels, fc1 320->50), with the worker
dimension written out.

Params are a flat dict of PyTorch-layout tensors: conv weights OIHW, fc
weights (out, in), and fc1's 320 inputs in NCHW-flatten (C, H, W) order.
``repro_torch.convert`` maps them to and from the JAX package's layout
(HWIO, (in, out), NHWC-flatten rows).

W workers run as one batch: each leaf is stacked (W, ...); conv1 and conv2
are grouped convolutions (``groups=W``) over a (B, W·C, H, W) input, fc1
and fc2 are ``torch.baddbmm``. The parameters of different workers never
mix, so the gradient of the summed per-worker losses gives every worker
exactly its own gradient.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

Params = Dict[str, torch.Tensor]


def flat_features(cfg: ModelConfig) -> int:
    """fc1's input width: 28 -> conv5 -> 24 -> pool -> 12 -> conv5 -> 8 ->
    pool -> 4; 4·4·c2."""
    side = ((cfg.image_size - 4) // 2 - 4) // 2
    return side * side * cfg.cnn_channels[1]


def init_cnn(gen: torch.Generator, cfg: ModelConfig,
             device: torch.device) -> Params:
    """Normal(0, 1/fan_in) weights (the JAX package's ``dense_init``) and
    zero biases, drawn on the CPU from ``gen`` so that a seed gives the
    same weights on every device."""
    c1, c2 = cfg.cnn_channels
    flat = flat_features(cfg)

    def dense(shape, fan_in):
        return torch.randn(shape, generator=gen) / math.sqrt(fan_in)

    params = {
        "conv1.w": dense((c1, 1, 5, 5), 25),
        "conv1.b": torch.zeros(c1),
        "conv2.w": dense((c2, c1, 5, 5), 25 * c1),
        "conv2.b": torch.zeros(c2),
        "fc1.w": dense((cfg.d_model, flat), flat),
        "fc1.b": torch.zeros(cfg.d_model),
        "fc2.w": dense((cfg.num_classes, cfg.d_model), cfg.d_model),
        "fc2.b": torch.zeros(cfg.num_classes),
    }
    return {k: v.to(device) for k, v in sorted(params.items())}


def dropout_mask(gen: torch.Generator, W: int, B: int, cfg: ModelConfig,
                 device: torch.device) -> torch.Tensor:
    """conv2 feature-map dropout keep mask (W, B, c2), p = 0.5: one draw
    per worker, per sample and per channel, from ``gen`` (on ``device``)."""
    return torch.rand((W, B, cfg.cnn_channels[1]), generator=gen,
                      device=device) < 0.5


def _grouped_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                  ) -> torch.Tensor:
    """x (B, W·Cin, H, W'); w (W, Cout, Cin, k, k); b (W, Cout)."""
    W = w.shape[0]
    return F.conv2d(x, w.reshape((-1,) + tuple(w.shape[2:])), b.reshape(-1),
                    groups=W)


def cnn_forward(params_w: Params, cfg: ModelConfig, images: torch.Tensor,
                *, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """params_w leaves (W, ...); images (W, B, 28, 28, 1) NHWC, as the data
    pipeline makes them → logits (W, B, classes). ``mask`` (W, B, c2) is
    the conv2 dropout keep mask (kept maps scaled by 2), or None."""
    W, B = images.shape[:2]
    x = images.permute(1, 0, 4, 2, 3).reshape(B, -1, *images.shape[2:4])
    x = F.relu(F.max_pool2d(
        _grouped_conv(x, params_w["conv1.w"], params_w["conv1.b"]), 2))
    x = _grouped_conv(x, params_w["conv2.w"], params_w["conv2.b"])
    if mask is not None:
        keep = mask.permute(1, 0, 2).reshape(B, -1, 1, 1)
        x = torch.where(keep, x / 0.5, 0.0)
    x = F.relu(F.max_pool2d(x, 2))
    x = x.reshape(B, W, -1).transpose(0, 1)                  # (W, B, C·H·W)
    x = F.relu(torch.baddbmm(params_w["fc1.b"][:, None], x,
                             params_w["fc1.w"].transpose(1, 2)))
    return torch.baddbmm(params_w["fc2.b"][:, None], x,
                         params_w["fc2.w"].transpose(1, 2))
