"""Model API of the port — the CNN branch of ``repro.models.api``.

    init(cfg, gen, device)                     -> params (flat dict)
    loss_fn(cfg)(params_w, batch, mask=None)   -> (loss (W,), metrics)

Batches are dicts ``{images (W, B, 28, 28, 1), labels (W, B)}`` with the
worker dimension first; a single model is the W = 1 case (``stack``). The
LLM families wait for the zoo slice.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import cnn as CNN

Params = Dict[str, torch.Tensor]


def _cnn_only(cfg: ModelConfig) -> None:
    if cfg.family != "cnn":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (the port runs the "
            f"paper CNN only)")


def init(cfg: ModelConfig, gen: torch.Generator,
         device: torch.device) -> Params:
    _cnn_only(cfg)
    return CNN.init_cnn(gen, cfg, device)


def stack(params: Params, W: int = 1) -> Params:
    """Single-model params → (W, ...)-stacked params (a broadcast view)."""
    return {k: v[None].expand((W,) + tuple(v.shape))
            for k, v in params.items()}


def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-worker mean cross-entropy; labels == -100 are masked.
    logits (W, B, C), labels (W, B) → (W,) f32."""
    W = logits.shape[0]
    nll = F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                          labels.reshape(-1).long(), reduction="none",
                          ignore_index=-100).reshape(W, -1)
    count = (labels >= 0).sum(dim=1).clamp_min(1)
    return nll.sum(dim=1) / count


def loss_fn(cfg: ModelConfig):
    """Returns f(params_w, batch, mask=None) -> (loss (W,), metrics), every
    worker's loss on its own batch. ``mask`` is the conv2 dropout keep mask
    (``cnn.dropout_mask``); None evaluates without dropout."""
    _cnn_only(cfg)

    def f_cnn(params_w: Params, batch: Dict[str, torch.Tensor],
              mask: Optional[torch.Tensor] = None):
        logits = CNN.cnn_forward(params_w, cfg, batch["images"], mask=mask)
        labels = batch["labels"]
        loss = _xent(logits, labels)
        acc = (logits.argmax(-1) == labels).float().mean(dim=1)
        return loss, {"loss": loss, "accuracy": acc}
    return f_cnn


def param_count(params: Params) -> int:
    return sum(x.numel() for x in params.values())
