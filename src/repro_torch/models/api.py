"""Model API of the port — the CNN, dense-decoder and hybrid branches of
``repro.models.api``.

    init(cfg, gen, device)                     -> params (flat dict)
    loss_fn(cfg)(params_w, batch, mask=None)   -> (loss (W,), metrics)  [cnn]
    forward(params, cfg, batch)                -> (logits, aux) [dense, hybrid]
    prefill(params, cfg, batch, cache_len)     -> (last_logits, cache)
    cache_shape(cfg, batch, seq), make_cache(cfg, batch, seq, device)
    decode_step(params, cfg, cache, tokens, cur_index) -> (logits, cache)

CNN batches are dicts ``{images (W, B, 28, 28, 1), labels (W, B)}`` with
the worker dimension first; a single model is the W = 1 case (``stack``).
Decoder batches are ``{tokens (B, S)}``. The dense family runs through
``transformer``, the hybrid (zamba2) through ``hybrid``; the other LLM
families wait for their slices (``transformer.check_ported`` raises).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import cnn as CNN
from repro_torch.models import hybrid as HY
from repro_torch.models import transformer as TF

Params = Dict[str, torch.Tensor]


def _cnn_only(cfg: ModelConfig) -> None:
    if cfg.family != "cnn":
        raise NotImplementedError(
            f"family {cfg.family!r}: the port trains the paper CNN only")


def init(cfg: ModelConfig, gen: torch.Generator,
         device: torch.device) -> Params:
    if cfg.family == "cnn":
        return CNN.init_cnn(gen, cfg, device)
    if cfg.family == "hybrid":
        return HY.init_hybrid(gen, cfg, device)
    return TF.init_decoder(gen, cfg, device)


def forward(params: Params, cfg: ModelConfig, batch):
    """Full forward producing logits (B, S, V) and the aux loss."""
    if cfg.family == "hybrid":
        return HY.hybrid_forward(params, cfg, batch["tokens"])
    return TF.decoder_forward(params, cfg, batch["tokens"])


def prefill(params: Params, cfg: ModelConfig, batch, cache_len: int):
    """Process the prompt, returning (last_logits (B, 1, V), decode cache).
    The cache is allocated at ``cache_len`` slots; decode continues at
    cur_index = prompt_len."""
    if cfg.family == "hybrid":
        return HY.hybrid_forward(params, cfg, batch["tokens"],
                                 prefill_cache_len=cache_len)
    return TF.decoder_forward(params, cfg, batch["tokens"],
                              prefill_cache_len=cache_len)


def cache_shape(cfg: ModelConfig, batch: int, seq: int):
    if cfg.family == "hybrid":
        return HY.hybrid_cache_shape(cfg, batch, seq)
    return TF.decoder_cache_shape(cfg, batch, seq)


def make_cache(cfg: ModelConfig, batch: int, seq: int, device):
    """Zeroed decode cache: recurrent ``ssm`` states in f32, KV and conv
    leaves in ``cfg.dtype`` (the reference's ``api.cache_struct``)."""
    if cfg.family == "hybrid":
        return HY.make_hybrid_cache(cfg, batch, seq, device)
    return TF.make_decoder_cache(cfg, batch, seq, device)


def decode_step(params: Params, cfg: ModelConfig, cache,
                tokens: torch.Tensor, cur_index: int):
    if cfg.family == "hybrid":
        return HY.hybrid_decode_step(params, cfg, cache, tokens, cur_index)
    return TF.decoder_decode_step(params, cfg, cache, tokens, cur_index)


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
