"""Model API of the port — the CNN, dense- and MoE-decoder (GQA or MLA
attention), VLM (early fusion), hybrid, xLSTM (``ssm``) and
encoder-decoder (``audio``) branches of ``repro.models.api``.

    init(cfg, gen, device)                     -> params (flat dict)
    loss_fn(cfg)(params_w, batch, mask=None)   -> (loss (W,), metrics)
    lm_loss_fn(cfg)(params, batch)             -> (loss, metrics)
                                                  [every family but cnn]
    forward(params, cfg, batch)                -> (logits, aux)
                                                  [every family but cnn]
    prefill(params, cfg, batch, cache_len)     -> (last_logits, cache)
    cache_shape(cfg, batch, seq), cache_struct(cfg, batch, seq),
    make_cache(cfg, batch, seq, device)
    decode_step(params, cfg, cache, tokens, cur_index) -> (logits, cache)
    flat_param_spec, flat_packable, flatten_params, unflatten_params
                                               -> the flat (D,) view

CNN batches are dicts ``{images (W, B, 28, 28, 1), labels (W, B)}`` with
the worker dimension first; a single model is the W = 1 case (``stack``).
Decoder batches are ``{tokens (B, S)}`` (``{tokens, labels}``, each
(W, B, S), for ``loss_fn``); the VLM family's also carry ``patch_embeds``
(B, P, d) and the audio family's ``frames`` (B, encoder_seq, d), the stub
frontends' embeddings ((W, B, P, d) and (W, B, Se, d) for ``loss_fn``).
The dense, MoE and VLM families run through ``transformer`` (the MoE
layers through ``moe``, whose aux loss the LM loss adds and reports; the
VLM's patches before the tokens, its decode indices counting them), the
hybrid (zamba2) through ``hybrid``, xLSTM (the ``ssm`` family) through
``xlstm``, whisper (``audio``) through ``encdec``. The hybrid trains
through K4 and its backward (``kernels.ssd_scan``), xLSTM through K4's
wide path and its backward and the sLSTM scan's VJP (``ssm._SLSTMScan``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import pack
from repro_torch.models import cnn as CNN
from repro_torch.models import encdec as ED
from repro_torch.models import hybrid as HY
from repro_torch.models import layers as L
from repro_torch.models import transformer as TF
from repro_torch.models import xlstm as XL

Params = Dict[str, torch.Tensor]


def init(cfg: ModelConfig, gen: torch.Generator,
         device: torch.device) -> Params:
    if cfg.family == "cnn":
        return CNN.init_cnn(gen, cfg, device)
    if cfg.family == "hybrid":
        return HY.init_hybrid(gen, cfg, device)
    if cfg.family == "ssm":
        return XL.init_xlstm(gen, cfg, device)
    if cfg.family == "audio":
        return ED.init_encdec(gen, cfg, device)
    return TF.init_decoder(gen, cfg, device)


def forward(params: Params, cfg: ModelConfig, batch):
    """Full forward producing logits (B, S, V) and the aux loss."""
    if cfg.family == "hybrid":
        return HY.hybrid_forward(params, cfg, batch["tokens"])
    if cfg.family == "ssm":
        return XL.xlstm_forward(params, cfg, batch["tokens"])
    if cfg.family == "audio":
        return ED.encdec_forward(params, cfg, batch["tokens"],
                                 frames=batch["frames"])
    return TF.decoder_forward(params, cfg, batch["tokens"],
                              patch_embeds=_patches(cfg, batch))


def _patches(cfg: ModelConfig, batch) -> Optional[torch.Tensor]:
    """The VLM batch's ``patch_embeds``; None for the other families."""
    return batch["patch_embeds"] if cfg.family == "vlm" else None


def prefill(params: Params, cfg: ModelConfig, batch, cache_len: int):
    """Process the prompt, returning (last_logits (B, 1, V), decode cache).
    The cache is allocated at ``cache_len`` slots; decode continues at
    cur_index = prompt_len (VLM: after the patches, P + prompt_len)."""
    if cfg.family == "hybrid":
        return HY.hybrid_forward(params, cfg, batch["tokens"],
                                 prefill_cache_len=cache_len)
    if cfg.family == "ssm":
        return XL.xlstm_forward(params, cfg, batch["tokens"],
                                prefill_cache_len=cache_len)
    if cfg.family == "audio":
        return ED.encdec_forward(params, cfg, batch["tokens"],
                                 frames=batch["frames"],
                                 prefill_cache_len=cache_len)
    return TF.decoder_forward(params, cfg, batch["tokens"],
                              patch_embeds=_patches(cfg, batch),
                              prefill_cache_len=cache_len)


def cache_shape(cfg: ModelConfig, batch: int, seq: int):
    if cfg.family == "hybrid":
        return HY.hybrid_cache_shape(cfg, batch, seq)
    if cfg.family == "ssm":
        return XL.xlstm_cache_shape(cfg, batch, seq)
    if cfg.family == "audio":
        return ED.encdec_cache_shape(cfg, batch, seq)
    return TF.decoder_cache_shape(cfg, batch, seq)


def cache_struct(cfg: ModelConfig, batch: int, seq: int):
    """The decode cache's leaves as a (nested) dict of leaf name → (shape,
    dtype), the reference's ``api.cache_struct`` (the dry run's input):
    the recurrent states (``ssm``, and xLSTM's ``c``, ``n``, ``h``, ``m``)
    in f32, KV and conv leaves in ``cfg.dtype``. One card holds every leaf
    whole, so the reference's ``cache_spec`` has no twin."""
    return L.cache_struct(cache_shape(cfg, batch, seq),
                          getattr(torch, cfg.dtype))


def make_cache(cfg: ModelConfig, batch: int, seq: int, device):
    """Zeroed decode cache: zeros of ``cache_struct``."""
    return L.zeros_of(cache_struct(cfg, batch, seq), device)


def decode_step(params: Params, cfg: ModelConfig, cache,
                tokens: torch.Tensor, cur_index: int):
    if cfg.family == "hybrid":
        return HY.hybrid_decode_step(params, cfg, cache, tokens, cur_index)
    if cfg.family == "ssm":
        return XL.xlstm_decode_step(params, cfg, cache, tokens, cur_index)
    if cfg.family == "audio":
        return ED.encdec_decode_step(params, cfg, cache, tokens, cur_index)
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


def _lm_nll(logits: torch.Tensor, targets: torch.Tensor):
    """(summed f32 cross-entropy, count) over the targets >= 0 of one
    (B, S, V) logits block; the other targets (-100) are masked."""
    nll = F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                          targets.reshape(-1), reduction="sum",
                          ignore_index=-100)
    return nll, (targets >= 0).sum()


def _lm_xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Causal LM loss (the reference's ``_xent`` over (B, S, V)): the mean
    f32 cross-entropy over the targets >= 0."""
    nll, count = _lm_nll(logits, targets)
    return nll / count.clamp_min(1)


def _chunk_nll(x: torch.Tensor, head: torch.Tensor, targets: torch.Tensor):
    return _lm_nll(x @ head, targets)


def _chunked_xent(x: torch.Tensor, head: torch.Tensor,
                  targets: torch.Tensor, *, seq_chunk: int = 512
                  ) -> torch.Tensor:
    """Cross-entropy without the whole (B, S, V) logits: the sequence in
    ``seq_chunk`` pieces, each one's f32 logits recomputed in backward
    (``torch.utils.checkpoint``, the reference's ``@jax.checkpoint`` body),
    so backward holds one chunk's at a time. x: (B, S, d) final hidden;
    head: (d, V); targets: (B, S) with -100 pads. S not above ``seq_chunk``
    or not a multiple of it takes one block, as in the reference."""
    S = x.shape[1]
    if S % seq_chunk or S <= seq_chunk:
        return _lm_xent(x @ head, targets)
    nll_sum = x.new_zeros((), dtype=torch.float32)
    count = torch.zeros((), dtype=torch.int64, device=x.device)
    for c in range(0, S, seq_chunk):
        xc, tc = x[:, c:c + seq_chunk], targets[:, c:c + seq_chunk]
        if torch.is_grad_enabled():
            nll, n = checkpoint(_chunk_nll, xc, head, tc,
                                use_reentrant=False, preserve_rng_state=False)
        else:
            nll, n = _chunk_nll(xc, head, tc)
        nll_sum, count = nll_sum + nll, count + n
    return nll_sum / count.clamp_min(1)


def _shifted_targets(labels: torch.Tensor, total_len: int,
                     offset: int) -> torch.Tensor:
    """targets[pos] = the next token's label on the model's sequence:
    positions before ``offset`` and the last one get -100 (int64)."""
    B, S_text = labels.shape
    tgt = torch.full((B, total_len), -100, dtype=torch.int64,
                     device=labels.device)
    tgt[:, offset:offset + S_text - 1] = labels[:, 1:]
    return tgt


def lm_loss_fn(cfg: ModelConfig, *, remat: bool = False,
               kv_chunk: int = 1024):
    """One decoder's causal-LM loss, the LM branch of the reference's
    ``loss_fn``: f(params, {tokens (B, S), labels (B, S)}) -> (loss (),
    {"loss", "aux"}), for the dense and MoE decoders, the hybrid, xLSTM
    (the last two: head ``lm_head``, offset 0), the VLM (``patch_embeds``
    (B, P, d) in the batch too; head ``lm_head``, offset P: the patches'
    positions get no target) and whisper (``frames`` in the batch too; the
    tied head ``embed.T``, offset 0). ``aux`` is the MoE layers'
    load-balance and z-loss, summed over the layers (0 for the other
    families)."""
    lm_head_forward = {"hybrid": HY.hybrid_forward,
                       "ssm": XL.xlstm_forward}.get(cfg.family)
    if lm_head_forward is None and cfg.family != "audio":
        TF.check_ported(cfg)

    def f(params: Params, batch: Dict[str, torch.Tensor]):
        kw = dict(remat=remat, kv_chunk=kv_chunk, return_hidden=True)
        offset = 0
        if lm_head_forward is not None:
            x, aux = lm_head_forward(params, cfg, batch["tokens"], **kw)
            head = params["lm_head"]
        elif cfg.family == "audio":
            x, aux = ED.encdec_forward(params, cfg, batch["tokens"],
                                       frames=batch["frames"], **kw)
            head = params["embed"].T
        elif cfg.family == "vlm":
            x, aux = TF.decoder_forward(params, cfg, batch["tokens"],
                                        patch_embeds=batch["patch_embeds"],
                                        **kw)
            head = params["lm_head"]
            offset = batch["patch_embeds"].shape[1]
        else:
            x, aux = TF.decoder_forward(params, cfg, batch["tokens"], **kw)
            head = (params["embed"].T if cfg.tie_embeddings
                    else params["lm_head"])
        targets = _shifted_targets(batch["labels"], x.shape[1], offset)
        loss = _chunked_xent(x, head, targets) + aux
        return loss, {"loss": loss,
                      "aux": torch.as_tensor(aux, dtype=torch.float32,
                                             device=loss.device)}
    return f


def loss_fn(cfg: ModelConfig, *, remat: bool = False, kv_chunk: int = 1024):
    """Returns f(params_w, batch, mask=None) -> (loss (W,), metrics), every
    worker's loss on its own batch. CNN: ``mask`` is the conv2 dropout keep
    mask (``cnn.dropout_mask``); None evaluates without dropout; metrics
    {"loss", "accuracy"}. Dense, MoE and VLM decoders, the hybrid, xLSTM
    and whisper: batch leaves (W, B, S) (the VLM's ``patch_embeds``
    (W, B, P, d), whisper's ``frames`` (W, B, Se, d)),
    each worker's slice of every leaf through ``lm_loss_fn`` in turn
    (``remat``, ``kv_chunk``), no dropout; metrics {"loss", "aux"}, each
    (W,)."""
    if cfg.family == "cnn":
        def f_cnn(params_w: Params, batch: Dict[str, torch.Tensor],
                  mask: Optional[torch.Tensor] = None):
            logits = CNN.cnn_forward(params_w, cfg, batch["images"],
                                     mask=mask)
            labels = batch["labels"]
            loss = _xent(logits, labels)
            acc = (logits.argmax(-1) == labels).float().mean(dim=1)
            return loss, {"loss": loss, "accuracy": acc}
        return f_cnn

    lm = lm_loss_fn(cfg, remat=remat, kv_chunk=kv_chunk)

    def f_lm(params_w: Params, batch: Dict[str, torch.Tensor],
             mask: Optional[torch.Tensor] = None):
        W = batch["tokens"].shape[0]
        per = [lm(worker(params_w, w), worker(batch, w)) for w in range(W)]
        metrics = {k: torch.stack([m[k] for _, m in per])
                   for k in per[0][1]}
        return metrics["loss"], metrics
    return f_lm


def worker(tree: Dict[str, torch.Tensor], w: int) -> Dict[str, torch.Tensor]:
    """Worker ``w``'s slice of a dict of (W, ...) leaves (views)."""
    return {k: v[w] for k, v in tree.items()}


def param_count(params: Params) -> int:
    return sum(x.numel() for x in params.values())


# --- flat-param view (the fused trust round's packed layout) -----------------
# Thin delegations to ``kernels.pack``: a model's flat (D,) coordinate space
# (each leaf's offset, size and shape, the pack dtype, the length D).

def flat_param_spec(params: Params) -> pack.PackSpec:
    """The pack layout of ``params``: leaf order (sorted keys, the
    reference's ``jax.tree.leaves`` order), each leaf's (offset, size,
    shape) on the flat axis, the pack dtype and D."""
    return pack.pack_spec(params)


def flat_packable(params: Params) -> bool:
    """Whether ``params`` admits the flat view (one floating leaf dtype,
    what ``FederationConfig.fused_trust_path`` asks of a model)."""
    return pack.packable(params)


def flatten_params(params: Params):
    """params → ((D,) vector, spec). Inverse: ``unflatten_params``."""
    spec = pack.pack_spec(params)
    return torch.cat([params[k].reshape(-1) for k in spec.keys]), spec


def unflatten_params(flat: torch.Tensor, spec: pack.PackSpec) -> Params:
    """(D,) vector and spec → params (views into ``flat``), the exact
    inverse of ``flatten_params``."""
    return pack.unpack_vector(flat, spec)
