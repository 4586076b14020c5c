"""whisper-base's encoder-decoder (the audio family) in the port — the twin
of ``repro.models.encdec``.

The mel-spectrogram and conv feature extractor stay the reference's stub:
the model takes precomputed frame embeddings ``frames (B, encoder_seq,
d_model)``. Encoder and decoder are pre-LN transformers with GELU MLPs;
the encoder adds the learned ``enc_pos`` to the frames and attends without
a mask (with RoPE), the decoder is causal over the tokens and
cross-attends to the encoder's states (without RoPE). The output head is
the token embedding, tied.

Params are one flat dict, the reference's tree key for key
(``convert.py``): ``embed`` (V, d), ``enc_pos`` (Se, d), the encoder's
layers stacked under ``enc.`` (``enc.attn.wq`` (Le, d, H·hd),
``enc.ln1.w`` (Le, d), ``enc.mlp.w_in`` …), the decoder's under ``dec.``
(the same, plus ``dec.xattn.*`` and ``dec.ln_x.*``), and ``enc_norm.w/b``
and ``dec_norm.w/b``. Both stacks loop in Python over views of the stacked
leaves (``transformer.layer_views``); ``remat`` checkpoints each layer in
training, not in the prefill.

The decode cache is nested, in ``cfg.dtype``: ``{"self": {"k", "v"}}``,
(L, B, S, KV, hd) each, written in place a step, and ``{"cross_kv": {"k",
"v"}}``, (L, B, Se, KV, hd) each, the encoder states' projections that the
prefill leaves and every decode step reads.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import layer_views

Params = Dict[str, torch.Tensor]
ENC, DEC = "enc.", "dec."


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _init_block(gen: torch.Generator, cfg: ModelConfig, device,
                cross: bool) -> Params:
    dt = _dtype(cfg)
    d = cfg.d_model
    groups = {"attn": L.init_gqa(gen, d, cfg.num_heads, cfg.num_kv_heads,
                                 cfg.resolved_head_dim, dt, device),
              "mlp": L.init_gelu_mlp(gen, d, cfg.d_ff, dt, device)}
    norms = ["ln1", "ln2"]
    if cross:
        groups["xattn"] = L.init_gqa(gen, d, cfg.num_heads, cfg.num_kv_heads,
                                     cfg.resolved_head_dim, dt, device)
        norms.append("ln_x")
    for n in norms:
        groups[n] = {"w": torch.ones((d,), dtype=dt, device=device),
                     "b": torch.zeros((d,), dtype=dt, device=device)}
    return {f"{g}.{k}": v for g, leaves in groups.items()
            for k, v in leaves.items()}


def init_encdec(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    dt = _dtype(cfg)
    d = cfg.d_model
    params = {
        "embed": L.embed_init(gen, (cfg.vocab_size, d), dt, device),
        "enc_pos": L.embed_init(gen, (cfg.encoder_seq, d), dt, device)}
    # stacked leaves filled one layer at a time, as transformer.init_decoder
    for prefix, n, cross in ((ENC, cfg.encoder_layers, False),
                             (DEC, cfg.num_layers, True)):
        for layer in range(n):
            for k, leaf in _init_block(gen, cfg, device, cross).items():
                if prefix + k not in params:
                    params[prefix + k] = torch.empty(
                        (n,) + leaf.shape, dtype=dt, device=device)
                params[prefix + k][layer] = leaf
    for norm in ("enc_norm", "dec_norm"):
        params[f"{norm}.w"] = torch.ones((d,), dtype=dt, device=device)
        params[f"{norm}.b"] = torch.zeros((d,), dtype=dt, device=device)
    return params


def _ln(x: torch.Tensor, p: Dict, eps: float) -> torch.Tensor:
    return L.layer_norm(x, p["w"], p["b"], eps)


def _final_ln(x: torch.Tensor, params: Params, name: str,
              eps: float) -> torch.Tensor:
    return L.layer_norm(x, params[f"{name}.w"], params[f"{name}.b"], eps)


def _head(params: Params) -> torch.Tensor:
    return params["embed"].T


def _attn_kw(cfg: ModelConfig) -> Dict:
    return dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta)


def _enc_block(lp, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    h = _ln(x, lp["ln1"], cfg.norm_eps)
    a, _ = L.apply_gqa(lp["attn"], h, positions=positions, causal=False,
                       **_attn_kw(cfg))
    x = x + a
    return x + L.apply_gelu_mlp(lp["mlp"], _ln(x, lp["ln2"], cfg.norm_eps))


def encode(params: Params, cfg: ModelConfig, frames: torch.Tensor, *,
           remat: bool = False) -> torch.Tensor:
    """frames: (B, encoder_seq, d) stub-frontend embeddings → the encoder's
    states (B, encoder_seq, d) in ``cfg.dtype``."""
    x = frames.to(_dtype(cfg)) + params["enc_pos"][None]
    positions = torch.arange(x.shape[1], device=x.device)
    remat = remat and torch.is_grad_enabled()
    for lp in layer_views(params, ENC, cfg.encoder_layers):
        if remat:
            x = checkpoint(_enc_block, lp, cfg, x, positions,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _enc_block(lp, cfg, x, positions)
    return _final_ln(x, params, "enc_norm", cfg.norm_eps)


def _dec_block(lp, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor, enc_states: torch.Tensor,
               kv_chunk: int):
    """One decoder layer: causal self-attention, cross-attention to
    ``enc_states``, the GELU MLP. Returns (x, self kv, cross kv)."""
    h = _ln(x, lp["ln1"], cfg.norm_eps)
    a, self_kv = L.apply_gqa(lp["attn"], h, positions=positions,
                             kv_chunk=kv_chunk, **_attn_kw(cfg))
    x = x + a
    h = _ln(x, lp["ln_x"], cfg.norm_eps)
    a, cross_kv = L.apply_gqa(lp["xattn"], h, positions=positions,
                              cross_kv=enc_states, **_attn_kw(cfg))
    x = x + a
    x = x + L.apply_gelu_mlp(lp["mlp"], _ln(x, lp["ln2"], cfg.norm_eps))
    return x, self_kv, cross_kv


def _remat_dec_block(lp, cfg, x, positions, enc_states, kv_chunk):
    return _dec_block(lp, cfg, x, positions, enc_states, kv_chunk)[0]


def decode_train(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                 enc_states: torch.Tensor, *, remat: bool = False,
                 kv_chunk: int = 1024, prefill_cache_len: int = 0,
                 return_hidden: bool = False):
    """The decoder teacher-forced over the whole target sequence: (logits
    (B, S, V), 0.0), or with ``return_hidden`` the final-normed hidden
    states (B, S, d). In prefill mode (``prefill_cache_len > 0``): (last
    logits (B, 1, V), cache), the cache holding each layer's self K/V in
    the first S slots (zeros after) and its cross K/V."""
    x = F.embedding(tokens, params["embed"])
    B, Sq = tokens.shape
    positions = torch.arange(Sq, device=x.device)
    prefill = prefill_cache_len > 0
    remat = remat and torch.is_grad_enabled() and not prefill
    cache = None
    if prefill:
        cache = make_encdec_cache(cfg, B, prefill_cache_len, x.device)
    for layer, lp in enumerate(layer_views(params, DEC, cfg.num_layers)):
        if remat:
            x = checkpoint(_remat_dec_block, lp, cfg, x, positions,
                           enc_states, kv_chunk, use_reentrant=False,
                           preserve_rng_state=False)
            continue
        x, self_kv, cross_kv = _dec_block(lp, cfg, x, positions, enc_states,
                                          kv_chunk)
        if prefill:
            for name in ("k", "v"):
                cache["self"][name][layer, :, :Sq] = self_kv[name]
                cache["cross_kv"][name][layer] = cross_kv[name]
    x = _final_ln(x, params, "dec_norm", cfg.norm_eps)
    if prefill:
        return x[:, -1:, :] @ _head(params), cache
    if return_hidden:
        return x, 0.0
    return x @ _head(params), 0.0


def encdec_forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                   *, frames: torch.Tensor, remat: bool = False,
                   kv_chunk: int = 1024, prefill_cache_len: int = 0,
                   return_hidden: bool = False):
    enc_states = encode(params, cfg, frames, remat=remat)
    return decode_train(params, cfg, tokens, enc_states, remat=remat,
                        kv_chunk=kv_chunk,
                        prefill_cache_len=prefill_cache_len,
                        return_hidden=return_hidden)


def encdec_cache_shape(cfg: ModelConfig, batch: int, seq: int):
    per = L.gqa_cache_shape(batch, seq, cfg.num_kv_heads,
                            cfg.resolved_head_dim)
    cross = L.gqa_cache_shape(batch, cfg.encoder_seq, cfg.num_kv_heads,
                              cfg.resolved_head_dim)
    return {"self": {k: (cfg.num_layers,) + v for k, v in per.items()},
            "cross_kv": {k: (cfg.num_layers,) + v for k, v in cross.items()}}


def make_encdec_cache(cfg: ModelConfig, batch: int, seq: int,
                      device) -> Dict[str, Params]:
    """Zeroed decode cache in ``cfg.dtype``."""
    return L.zeros_of(L.cache_struct(encdec_cache_shape(cfg, batch, seq),
                                     _dtype(cfg)), device)


def encdec_decode_step(params: Params, cfg: ModelConfig, cache,
                       tokens: torch.Tensor, cur_index: int):
    """One token a sequence (tokens (B, 1)) at position ``cur_index``:
    self-attention against the cache, written in place, and
    cross-attention of an un-roped q to the prefill's cross K/V (the plain
    ``decode_attention`` at cur_index = Se − 1, every frame visible).
    Returns (logits (B, 1, V), cache)."""
    x = F.embedding(tokens, params["embed"])
    B = x.shape[0]
    positions = torch.full((1,), cur_index, device=x.device)
    for layer, lp in enumerate(layer_views(params, DEC, cfg.num_layers)):
        self_c = {k: t[layer] for k, t in cache["self"].items()}
        cross_k = cache["cross_kv"]["k"][layer]
        cross_v = cache["cross_kv"]["v"][layer]
        h = _ln(x, lp["ln1"], cfg.norm_eps)
        a, _ = L.apply_gqa(lp["attn"], h, positions=positions, cache=self_c,
                           cur_index=cur_index, **_attn_kw(cfg))
        x = x + a
        h = _ln(x, lp["ln_x"], cfg.norm_eps)
        q = (h @ lp["xattn"]["wq"]).reshape(B, 1, cfg.num_heads,
                                            cfg.resolved_head_dim)
        o = L.decode_attention(q, cross_k, cross_v,
                               cur_index=cross_k.shape[1] - 1)
        x = x + o.reshape(B, 1, -1) @ lp["xattn"]["wo"]
        x = x + L.apply_gelu_mlp(lp["mlp"], _ln(x, lp["ln2"], cfg.norm_eps))
    x = _final_ln(x, params, "dec_norm", cfg.norm_eps)
    return x @ _head(params), cache
