"""Decoder-only transformer stack of the port — the dense, MoE and VLM
families of ``repro.models.transformer``.

Params are one flat dict: ``embed`` (V, d), ``final_norm`` (d,),
``lm_head`` (d, V) unless the embeddings are tied, and the per-layer params
stacked on a leading layer axis under ``layers.<name>`` (``layers.attn.wq``
is (L, d, H·hd)), so the reference's stacked tree maps onto it key for key
(``convert.py``). The reference scans the stack with ``lax.scan``; the port
loops over the layers in Python, on views of the stacked leaves taken
once a forward (``unbind``, whose backward stacks the layers' gradients in
one copy). ``remat`` recomputes each layer in backward
(``torch.utils.checkpoint``), the reference's ``jax.checkpoint`` on its
scanned body; a checkpointed layer returns its MoE aux loss beside x. The
MoE layers (``models/moe.py``) replace the SwiGLU MLP under ``moe.``
(``layers.moe.w_gate`` is (L, E, d, f), ``layers.moe.shared.gate``
(L, d, 1)); the aux loss is summed over the layers in f32, in layer
order. MLA attention (``attn_type == "mla"``, minicpm3-4b) replaces the
GQA leaves under ``attn.`` (``layers.attn.wq_a`` … ``layers.attn.wo``).
The VLM family (chameleon-34b) is the dense stack fed early-fused
inputs: ``patch_embeds`` (B, P, d), the stub VQ frontend's output, go
before the token embeddings, so the model's sequence holds P + S
positions, 0 … P + S − 1; a prefill fills P + S slots of the cache, and
decode continues at ``cur_index`` = P + S, counting the patches.

The decode cache is a dict of stacked tensors in ``cfg.dtype``, written in
place: ``decoder_decode_step`` fills slot ``cur_index`` of each layer and
returns the same tensors. GQA keeps two, (L, B, S, KV, hd) ``k`` and
``v``; MLA one, (L, B, S, kv_lora_rank + rope_dim) ``latent``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE

Params = Dict[str, torch.Tensor]
LAYERS = "layers."


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def check_ported(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(f"family {cfg.family!r} has no decoder stack")


def _window(cfg: ModelConfig) -> int:
    return cfg.window if cfg.attn_type == "swa" else 0


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_decoder_layer(gen: torch.Generator, cfg: ModelConfig,
                       device) -> Params:
    """One layer's params, flat: ``attn.wq`` … ``mlp.w_down`` (or
    ``moe.router`` … ``moe.shared.gate``), norms."""
    dt = _dtype(cfg)
    if cfg.attn_type == "mla":
        attn = L.init_mla(gen, cfg.d_model, cfg.num_heads, cfg.mla, dt,
                          device)
    else:
        attn = L.init_gqa(gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                          cfg.resolved_head_dim, dt, device)
    if cfg.moe.enabled:
        mlp = MOE.init_moe(gen, cfg.d_model, cfg.moe, dt, device)
        group = "moe"
    else:
        mlp = L.init_swiglu(gen, cfg.d_model, cfg.d_ff, dt, device)
        group = "mlp"
    ones = torch.ones((cfg.d_model,), dtype=dt, device=device)
    params = {f"attn.{k}": v for k, v in attn.items()}
    params.update({f"{group}.{k}": v for k, v in mlp.items()})
    params.update({"norm1": ones, "norm2": ones.clone()})
    return params


def init_decoder(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    check_ported(cfg)
    dt = _dtype(cfg)
    params = {"embed": L.embed_init(gen, (cfg.vocab_size, cfg.d_model), dt,
                                    device)}
    # the stacked leaves are filled one layer at a time, so the init never
    # holds a second copy of the layers
    for n in range(cfg.num_layers):
        for k, leaf in init_decoder_layer(gen, cfg, device).items():
            if LAYERS + k not in params:
                params[LAYERS + k] = torch.empty(
                    (cfg.num_layers,) + leaf.shape, dtype=leaf.dtype,
                    device=device)
            params[LAYERS + k][n] = leaf
    params["final_norm"] = torch.ones((cfg.d_model,), dtype=dt, device=device)
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                         cfg.d_model, dt, device)
    return params


def all_layer_params(params: Params, cfg: ModelConfig) -> List[Dict]:
    """Every layer's params as views, {"attn": {...}, "mlp": {...},
    "norm1", "norm2"} a layer (``"moe": {..., "shared": {...}}`` in place
    of ``mlp``), from one ``unbind`` of each stacked leaf."""
    return layer_views(params, LAYERS, cfg.num_layers)


def layer_views(params: Params, prefix: str, n: int) -> List[Dict]:
    """The ``n`` layers stacked under ``prefix`` as nested dicts of views
    (``prefix + "attn.wq"`` → ``[layer]["attn"]["wq"]``), from one
    ``unbind`` of each stacked leaf."""
    out = [{} for _ in range(n)]
    for k, v in params.items():
        if not k.startswith(prefix):
            continue
        *groups, name = k[len(prefix):].split(".")
        for lp, t in zip(out, v.unbind(0)):
            for g in groups:
                lp = lp.setdefault(g, {})
            lp[name] = t
    return out


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def embed_tokens(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                 patch_embeds: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """tokens: (B, S) integer → (B, S, d). ``F.embedding``: its backward
    sums the rows of repeated tokens in a fixed order on the card too.
    VLM: ``patch_embeds`` (B, P, d), cast to the embedding's dtype, go
    before the tokens (early fusion) → (B, P + S, d)."""
    x = F.embedding(tokens, params["embed"])
    if patch_embeds is not None:
        x = torch.cat([patch_embeds.to(x.dtype), x], dim=1)
    return x


def _head(params: Params, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _block(lp, cfg: ModelConfig, x: torch.Tensor, moe_cf: float = 0.0,
           **attn_kw):
    """One decoder layer: pre-norm attention and SwiGLU (or MoE at capacity
    factor ``moe_cf``, 0 for the config's), with residuals. Returns (x,
    the cache entry of ``apply_gqa`` or ``apply_mla``, the MoE aux loss or
    None)."""
    h = L.rms_norm(x, lp["norm1"], cfg.norm_eps)
    if cfg.attn_type == "mla":
        a, kv = L.apply_mla(lp["attn"], h, num_heads=cfg.num_heads,
                            mla=cfg.mla, rope_theta=cfg.rope_theta, **attn_kw)
    else:
        a, kv = L.apply_gqa(lp["attn"], h, num_heads=cfg.num_heads,
                            num_kv_heads=cfg.num_kv_heads,
                            head_dim=cfg.resolved_head_dim,
                            rope_theta=cfg.rope_theta, window=_window(cfg),
                            **attn_kw)
    x = x + a
    h = L.rms_norm(x, lp["norm2"], cfg.norm_eps)
    if cfg.moe.enabled:
        m, aux = MOE.apply_moe(lp["moe"], h, cfg.moe,
                               capacity_factor=moe_cf)
        return x + m, kv, aux
    return x + L.apply_swiglu(lp["mlp"], h), kv, None


def _remat_block(lp, cfg: ModelConfig, x: torch.Tensor, positions,
                 kv_chunk: int):
    """(x, aux) of ``_block``: a checkpointed layer returns its aux loss."""
    x, _, aux = _block(lp, cfg, x, positions=positions, kv_chunk=kv_chunk)
    return x, aux


def decoder_forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                    *, patch_embeds: Optional[torch.Tensor] = None,
                    remat: bool = False, kv_chunk: int = 1024,
                    prefill_cache_len: int = 0, return_hidden: bool = False):
    """Returns (logits (B, S, V), aux_loss); with ``return_hidden`` the
    final-normed hidden states (B, S, d) instead of the logits (the loss
    applies the head itself, chunk by chunk). In prefill mode
    (``prefill_cache_len > 0``) returns (last_logits (B, 1, V), cache) with
    the cache's (L, B, prefill_cache_len, ...) tensors in ``cfg.dtype``
    holding each layer's K/V (or MLA latent) in the first S slots and zeros
    after. VLM: ``patch_embeds`` (B, P, d) go before the tokens, and S
    counts them (P + the text's length).
    ``remat`` checkpoints each layer when autograd records (training)."""
    check_ported(cfg)
    x = embed_tokens(params, cfg, tokens, patch_embeds)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)
    prefill = prefill_cache_len > 0
    remat = remat and torch.is_grad_enabled() and not prefill
    cache = None
    if prefill:
        cache = make_decoder_cache(cfg, B, prefill_cache_len, x.device)
    aux = 0.0
    for layer, lp in enumerate(all_layer_params(params, cfg)):
        if remat:
            x, aux_l = checkpoint(_remat_block, lp, cfg, x, positions,
                                  kv_chunk, use_reentrant=False,
                                  preserve_rng_state=False)
        else:
            x, kv, aux_l = _block(lp, cfg, x, positions=positions,
                                  kv_chunk=kv_chunk)
            if prefill:
                for name, t in kv.items():
                    cache[name][layer, :, :S] = t
        if aux_l is not None:
            aux = aux + aux_l
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if prefill:
        return x[:, -1:, :] @ _head(params, cfg), cache
    if return_hidden:
        return x, aux
    return x @ _head(params, cfg), aux


# ---------------------------------------------------------------------------
# decode (single-token serve step with the stacked per-layer KV cache)
# ---------------------------------------------------------------------------

def decoder_cache_shape(cfg: ModelConfig, batch: int, seq: int):
    check_ported(cfg)
    if cfg.attn_type == "mla":
        per = L.mla_cache_shape(batch, seq, cfg.mla)
    else:
        per = L.gqa_cache_shape(batch, seq, cfg.num_kv_heads,
                                cfg.resolved_head_dim)
    return {k: (cfg.num_layers,) + v for k, v in per.items()}


def make_decoder_cache(cfg: ModelConfig, batch: int, seq: int,
                       device) -> Params:
    """Zeroed decode cache in ``cfg.dtype``."""
    return L.zeros_of(L.cache_struct(decoder_cache_shape(cfg, batch, seq),
                                     _dtype(cfg)), device)


def decoder_decode_step(params: Params, cfg: ModelConfig, cache: Params,
                        tokens: torch.Tensor, cur_index: int):
    """tokens: (B, 1) — one new token per sequence at position
    ``cur_index``. Returns (logits (B, 1, V), cache), the cache updated in
    place."""
    check_ported(cfg)
    x = embed_tokens(params, cfg, tokens)                   # (B, 1, d)
    positions = torch.full((1,), cur_index, device=x.device)
    for layer, lp in enumerate(all_layer_params(params, cfg)):
        layer_cache = {name: t[layer] for name, t in cache.items()}
        x, _, _ = _block(lp, cfg, x, moe_cf=2 * cfg.moe.capacity_factor,
                         positions=positions, cache=layer_cache,
                         cur_index=cur_index)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ _head(params, cfg), cache
