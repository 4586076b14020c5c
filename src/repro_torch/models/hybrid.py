"""zamba2-style hybrid of the port: a Mamba2 backbone plus a single *shared*
attention + MLP block — ``repro.models.hybrid``.

The shared block (one parameter copy) runs after every
``shared_attn_every``-th Mamba2 layer: the layers form ``n_super``
super-layers of k = ``shared_attn_every`` Mamba2 layers and one
shared-block application, and a remainder tail of Mamba2 layers follows.
The reference scans the super-layers with ``lax.scan``; the port loops over
them in Python. ``remat`` recomputes each super-layer in backward
(``torch.utils.checkpoint``), the reference's ``jax.checkpoint`` of its
scan body.

Params are one flat dict with dotted keys (``convert.py`` maps the
reference's tree onto it): ``embed``, ``final_norm``, ``lm_head``; the
super-layers' Mamba2 params stacked on (n_super, k) leading axes
(``super.mamba.w_x`` is (n_super, k, d, d_inner), ``super.norm``
(n_super, k, d)); each tail layer under ``tail.<i>.`` (the reference's
``tail`` is a list); the shared block under ``shared.`` (``shared.attn.wq``,
``shared.mlp.w_gate``, ``shared.norm1``, ``shared.norm2``).

The decode cache is the reference's nested dict — ``super_ssm`` and
``tail_ssm`` ({ssm, conv_x, conv_bc}, with (n_super, k) and
(max(n_tail, 1),) leading axes) and ``shared_attn`` ({k, v}, (n_super, B,
S, KV, hd)) — written in place by ``hybrid_decode_step``.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as SM

Params = Dict[str, torch.Tensor]
SUPER, TAIL, SHARED = "super.", "tail.", "shared."


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _split_layers(cfg: ModelConfig):
    k = cfg.shared_attn_every
    n_super = cfg.num_layers // k
    n_tail = cfg.num_layers - n_super * k
    return k, n_super, n_tail


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_mamba_layer(gen, cfg: ModelConfig, device) -> Params:
    dt = _dtype(cfg)
    p = {f"mamba.{k}": v for k, v in SM.init_mamba2(
        gen, cfg.d_model, cfg.ssm, dt, device).items()}
    p["norm"] = torch.ones((cfg.d_model,), dtype=dt, device=device)
    return p


def init_hybrid(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    dt = _dtype(cfg)
    k, n_super, n_tail = _split_layers(cfg)
    params = {"embed": L.embed_init(gen, (cfg.vocab_size, cfg.d_model), dt,
                                    device)}
    # the stacked super-layer leaves are filled one layer at a time, so the
    # init never holds a second copy of the backbone
    for n in range(n_super):
        for j in range(k):
            for name, leaf in _init_mamba_layer(gen, cfg, device).items():
                key = SUPER + name
                if key not in params:
                    params[key] = torch.empty((n_super, k) + leaf.shape,
                                              dtype=leaf.dtype, device=device)
                params[key][n, j] = leaf
    for t in range(n_tail):
        for name, leaf in _init_mamba_layer(gen, cfg, device).items():
            params[f"{TAIL}{t}.{name}"] = leaf
    attn = L.init_gqa(gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                      cfg.resolved_head_dim, dt, device)
    mlp = L.init_swiglu(gen, cfg.d_model, cfg.d_ff, dt, device)
    params.update({f"{SHARED}attn.{k}": v for k, v in attn.items()})
    params.update({f"{SHARED}mlp.{k}": v for k, v in mlp.items()})
    for name in ("norm1", "norm2"):
        params[SHARED + name] = torch.ones((cfg.d_model,), dtype=dt,
                                           device=device)
    params["final_norm"] = torch.ones((cfg.d_model,), dtype=dt, device=device)
    params["lm_head"] = L.dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                     cfg.d_model, dt, device)
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _shared_fwd(cfg: ModelConfig, sp, x, positions, cache=None,
                cur_index=None, kv_chunk: int = 1024):
    """The shared attention + SwiGLU block. Returns (x, kv): the projected
    k/v of the sequence, or in decode (``cache`` given) the cache, written
    in place."""
    h = L.rms_norm(x, sp["norm1"], cfg.norm_eps)
    a, kv = L.apply_gqa(sp["attn"], h, num_heads=cfg.num_heads,
                        num_kv_heads=cfg.num_kv_heads,
                        head_dim=cfg.resolved_head_dim, positions=positions,
                        rope_theta=cfg.rope_theta, kv_chunk=kv_chunk,
                        cache=cache, cur_index=cur_index)
    x = x + a
    h = L.rms_norm(x, sp["norm2"], cfg.norm_eps)
    return x + L.apply_swiglu(sp["mlp"], h), kv


def _mamba_step(cfg: ModelConfig, lp, x, prefill: bool):
    h = L.rms_norm(x, lp["norm"], cfg.norm_eps)
    if prefill:
        out, (ssm_new, (cx, cbc)) = SM.apply_mamba2(lp["mamba"], h, cfg.ssm,
                                                    return_state=True)
        return x + out, {"ssm": ssm_new, "conv_x": cx, "conv_bc": cbc}
    return x + SM.apply_mamba2(lp["mamba"], h, cfg.ssm), None


def _write(cache_group: Params, index, state: Params) -> None:
    for name, t in state.items():
        cache_group[name][index] = t


def _super_layer(cfg: ModelConfig, layers, shared, x, positions,
                 kv_chunk: int) -> torch.Tensor:
    """One super-layer outside prefill: its Mamba2 layers, then the shared
    block (the reference's ``super_body``)."""
    for lp in layers:
        x, _ = _mamba_step(cfg, lp, x, False)
    return _shared_fwd(cfg, shared, x, positions, kv_chunk=kv_chunk)[0]


def hybrid_forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                   *, remat: bool = False, kv_chunk: int = 1024,
                   prefill_cache_len: int = 0, return_hidden: bool = False):
    """Returns (logits (B, S, V), aux_loss); with ``return_hidden`` the
    final-normed hidden states (B, S, d) instead of the logits (the loss
    applies the head itself, chunk by chunk). In prefill mode
    (``prefill_cache_len > 0``) returns (last_logits (B, 1, V), cache): the
    Mamba2 states after the prompt and the shared block's K/V in the first
    S slots of each super-layer's ``prefill_cache_len``-slot cache.
    ``remat`` checkpoints each super-layer when autograd records
    (training): its forward, K4 included, runs again in backward, and K4's
    saved states come from that run."""
    k, n_super, n_tail = _split_layers(cfg)
    x = params["embed"][tokens]
    B, S = tokens.shape
    positions = torch.arange(S, device=x.device)
    prefill = prefill_cache_len > 0
    remat = remat and torch.is_grad_enabled() and not prefill
    cache = None
    if prefill:
        cache = make_hybrid_cache(cfg, B, prefill_cache_len, x.device)
    shared = L.param_group(params, SHARED)
    for n in range(n_super):
        if not prefill:
            layers = [L.param_group(params, SUPER, (n, j))
                      for j in range(k)]
            if remat:
                x = checkpoint(_super_layer, cfg, layers, shared, x,
                               positions, kv_chunk, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = _super_layer(cfg, layers, shared, x, positions, kv_chunk)
            continue
        for j in range(k):
            x, st = _mamba_step(cfg, L.param_group(params, SUPER, (n, j)),
                                x, True)
            _write(cache["super_ssm"], (n, j), st)
        x, kv = _shared_fwd(cfg, shared, x, positions, kv_chunk=kv_chunk)
        for name in ("k", "v"):
            cache["shared_attn"][name][n, :, :S] = kv[name]
    for t in range(n_tail):
        x, st = _mamba_step(cfg, L.param_group(params, f"{TAIL}{t}."), x,
                            prefill)
        if prefill:
            _write(cache["tail_ssm"], t, st)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if prefill:
        return x[:, -1:, :] @ params["lm_head"], cache
    if return_hidden:
        return x, 0.0
    return x @ params["lm_head"], 0.0


# ---------------------------------------------------------------------------
# decode (single-token serve step)
# ---------------------------------------------------------------------------

def hybrid_cache_shape(cfg: ModelConfig, batch: int, seq: int):
    k, n_super, n_tail = _split_layers(cfg)
    m = SM.mamba2_state_shape(batch, cfg.d_model, cfg.ssm)
    attn = L.gqa_cache_shape(batch, seq, cfg.num_kv_heads,
                             cfg.resolved_head_dim)
    return {
        "super_ssm": {kk: (n_super, k) + v for kk, v in m.items()},
        "tail_ssm": {kk: (max(n_tail, 1),) + v for kk, v in m.items()},
        "shared_attn": {kk: (n_super,) + v for kk, v in attn.items()},
    }


def make_hybrid_cache(cfg: ModelConfig, batch: int, seq: int, device):
    """Zeroed decode cache: the ``ssm`` states in f32, the conv states and
    the shared K/V in ``cfg.dtype`` (``repro.models.api``'s leaf dtypes)."""
    return L.zeros_of(L.cache_struct(hybrid_cache_shape(cfg, batch, seq),
                                     _dtype(cfg)), device)


def _mamba_decode(cfg: ModelConfig, lp, x, cache_group: Params, index):
    st = {name: t[index] for name, t in cache_group.items()}
    h = L.rms_norm(x, lp["norm"], cfg.norm_eps)
    out, (ssm_new, (cx, cbc)) = SM.apply_mamba2(
        lp["mamba"], h, cfg.ssm, state=st["ssm"],
        conv_state=(st["conv_x"], st["conv_bc"]))
    _write(cache_group, index, {"ssm": ssm_new, "conv_x": cx,
                                "conv_bc": cbc})
    return x + out


def hybrid_decode_step(params: Params, cfg: ModelConfig, cache,
                       tokens: torch.Tensor, cur_index: int):
    """tokens: (B, 1) — one new token per sequence at position
    ``cur_index``. Returns (logits (B, 1, V), cache), every cache leaf
    updated in place."""
    k, n_super, n_tail = _split_layers(cfg)
    x = params["embed"][tokens]
    positions = torch.full((1,), cur_index, device=x.device)
    shared = L.param_group(params, SHARED)
    for n in range(n_super):
        for j in range(k):
            x = _mamba_decode(cfg, L.param_group(params, SUPER, (n, j)), x,
                              cache["super_ssm"], (n, j))
        attn_cache = {name: t[n] for name, t in cache["shared_attn"].items()}
        x, _ = _shared_fwd(cfg, shared, x, positions, cache=attn_cache,
                           cur_index=cur_index)
    for t in range(n_tail):
        x = _mamba_decode(cfg, L.param_group(params, f"{TAIL}{t}."), x,
                          cache["tail_ssm"], t)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["lm_head"], cache
