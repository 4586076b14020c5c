"""xLSTM stack of the port (mLSTM + sLSTM mix), the ``ssm`` family —
``repro.models.xlstm``.

Layers are grouped into super-layers of ``slstm_every - 1`` mLSTM blocks
followed by one sLSTM block (the ≈7:1 mix of xLSTM-1.3b when
``slstm_every == 8``). The reference scans the super-layers with
``lax.scan``; the port loops over them in Python, and the reference's
``barrier`` and ``shard_residual`` are identities on one device.

Params are one flat dict with dotted keys (``convert.py`` maps the
reference's tree onto it): ``embed``, ``final_norm``, ``lm_head``; the
mLSTM blocks stacked on (n_super, n_m) leading axes (``super.m.mlstm.w_up``
is (n_super, n_m, d, 2 d_inner), ``super.m.norm`` (n_super, n_m, d)), the
sLSTM blocks on (n_super,) (``super.s.slstm.r_gates``, ``super.s.norm``).

The decode cache is the reference's nested dict: ``m`` {ssm (n_super, n_m,
B, H, dh, dh + 1) f32, conv (n_super, n_m, B, cw - 1, d_inner)} and ``s``
{c, n, h (n_super, B, d), m (n_super, B, H)}, all f32 but conv; prefill
fills it and ``xlstm_decode_step`` writes it in place.

Training goes through ``api.lm_loss_fn``: the mLSTM blocks through K4's
``autograd.Function`` (on the card the wide forward and its backward
kernel), the sLSTM block through ``ssm._SLSTMScan``, the reference's
hand-written VJP of its scan; ``remat`` checkpoints each super-layer, as
the reference's ``jax.checkpoint`` of its scan body.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as SM

Params = Dict[str, torch.Tensor]
M, S_ = "super.m.", "super.s."


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _split_layers(cfg: ModelConfig):
    k = cfg.slstm_every
    assert cfg.num_layers % k == 0, \
        "xlstm stack expects num_layers % slstm_every == 0"
    return k - 1, cfg.num_layers // k      # (mlstm per super-layer, n_super)


def _fill(params: Params, prefix: str, index, leaves: Params,
          lead: tuple, device) -> None:
    """Write one block's leaves into the stacked leaves under ``prefix`` at
    ``index``, allocating a stack (``lead`` leading axes) at first use."""
    for name, leaf in leaves.items():
        key = prefix + name
        if key not in params:
            params[key] = torch.empty(lead + tuple(leaf.shape),
                                      dtype=leaf.dtype, device=device)
        params[key][index] = leaf


def init_xlstm(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    dt = _dtype(cfg)
    n_m, n_super = _split_layers(cfg)
    params = {"embed": L.embed_init(gen, (cfg.vocab_size, cfg.d_model), dt,
                                    device)}
    # the stacked leaves are filled one block at a time, so the init never
    # holds a second copy of the layers
    ones = torch.ones((cfg.d_model,), dtype=dt, device=device)
    for n in range(n_super):
        for j in range(n_m):
            mp = {f"mlstm.{k}": v for k, v in SM.init_mlstm(
                gen, cfg.d_model, cfg.ssm, dt, device).items()}
            mp["norm"] = ones
            _fill(params, M, (n, j), mp, (n_super, n_m), device)
        sp = {f"slstm.{k}": v for k, v in SM.init_slstm(
            gen, cfg.d_model, cfg.num_heads, dt, device).items()}
        sp["norm"] = ones
        _fill(params, S_, n, sp, (n_super,), device)
    params["final_norm"] = torch.ones((cfg.d_model,), dtype=dt,
                                      device=device)
    params["lm_head"] = L.dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                     cfg.d_model, dt, device)
    return params


def _super_layer(cfg: ModelConfig, mlayers, sp: Params, x, cache=None,
                 n: int = 0):
    """One super-layer's forward: the mLSTM blocks, then the sLSTM block,
    each residual. With a prefill ``cache`` every block's state after the
    prompt is written into it at super-layer ``n``."""
    for j, lp in enumerate(mlayers):
        h = L.rms_norm(x, lp["norm"], cfg.norm_eps)
        out = SM.apply_mlstm(lp["mlstm"], h, cfg.ssm,
                             chunk=cfg.ssm.chunk_size,
                             return_state=cache is not None)
        if cache is not None:
            out, (cache["m"]["ssm"][n, j], cache["m"]["conv"][n, j]) = out
        x = x + out
    h = L.rms_norm(x, sp["norm"], cfg.norm_eps)
    out = SM.apply_slstm(sp["slstm"], h, cfg.num_heads,
                         return_state=cache is not None)
    if cache is not None:
        out, carry = out
        for name, t in zip("cnhm", carry):
            cache["s"][name][n] = t
    return x + out


def xlstm_forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  *, remat: bool = False, prefill_cache_len: int = 0,
                  return_hidden: bool = False, **_):
    """Returns (logits (B, S, V), 0.0); with ``return_hidden`` the
    final-normed hidden states instead. In prefill mode
    (``prefill_cache_len > 0``) returns (last_logits (B, 1, V), cache):
    every block's state after the prompt (the cache has no per-position
    leaves, so its length does not enter). ``remat`` checkpoints each
    super-layer when autograd records (training): its forward, K4 and the
    sLSTM scan included, runs again in backward."""
    n_m, n_super = _split_layers(cfg)
    x = params["embed"][tokens]
    B = tokens.shape[0]
    prefill = prefill_cache_len > 0
    remat = remat and torch.is_grad_enabled() and not prefill
    cache = make_xlstm_cache(cfg, B, x.device) if prefill else None
    for n in range(n_super):
        mlayers = [L.param_group(params, M, (n, j)) for j in range(n_m)]
        sp = L.param_group(params, S_, n)
        if remat:
            x = checkpoint(_super_layer, cfg, mlayers, sp, x,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _super_layer(cfg, mlayers, sp, x, cache, n)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if prefill:
        return x[:, -1:, :] @ params["lm_head"], cache
    if return_hidden:
        return x, 0.0
    return x @ params["lm_head"], 0.0


def xlstm_cache_shape(cfg: ModelConfig, batch: int, seq: int):
    n_m, n_super = _split_layers(cfg)
    m = SM.mlstm_state_shape(batch, cfg.d_model, cfg.ssm)
    s = SM.slstm_state_shape(batch, cfg.d_model, cfg.num_heads)
    return {"m": {k: (n_super, n_m) + v for k, v in m.items()},
            "s": {k: (n_super,) + v for k, v in s.items()}}


def make_xlstm_cache(cfg: ModelConfig, batch: int, device):
    """Zeroed decode cache: the mLSTM ``ssm`` states and every sLSTM leaf
    in f32, the conv states in ``cfg.dtype`` (``repro.models.api``'s
    ``_F32_LEAVES``)."""
    return L.zeros_of(L.cache_struct(xlstm_cache_shape(cfg, batch, 0),
                                     _dtype(cfg)), device)


def xlstm_decode_step(params: Params, cfg: ModelConfig, cache,
                      tokens: torch.Tensor, cur_index: int):
    """tokens: (B, 1). Returns (logits (B, 1, V), cache), every cache leaf
    updated in place (``cur_index`` does not enter: the states carry the
    position)."""
    n_m, n_super = _split_layers(cfg)
    x = params["embed"][tokens]
    cm, cs = cache["m"], cache["s"]
    for n in range(n_super):
        for j in range(n_m):
            lp = L.param_group(params, M, (n, j))
            h = L.rms_norm(x, lp["norm"], cfg.norm_eps)
            out, (ssm_new, conv_new) = SM.apply_mlstm(
                lp["mlstm"], h, cfg.ssm, state=cm["ssm"][n, j],
                conv_state=cm["conv"][n, j])
            cm["ssm"][n, j] = ssm_new
            cm["conv"][n, j] = conv_new
            x = x + out
        sp = L.param_group(params, S_, n)
        h = L.rms_norm(x, sp["norm"], cfg.norm_eps)
        out, carry = SM.apply_slstm(
            sp["slstm"], h, cfg.num_heads,
            carry=tuple(cs[name][n] for name in "cnhm"))
        for name, t in zip("cnhm", carry):
            cs[name][n] = t
        x = x + out
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["lm_head"], cache
