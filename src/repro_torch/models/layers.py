"""Model-zoo building blocks of the port, the twin of
``repro.models.layers``: RMSNorm and LayerNorm, RoPE, the attention cores,
GQA attention (causal or not, or cross-attention over encoder states),
Multi-head Latent Attention (MLA) with its absorbed decode, and the SwiGLU
and GELU MLPs.

Plain functions over dicts of tensors, in the reference's layouts:
weights are (in, out) and multiply as ``x @ W``; activations are
(B, S, H, hd); caches are (B, S, KV, hd). The reference's tensor-parallel
specs and its ``repro.models.sharding`` hooks are identities on one device
and are dropped. The reference multiplies bf16 attention operands with f32
accumulation (``preferred_element_type``); the port upcasts the operands to
f32 instead, which gives the same products (a product of two bf16 values is
exact in f32). Decode attention with a sliding window runs as the K5 kernel
(``kernels.swa_decode``); ``decode_attention`` stays as the plain version
for ``window == 0``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import mathfn
from repro_torch.kernels.swa_decode import swa_decode

Params = Dict[str, torch.Tensor]
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, in_dim: int, dtype,
               device) -> torch.Tensor:
    """Normal(0, 1/in_dim), drawn on the generator's device (a CPU
    generator gives the same weights for a seed on every device) and
    moved to ``device``."""
    scale = 1.0 / math.sqrt(in_dim)
    return (torch.randn(shape, generator=gen, device=gen.device) * scale
            ).to(device=device, dtype=dtype)


def embed_init(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=gen.device) * 0.02
            ).to(device=device, dtype=dtype)


def param_group(params: Params, prefix: str, index=None) -> Dict:
    """The leaves of a flat dict under ``prefix``, grouped by what is left
    of the key before its last dot ({"mamba": {...}, "norm": ...}), each
    leaf indexed by ``index`` (one block of stacked leaves) unless it is
    None."""
    out: Dict = {}
    for key, v in params.items():
        if not key.startswith(prefix):
            continue
        group, _, name = key[len(prefix):].rpartition(".")
        leaf = v if index is None else v[index]
        if group:
            out.setdefault(group, {})[name] = leaf
        else:
            out[name] = leaf
    return out


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in f32, returned in ``x.dtype``. Autograd gives the
    gradient of the reference's hand-written VJP: f32 math, cotangents cast
    back to the primal dtypes."""
    xf = x.float()
    r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * r * weight).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32, returned in ``x.dtype``."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * weight + bias).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    angles = positions[..., :, None].float() * freqs          # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                     # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention cores
# ---------------------------------------------------------------------------

def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B, Sq, KV, G, hd), k: (B, Skv, KV, hd) -> (B, KV, G, Sq, Skv)
    f32."""
    return torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float())


def _attn_mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, causal: bool,
               window: int) -> torch.Tensor:
    """(Sq, Skv) boolean mask: True = attend."""
    dq = q_pos[:, None]
    dk = kv_pos[None, :]
    mask = torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= dk <= dq
    if window > 0:
        mask &= (dq - dk) < window
    return mask


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      q_positions: torch.Tensor, kv_positions: torch.Tensor,
                      causal: bool = True, window: int = 0,
                      kv_chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over KV chunks — O(Sq·chunk) live memory.

    q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd) with H % KV == 0.
    window > 0 => sliding-window mask (q_pos - kv_pos < window).
    Returns (B, Sq, H, hd).

    Under grad (grad mode on and an input that requires grad) each chunk
    runs out of place under ``torch.utils.checkpoint``, as the reference's
    ``jax.checkpoint`` chunk body: backward recomputes one chunk's scores
    at a time instead of keeping every chunk's. Otherwise (serve) the chunk
    overwrites its score tensor in place. Both give the same values.
    """
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qs = q.reshape(B, Sq, KV, G, hd) * scale

    if Skv <= kv_chunk or Skv % kv_chunk != 0:
        s = _gqa_scores(qs, k)                                # (B,KV,G,Sq,Skv)
        mask = _attn_mask(q_positions, kv_positions, causal, window)
        s = s.masked_fill(~mask, NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype).float(),
                         v.float())
        return o.reshape(B, Sq, H, hd).to(q.dtype)
    m = torch.full((B, KV, G, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, G, Sq, hd), dtype=torch.float32,
                      device=q.device)
    qf = qs.float()
    grad = torch.is_grad_enabled() and any(
        x.requires_grad for x in (q, k, v))
    for c in range(0, Skv, kv_chunk):
        mask = _attn_mask(q_positions, kv_positions[c:c + kv_chunk], causal,
                          window)
        args = (qf, k[:, c:c + kv_chunk], v[:, c:c + kv_chunk], mask, m, l,
                acc)
        if grad:
            m, l, acc = checkpoint(_chunk_step, *args, False,
                                   use_reentrant=False,
                                   preserve_rng_state=False)
        else:
            m, l, acc = _chunk_step(*args, True)
    o = acc / l.clamp_min(1e-30)[..., None]                   # (B,KV,G,Sq,hd)
    return o.movedim(3, 1).reshape(B, Sq, H, hd).to(q.dtype)


def _chunk_step(qf, k_i, v_i, mask, m, l, acc, inplace: bool):
    """One KV chunk of the online softmax: (m, l, acc) → the next ones.
    ``inplace`` reuses the chunk's score tensor for its probabilities (no
    autograd), else every op is out of place."""
    s = _gqa_scores(qf, k_i)                                  # (B,KV,G,Sq,chunk)
    if inplace:
        s.masked_fill_(~mask, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = mathfn.exp_(s.sub_(m_new[..., None]))            # s dies here
    else:
        s = s.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = mathfn.exp(s - m_new[..., None])
    corr = mathfn.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bkgqs,bskh->bkgqh", p.to(v_i.dtype).float(),
                      v_i.float())
    return m_new, l, acc * corr[..., None] + pv


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, cur_index: int,
                     window: int = 0) -> torch.Tensor:
    """Single-token decode, plain version: q (B, 1, H, hd) vs cache
    (B, S, KV, hd). Slots after ``cur_index`` are masked (and slots outside
    the sliding window when ``window > 0``)."""
    B, _, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qs = (q.reshape(B, KV, G, hd) * scale).to(k_cache.dtype)
    s = torch.einsum("bkgh,bskh->bkgs", qs.float(), k_cache.float())
    pos = torch.arange(S, device=q.device)
    valid = pos <= cur_index
    if window > 0:
        valid &= (cur_index - pos) < window
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(B, 1, H, v_cache.shape[-1]).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------

def init_gqa(gen: torch.Generator, d_model: int, num_heads: int,
             num_kv_heads: int, head_dim: int, dtype, device) -> Params:
    hq, hkv = num_heads * head_dim, num_kv_heads * head_dim
    return {
        "wq": dense_init(gen, (d_model, hq), d_model, dtype, device),
        "wk": dense_init(gen, (d_model, hkv), d_model, dtype, device),
        "wv": dense_init(gen, (d_model, hkv), d_model, dtype, device),
        "wo": dense_init(gen, (hq, d_model), hq, dtype, device),
    }


def apply_gqa(params: Params, x: torch.Tensor, *, num_heads: int,
              num_kv_heads: int, head_dim: int, positions: torch.Tensor,
              rope_theta: float, causal: bool = True, window: int = 0,
              kv_chunk: int = 1024, cache: Optional[Params] = None,
              cur_index: Optional[int] = None,
              cross_kv: Optional[torch.Tensor] = None):
    """Self-attention (causal unless ``causal=False``), or cross-attention
    over ``cross_kv``, encoder states (B, Se, d) that k and v are projected
    from (whisper's decoder; neither q nor k gets RoPE there, and every
    query sees all Se keys). x: (B, S, d). Returns (out, kv).

    Full sequence (no ``cache``): blocked attention over ``kv_chunk``-slot
    KV chunks; ``kv`` holds the projected k and v, (B, S, KV, hd) each, or
    (B, Se, KV, hd) for cross-attention, for the caller to put into a
    decode cache.

    Decode (``cache`` given, S == 1): writes this token's k/v into slot
    ``cur_index`` of the cache IN PLACE (the reference's
    ``dynamic_update_slice`` is a functional copy; the port does not copy
    the cache per step) and returns the cache as ``kv``. With
    ``window > 0`` the attention is the K5 kernel."""
    B, S, _ = x.shape
    q = (x @ params["wq"]).reshape(B, S, num_heads, head_dim)
    if cross_kv is None:
        k = (x @ params["wk"]).reshape(B, S, num_kv_heads, head_dim)
        v = (x @ params["wv"]).reshape(B, S, num_kv_heads, head_dim)
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    else:
        Se = cross_kv.shape[1]
        k = (cross_kv @ params["wk"]).reshape(B, Se, num_kv_heads, head_dim)
        v = (cross_kv @ params["wv"]).reshape(B, Se, num_kv_heads, head_dim)
        o = blocked_attention(q, k, v, q_positions=positions,
                              kv_positions=torch.arange(Se, device=x.device),
                              causal=False, kv_chunk=kv_chunk)
        return o.reshape(B, S, -1) @ params["wo"], {"k": k, "v": v}

    if cache is not None:
        k_cache, v_cache = cache["k"], cache["v"]
        k_cache[:, cur_index] = k[:, 0].to(k_cache.dtype)
        v_cache[:, cur_index] = v[:, 0].to(v_cache.dtype)
        if window > 0:
            o = swa_decode(q[:, 0].contiguous(), k_cache, v_cache, cur_index,
                           window)
        else:
            o = decode_attention(q, k_cache, v_cache, cur_index=cur_index)
        return o.reshape(B, S, -1) @ params["wo"], cache

    o = blocked_attention(q, k, v, q_positions=positions,
                          kv_positions=positions, causal=causal,
                          window=window, kv_chunk=kv_chunk)
    return o.reshape(B, S, -1) @ params["wo"], {"k": k, "v": v}


def gqa_cache_shape(batch: int, seq: int, num_kv_heads: int, head_dim: int):
    return {"k": (batch, seq, num_kv_heads, head_dim),
            "v": (batch, seq, num_kv_heads, head_dim)}


# recurrent-state leaves live in f32; KV-style and conv caches in the model
# dtype (``repro.models.api._F32_LEAVES``)
F32_CACHE_LEAVES = ("ssm", "c", "n", "h", "m")


def cache_struct(shapes, dtype: torch.dtype):
    """A (nested) dict of cache leaf shapes → the same dict of (shape,
    dtype): the leaves named in ``F32_CACHE_LEAVES`` in f32, the others in
    ``dtype``."""
    return {k: cache_struct(v, dtype) if isinstance(v, dict) else
            (tuple(v), torch.float32 if k in F32_CACHE_LEAVES else dtype)
            for k, v in shapes.items()}


def zeros_of(struct, device) -> Dict:
    """Zeros of a (nested) dict of (shape, dtype) leaves."""
    return {k: zeros_of(v, device) if isinstance(v, dict) else
            torch.zeros(v[0], dtype=v[1], device=device)
            for k, v in struct.items()}


# ---------------------------------------------------------------------------
# MLA attention (minicpm3 / DeepSeek-style latent attention)
# ---------------------------------------------------------------------------

def init_mla(gen: torch.Generator, d_model: int, num_heads: int, mla, dtype,
             device) -> Params:
    qk_hd = mla.qk_nope_head_dim + mla.qk_rope_head_dim
    rank, q_rank = mla.kv_lora_rank, mla.q_lora_rank
    hv = num_heads * mla.v_head_dim
    return {
        "wq_a": dense_init(gen, (d_model, q_rank), d_model, dtype, device),
        "q_a_norm": torch.ones((q_rank,), dtype=dtype, device=device),
        "wq_b": dense_init(gen, (q_rank, num_heads * qk_hd), q_rank, dtype,
                           device),
        "wkv_a": dense_init(gen, (d_model, rank + mla.qk_rope_head_dim),
                            d_model, dtype, device),
        "kv_a_norm": torch.ones((rank,), dtype=dtype, device=device),
        "wkv_b": dense_init(gen, (rank, num_heads * (mla.qk_nope_head_dim
                                                     + mla.v_head_dim)),
                            rank, dtype, device),
        "wo": dense_init(gen, (hv, d_model), hv, dtype, device),
    }


def apply_mla(params: Params, x: torch.Tensor, *, num_heads: int, mla,
              positions: torch.Tensor, rope_theta: float,
              kv_chunk: int = 1024, cache: Optional[Params] = None,
              cur_index: Optional[int] = None):
    """MLA: queries through a low-rank bottleneck, keys and values through
    a compressed latent (``kv_lora_rank``) plus one RoPE key shared by
    every head. x: (B, S, d). Returns (out, cache entry).

    Full sequence (no ``cache``): k = [the latent's per-head nope keys, the
    RoPE key broadcast over the heads], v padded from ``v_head_dim`` to the
    q/k head dim for ``blocked_attention`` (scale 1/√qk_hd) and sliced
    back; the entry is {"latent": (B, S, kv_lora_rank + rope_dim)}, the
    normed latent and the roped key, for the decode cache.

    Decode (``cache`` given, S == 1): the absorbed form, attention in the
    latent space without expanding the cache to per-head K/V. This token's
    entry is written into slot ``cur_index`` of ``cache["latent"]`` IN
    PLACE; q̃_h = W_k(h)ᵀ q_nope_h, score_i = q̃·latent_i + q_rope·k_rope_i,
    out_h = W_v(h) (p · latent), rounded where the reference rounds: q·scale,
    q̃, p and the context to the cache dtype, the scores and the softmax in
    f32, the output to x's dtype. Both RMSNorms take eps 1e-5."""
    B, S, _ = x.shape
    nope, rd, vd = mla.qk_nope_head_dim, mla.qk_rope_head_dim, mla.v_head_dim
    rank = mla.kv_lora_rank
    qk_hd = nope + rd

    q = rms_norm(x @ params["wq_a"], params["q_a_norm"])
    q = (q @ params["wq_b"]).reshape(B, S, num_heads, qk_hd)
    q = torch.cat([q[..., :nope],
                   apply_rope(q[..., nope:], positions, rope_theta)], dim=-1)

    kv_a = x @ params["wkv_a"]                                # (B,S,rank+rd)
    latent = rms_norm(kv_a[..., :rank], params["kv_a_norm"])
    k_rope = apply_rope(kv_a[..., None, rank:], positions,
                        rope_theta)                           # (B,S,1,rd)

    if cache is not None:
        lat_cache = cache["latent"]
        lat_dt = lat_cache.dtype
        lat_cache[:, cur_index, :rank] = latent[:, 0].to(lat_dt)
        lat_cache[:, cur_index, rank:] = k_rope[:, 0, 0].to(lat_dt)
        latent_all = lat_cache[..., :rank].float()            # (B,Sc,r)
        k_rope_all = lat_cache[..., rank:].float()            # (B,Sc,rd)
        wkv = params["wkv_b"].reshape(rank, num_heads, nope + vd)
        w_k = wkv[..., :nope].to(lat_dt).float()
        w_v = wkv[..., nope:].to(lat_dt).float()
        qh = (q[:, 0] * (1.0 / math.sqrt(qk_hd))).to(lat_dt).float()
        q_til = torch.einsum("bhn,rhn->bhr", qh[..., :nope], w_k
                             ).to(lat_dt).float()
        s = (torch.einsum("bhr,bsr->bhs", q_til, latent_all)
             + torch.einsum("bhd,bsd->bhs", qh[..., nope:], k_rope_all))
        pos = torch.arange(lat_cache.shape[1], device=x.device)
        s = s.masked_fill(pos > cur_index, NEG_INF)
        p = torch.softmax(s, dim=-1).to(lat_dt).float()
        ctx = torch.einsum("bhs,bsr->bhr", p, latent_all).to(lat_dt).float()
        o = torch.einsum("bhr,rhv->bhv", ctx, w_v).to(x.dtype)
        return o.reshape(B, S, -1) @ params["wo"], cache

    kv = (latent @ params["wkv_b"]).reshape(B, S, num_heads, nope + vd)
    k = torch.cat([kv[..., :nope],
                   k_rope.expand(B, S, num_heads, rd)], dim=-1)
    o = blocked_attention(q, k, F.pad(kv[..., nope:], (0, qk_hd - vd)),
                          q_positions=positions, kv_positions=positions,
                          causal=True, kv_chunk=kv_chunk)[..., :vd]
    entry = torch.cat([latent, k_rope[:, :, 0]], dim=-1)
    return o.reshape(B, S, -1) @ params["wo"], {"latent": entry}


def mla_cache_shape(batch: int, seq: int, mla):
    return {"latent": (batch, seq, mla.kv_lora_rank + mla.qk_rope_head_dim)}


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_swiglu(gen: torch.Generator, d_model: int, d_ff: int, dtype,
                device) -> Params:
    return {
        "w_gate": dense_init(gen, (d_model, d_ff), d_model, dtype, device),
        "w_up": dense_init(gen, (d_model, d_ff), d_model, dtype, device),
        "w_down": dense_init(gen, (d_ff, d_model), d_ff, dtype, device),
    }


def apply_swiglu(params: Params, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ params["w_gate"]) * (x @ params["w_up"])) \
        @ params["w_down"]


def init_gelu_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype,
                  device) -> Params:
    return {
        "w_in": dense_init(gen, (d_model, d_ff), d_model, dtype, device),
        "b_in": torch.zeros((d_ff,), dtype=dtype, device=device),
        "w_out": dense_init(gen, (d_ff, d_model), d_ff, dtype, device),
        "b_out": torch.zeros((d_model,), dtype=dtype, device=device),
    }


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation, in f32 (tanh
    through ``mathfn``), returned in ``x.dtype``."""
    xf = x.float()
    inner = math.sqrt(2.0 / math.pi) * (xf + 0.044715 * xf * xf * xf)
    return (xf * (0.5 * (1.0 + mathfn.tanh(inner)))).to(x.dtype)


def apply_gelu_mlp(params: Params, x: torch.Tensor) -> torch.Tensor:
    return gelu(x @ params["w_in"] + params["b_in"]) @ params["w_out"] \
        + params["b_out"]
