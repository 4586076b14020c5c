"""State-space blocks of the port (``repro.models.ssm``): Mamba2 (SSD), which
the zamba2 hybrid uses, and xLSTM's mLSTM and sLSTM blocks.

The compute core is ``chunked_decay_attention``, chunkwise
linear-attention-with-scalar-decay

    y_t = q_t · ( Σ_{j<=t}  exp(Σ_{l=j+1..t} a_l) · i_j · (k_j ⊗ v_j) )

which is Mamba2's SSD with q = C, k = B, v = x, a = Δ·A, i = Δ. On the card
it is the K4 kernel (``kernels.ssd_scan``); on the CPU its plain version,
the reference's chunked algorithm (``ssd_scan.ssd_scan_ref``, beside
``ssd_scan.segsum``, the reference's ``_segsum``). Under grad both go
through K4's ``autograd.Function``, whose backward is the K4 backward
kernel on the card and the plain backward on the CPU, where the reference
takes XLA's autodiff of the jnp scan. Recurrences run in f32; block edges
cast back, as in the reference.

mLSTM runs the same core at its own heads (dk = dh, dv = dh + 1: v with
the normalizer's ones column appended), which on the card is K4's wide
path; it hands K4 f32 q and k (upcast from the model dtype, exact), as the
reference's core upcasts them; under grad its backward is K4's wide
backward kernel on the card. sLSTM is a strict scan over the sequence, a
Python loop of eager ops here as ``lax.scan`` is in the reference; the
reference has no kernel there. Under grad the loop is ``_SLSTMScan``, the
reference's hand-written VJP of the scan (``_slstm_scan``'s
``custom_vjp``): the backward walks the steps in reverse with the gate
derivatives written out.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch import mathfn
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models.layers import dense_init, rms_norm

Params = Dict[str, torch.Tensor]
MAMBA_HEAD_DIM = 64


# ---------------------------------------------------------------------------
# chunked decay attention (SSD core)
# ---------------------------------------------------------------------------

def chunked_decay_attention(q, k, v, a, i, *, chunk: int,
                            initial_state=None, return_state: bool = False):
    """q: (B,S,H,dk), k: (B,S,H,dk), v: (B,S,H,dv), a: (B,S,H) log-decay,
    i: (B,S,H) input scale. Returns (y (B,S,H,dv)[, final_state
    (B,H,dk,dv) f32])."""
    y, h = ssd_scan(q, k, v, a, i, chunk=chunk, initial_state=initial_state)
    return (y, h) if return_state else y


def decay_attention_step(q, k, v, a, i, state):
    """Single decode step. q,k: (B,H,dk); v: (B,H,dv); a,i: (B,H);
    state: (B,H,dk,dv). Returns (y (B,H,dv), new_state), both f32."""
    q, k, v = q.float(), k.float(), v.float()
    new_state = (state * mathfn.exp(a)[..., None, None].float()
                 + i[..., None, None].float() * k[..., :, None]
                 * v[..., None, :])
    y = torch.einsum("bhd,bhdv->bhv", q, new_state)
    return y, new_state


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------

def mamba2_dims(d_model: int, ssm_cfg):
    d_inner = ssm_cfg.expand * d_model
    nheads = d_inner // MAMBA_HEAD_DIM
    return d_inner, nheads


def init_mamba2(gen: torch.Generator, d_model: int, ssm_cfg, dtype,
                device) -> Params:
    d_inner, nheads = mamba2_dims(d_model, ssm_cfg)
    N, cw = ssm_cfg.state_dim, ssm_cfg.conv_width

    def randn(shape):
        # drawn on the generator's device and moved, as ``dense_init``: a
        # CPU generator gives the same weights for a seed on every device
        return torch.randn(shape, generator=gen, device=gen.device).to(device)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "w_z": dense_init(gen, (d_model, d_inner), d_model, dtype, device),
        "w_x": dense_init(gen, (d_model, d_inner), d_model, dtype, device),
        "w_bc": dense_init(gen, (d_model, 2 * N), d_model, dtype, device),
        "w_dt": dense_init(gen, (d_model, nheads), d_model, dtype, device),
        "conv_x": (randn((cw, d_inner)) * 0.1).to(dtype),
        "conv_bc": (randn((cw, 2 * N)) * 0.1).to(dtype),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nheads, **f32)),
        "dt_bias": torch.zeros((nheads,), **f32),
        "D": torch.ones((nheads,), **f32),
        "norm": torch.ones((d_inner,), dtype=dtype, device=device),
        "w_out": dense_init(gen, (d_inner, d_model), d_inner, dtype, device),
    }


def _causal_conv(x, w, conv_state=None):
    """Depthwise causal conv. x: (B,S,C), w: (cw,C).
    With conv_state (B,cw-1,C): single/streaming step, returns new state."""
    cw = w.shape[0]
    S = x.shape[1]
    if conv_state is None:
        pad = F.pad(x, (0, 0, cw - 1, 0))
    else:
        pad = torch.cat([conv_state.to(x.dtype), x], dim=1)
    wf = w.float()
    out = pad[:, 0:S].float() * wf[0]
    for j in range(1, cw):
        out = out + pad[:, j:j + S].float() * wf[j]
    out = F.silu(out.to(x.dtype))
    if conv_state is None:
        return out, None
    return out, pad[:, -(cw - 1):]


def apply_mamba2(params: Params, x, ssm_cfg, *, state=None, conv_state=None,
                 return_state: bool = False):
    """x: (B,S,d). Prefill/train when state is None; else decode (S==1).
    Decode returns (out, (ssm_state, conv_states)); prefill with
    ``return_state`` returns the same tuple (cache hand-off to decode)."""
    B, S, d = x.shape
    d_inner, nheads = params["w_x"].shape[1], params["A_log"].shape[0]
    N = ssm_cfg.state_dim
    cw = params["conv_x"].shape[0]
    z = x @ params["w_z"]
    xi = x @ params["w_x"]
    bc = x @ params["w_bc"]
    dt_raw = x @ params["w_dt"]

    decode = state is not None
    cs_x = cs_bc = None
    if decode:
        cs_x, cs_bc = conv_state
    elif return_state:
        # raw pre-conv tails become the streaming conv state
        cs_x = xi[:, -(cw - 1):]
        cs_bc = bc[:, -(cw - 1):]
    xi, cs_x_dec = _causal_conv(xi, params["conv_x"], cs_x if decode else None)
    bc, cs_bc_dec = _causal_conv(bc, params["conv_bc"],
                                 cs_bc if decode else None)
    if decode:
        cs_x, cs_bc = cs_x_dec, cs_bc_dec
    B_, C_ = bc[..., :N], bc[..., N:]

    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    A = -mathfn.exp(params["A_log"])                        # (H,) negative
    a = dt * A                                              # (B,S,H) log decay
    xh = xi.reshape(B, S, nheads, MAMBA_HEAD_DIM)
    # B_, C_ shared across heads (n_groups=1): head-stride-0 views, which K4
    # reads in place
    k = B_[:, :, None, :].expand(B, S, nheads, N)
    q = C_[:, :, None, :].expand(B, S, nheads, N)

    if decode:
        y, new_state = decay_attention_step(
            q[:, 0], k[:, 0], xh[:, 0], a[:, 0], dt[:, 0], state)
        y = y[:, None]                                      # (B,1,H,P)
    elif return_state:
        y, new_state = chunked_decay_attention(
            q, k, xh, a, dt, chunk=min(ssm_cfg.chunk_size, S),
            return_state=True)
    else:
        y = chunked_decay_attention(q, k, xh, a, dt,
                                    chunk=min(ssm_cfg.chunk_size, S))
        new_state = None

    y = y + params["D"][None, None, :, None] * xh.float()
    y = y.reshape(B, S, d_inner)
    y = rms_norm(y.to(x.dtype) * F.silu(z), params["norm"])
    out = y @ params["w_out"]
    if decode or return_state:
        return out, (new_state, (cs_x, cs_bc))
    return out


def mamba2_state_shape(batch: int, d_model: int, ssm_cfg):
    d_inner, nheads = mamba2_dims(d_model, ssm_cfg)
    cw = ssm_cfg.conv_width
    return {"ssm": (batch, nheads, ssm_cfg.state_dim, MAMBA_HEAD_DIM),
            "conv_x": (batch, cw - 1, d_inner),
            "conv_bc": (batch, cw - 1, 2 * ssm_cfg.state_dim)}


# ---------------------------------------------------------------------------
# mLSTM block (xLSTM) — matrix memory, exp gating, chunked via the SSD core
# ---------------------------------------------------------------------------

def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """log σ(x) = min(x, 0) - log1p(e^-|x|), in float64 through
    ``mathfn`` and rounded once to x's dtype (no op that MKL's vector math
    serves on the CPU). log1p(e) is log(u) e / (u - 1) with u = 1 + e
    (exact to rounding, and e itself where u rounds to 1)."""
    x64 = x.double()
    e = mathfn.exp(-x64.abs())
    u = 1.0 + e
    d = u - 1.0
    log1p = torch.where(d == 0, e, mathfn.log(u) * e / torch.where(
        d == 0, 1.0, d))
    return (torch.clamp(x64, max=0.0) - log1p).to(x.dtype)


def init_mlstm(gen: torch.Generator, d_model: int, ssm_cfg, dtype,
               device) -> Params:
    d_inner = ssm_cfg.expand * d_model
    H = max(ssm_cfg.num_ssm_heads, 1)
    dh = d_inner // H

    def randn(shape):
        return torch.randn(shape, generator=gen, device=gen.device).to(device)
    return {
        "w_up": dense_init(gen, (d_model, 2 * d_inner), d_model, dtype,
                           device),
        "conv": (randn((ssm_cfg.conv_width, d_inner)) * 0.1).to(dtype),
        # headwise (block-diagonal) q/k/v, as in the released xLSTM
        "w_q": dense_init(gen, (H, dh, dh), dh, dtype, device),
        "w_k": dense_init(gen, (H, dh, dh), dh, dtype, device),
        "w_v": dense_init(gen, (H, dh, dh), dh, dtype, device),
        "w_i": dense_init(gen, (d_inner, H), d_inner, torch.float32, device),
        "w_f": dense_init(gen, (d_inner, H), d_inner, torch.float32, device),
        # open forget gates at init
        "f_bias": torch.full((H,), 3.0, dtype=torch.float32, device=device),
        "norm": torch.ones((d_inner,), dtype=dtype, device=device),
        "w_down": dense_init(gen, (d_inner, d_model), d_inner, dtype,
                             device),
    }


def apply_mlstm(params: Params, x, ssm_cfg, *, state=None, conv_state=None,
                chunk: int = 256, return_state: bool = False):
    """x: (B,S,d). mLSTM via the decay-attention core with a = log σ(f̃)
    and i = exp(clip(ĩ, -10, 10)) as the input scale; the value carries a
    ones column whose output is the normalizer n_t. Decode when ``state``
    is given (S == 1): returns (out, (ssm_state, conv_state)); prefill with
    ``return_state`` returns the same, the conv state being the raw
    pre-conv tail."""
    B, S, d = x.shape
    d_inner = params["w_down"].shape[0]
    H = params["f_bias"].shape[0]
    dh = d_inner // H
    up = x @ params["w_up"]
    xp, z = up[..., :d_inner], up[..., d_inner:]

    decode = state is not None
    cw = params["conv"].shape[0]
    if not decode and return_state:
        tail = xp[:, -(cw - 1):]
    xc, cs = _causal_conv(xp, params["conv"],
                          conv_state if decode else None)
    if not decode and return_state:
        cs = tail

    xh = xc.reshape(B, S, H, dh)
    # the scale in the model dtype, as JAX takes a weakly typed scalar
    scale = torch.tensor(dh ** -0.5, dtype=x.dtype)
    q = torch.einsum("bshd,hde->bshe", xh, params["w_q"]) * scale
    k = torch.einsum("bshd,hde->bshe", xh, params["w_k"]) * scale
    v = torch.einsum("bshd,hde->bshe", xh, params["w_v"])
    f_t = xc.float() @ params["w_f"] + params["f_bias"]
    i_t = xc.float() @ params["w_i"]
    a = log_sigmoid(f_t)                                    # (B,S,H) log decay
    i = mathfn.exp(torch.clamp(i_t, -10.0, 10.0))           # clamped exp gate

    # the augmented value channel tracks the normalizer n_t
    v_aug = torch.cat([v.float(), v.new_ones((B, S, H, 1),
                                             dtype=torch.float32)], dim=-1)
    if decode:
        y, new_state = decay_attention_step(
            q[:, 0], k[:, 0], v_aug[:, 0], a[:, 0], i[:, 0], state)
        y = y[:, None]
    else:
        # f32 q and k, as the reference's core takes them (exact)
        y, new_state = chunked_decay_attention(
            q.float(), k.float(), v_aug, a, i, chunk=min(chunk, S),
            return_state=True)
    y, n = y[..., :dh], y[..., dh:]
    y = y / torch.clamp(n.abs(), min=1.0)                   # xLSTM normalizer

    y = y.reshape(B, S, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["norm"])
    out = y @ params["w_down"]
    if decode or return_state:
        return out, (new_state, cs)
    return out


def mlstm_state_shape(batch: int, d_model: int, ssm_cfg):
    d_inner = ssm_cfg.expand * d_model
    H = max(ssm_cfg.num_ssm_heads, 1)
    dh = d_inner // H
    return {"ssm": (batch, H, dh, dh + 1),
            "conv": (batch, ssm_cfg.conv_width - 1, d_inner)}


# ---------------------------------------------------------------------------
# sLSTM block (xLSTM) — scalar memory, strictly sequential scan
# ---------------------------------------------------------------------------

def init_slstm(gen: torch.Generator, d_model: int, num_heads: int, dtype,
               device) -> Params:
    dh = d_model // num_heads
    ffn = int(d_model * 4 / 3)
    ffn = (ffn + 127) // 128 * 128                          # lane-align
    return {
        # 4 gates (i, f, z, o) from input and block-diag recurrent R per head
        "w_gates": dense_init(gen, (d_model, 4 * d_model), d_model, dtype,
                              device),
        "r_gates": dense_init(gen, (num_heads, dh, 4 * dh), dh, dtype,
                              device),
        "b_gates": torch.zeros((4 * d_model,), dtype=torch.float32,
                               device=device),
        "norm": torch.ones((d_model,), dtype=dtype, device=device),
        "ffn_up": dense_init(gen, (d_model, 2 * ffn), d_model, dtype, device),
        "ffn_down": dense_init(gen, (ffn, d_model), ffn, dtype, device),
    }


def _gate_values(g, m, num_heads):
    """The gates of pre-activations g: (B, 4d) → (i', f', z, o, m_new). The
    stabilizer m_new is the larger of a head's largest forget
    pre-activation plus m and its largest input pre-activation; h is
    exactly invariant to it."""
    B = g.shape[0]
    d = g.shape[1] // 4
    dh = d // num_heads
    gi, gf, gz, go = torch.split(g, d, dim=-1)
    gi_h = gi.reshape(B, num_heads, dh)
    gf_h = gf.reshape(B, num_heads, dh)
    fi = gf_h.amax(dim=-1) + m                              # (B,H)
    ii = gi_h.amax(dim=-1)
    m_new = torch.maximum(fi, ii)
    i_p = mathfn.exp(gi_h - m_new[..., None]).reshape(B, d)
    f_p = mathfn.exp(gf_h + m[:, :, None] - m_new[:, :, None]).reshape(B, d)
    return i_p, f_p, mathfn.tanh(gz), torch.sigmoid(go), m_new


def _slstm_gates(g, c, n, m, num_heads):
    """Gate math given pre-activations g: (B, 4d) → (c, n, h, m) after the
    step."""
    i_p, f_p, z, o, m_new = _gate_values(g, m, num_heads)
    c_new = f_p * c + i_p * z
    n_new = f_p * n + i_p
    h_new = o * c_new / torch.clamp(n_new, min=1e-6)
    return c_new, n_new, h_new, m_new


def _slstm_cell(r32, b_gates, num_heads, x_t, carry):
    """One sLSTM step. x_t: (B, 4d) pre-activations from the input path;
    r32: the f32 recurrent weights (H, dh, 4 dh); carry: (c, n, h, m) each
    (B, d) except m (B, H). The recurrent term's (B, H, 4 dh) layout is
    added to the gate-major pre-activations as is, as in the reference."""
    c, n, h, m = carry
    B, d = h.shape
    dh = d // num_heads
    rec = torch.einsum("bhd,hde->bhe", h.reshape(B, num_heads, dh),
                       r32).reshape(B, 4 * d)
    g = x_t + rec + b_gates
    return _slstm_gates(g, c, n, m, num_heads)


def _slstm_gates_vjp(g, c, n, m, num_heads, dc_new, dn_new, dh_new):
    """The VJP of ``_slstm_gates`` in (g, c, n) with m held fixed (the
    reference stops the stabilizer's gradient; m_new depends on g only
    through it): given the cotangents of c_new, n_new and h_new, returns
    (dg, dc, dn). The derivatives are XLA's: tanh' = 1 - z², sigmoid' =
    o (1 - o), and the clamp of n_new at 1e-6 passes its whole gradient
    above, half at, and none below it (``jnp.maximum``)."""
    i_p, f_p, z, o, _ = _gate_values(g, m, num_heads)
    c_new = f_p * c + i_p * z
    n_new = f_p * n + i_p
    den = torch.clamp(n_new, min=1e-6)
    # h_new = (o c_new) / den
    q = dh_new / den
    do = q * c_new
    dc_t = dc_new + q * o
    pass_n = (n_new > 1e-6).float() + 0.5 * (n_new == 1e-6).float()
    dn_t = dn_new - dh_new * (o * c_new) / (den * den) * pass_n
    dgi = (dc_t * z + dn_t) * i_p
    dgf = (dc_t * c + dn_t * n) * f_p
    dgz = dc_t * i_p * (1.0 - z * z)
    dgo = do * o * (1.0 - o)
    return (torch.cat([dgi, dgf, dgz, dgo], dim=-1), dc_t * f_p,
            dn_t * f_p)


class _SLSTMScan(torch.autograd.Function):
    """The sLSTM scan under autograd, the reference's ``_slstm_scan`` with
    its ``custom_vjp``: (r_gates, b_gates, pre (B, S, 4d) f32, the carry
    (c, n, h, m) f32) → (c, n, h, m after the last step, hs (B, S, d)). The
    forward is ``_slstm_cell``'s loop and keeps the carry before each step;
    the backward walks the steps in reverse, the gate derivatives written
    out (``_slstm_gates_vjp``: a host loop of eager ops, no autograd graph
    a step), accumulating dR batch-expanded (B, H, dh, 4 dh) and db (B, 4d)
    in f32, each reduced over the batch once after the loop as the
    reference does. m gets no gradient."""

    @staticmethod
    def forward(ctx, r_gates, b_gates, pre, num_heads, c, n, h, m):
        r32 = r_gates.float()
        carry = (c, n, h, m)
        before, hs = [], []
        for t in range(pre.shape[1]):
            before.append(carry)
            carry = _slstm_cell(r32, b_gates, num_heads, pre[:, t], carry)
            hs.append(carry[2])
        ctx.num_heads = num_heads
        ctx.save_for_backward(r_gates, b_gates, pre,
                              *(torch.stack(x, dim=1) for x in zip(*before)))
        ctx.mark_non_differentiable(carry[3])
        return (*carry, torch.stack(hs, dim=1))

    @staticmethod
    def backward(ctx, dc, dn, dh, dm, dhs):
        r_gates, b_gates, pre, cs, ns, hs_before, ms = ctx.saved_tensors
        H = ctx.num_heads
        B, S, d4 = pre.shape
        d = d4 // 4
        dh_ = d // H
        r32 = r_gates.float()
        f32 = dict(dtype=torch.float32, device=pre.device)
        dc, dn, dh = (torch.zeros((B, d), **f32) if x is None else x.float()
                      for x in (dc, dn, dh))
        dr = torch.zeros((B, H, dh_, 4 * dh_), **f32)
        db = torch.zeros((B, d4), **f32)
        d_pre = torch.empty((B, S, d4), **f32)
        for t in reversed(range(S)):
            hh = hs_before[:, t].reshape(B, H, dh_)
            rec = torch.einsum("bhd,hde->bhe", hh, r32).reshape(B, d4)
            g = pre[:, t] + rec + b_gates
            dh_t = dh if dhs is None else dh + dhs[:, t]
            dg, dc, dn = _slstm_gates_vjp(g, cs[:, t], ns[:, t], ms[:, t], H,
                                          dc, dn, dh_t)
            d_pre[:, t] = dg
            dg_h = dg.reshape(B, H, 4 * dh_)
            dh = torch.einsum("bhe,hde->bhd", dg_h, r32).reshape(B, d)
            dr.addcmul_(hh[..., :, None], dg_h[..., None, :])
            db += dg
        return (dr.sum(dim=0).to(r_gates.dtype),
                db.sum(dim=0).to(b_gates.dtype), d_pre.to(pre.dtype), None,
                dc, dn, dh, None)


def apply_slstm(params: Params, x, num_heads: int, *, carry=None,
                return_state: bool = False):
    """x: (B,S,d). Sequential over S (a Python loop of ``_slstm_cell``,
    the reference's ``lax.scan``; ``_SLSTMScan``, its hand-written VJP, when
    autograd records). Returns out (+ the carry (c, n, h, m), f32, when
    streaming or ``return_state``). The FFN's GELU is the tanh
    approximation, ``jax.nn.gelu``'s default."""
    B, S, d = x.shape
    stream = carry is not None or return_state
    pre = (x @ params["w_gates"]).float()                   # (B,S,4d)
    if carry is None:
        z32 = x.new_zeros((B, d), dtype=torch.float32)
        carry = (z32, z32, z32, x.new_zeros((B, num_heads),
                                            dtype=torch.float32))
    else:
        carry = tuple(t.float() for t in carry)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (pre, params["r_gates"],
                                      params["b_gates"], *carry)):
        *carry, hs = _SLSTMScan.apply(params["r_gates"], params["b_gates"],
                                      pre, num_heads, *carry)
        carry = tuple(carry)
    else:
        r32 = params["r_gates"].float()
        hs = []
        for t in range(S):
            carry = _slstm_cell(r32, params["b_gates"], num_heads,
                                pre[:, t], carry)
            hs.append(carry[2])
        hs = torch.stack(hs, dim=1)
    y = hs.to(x.dtype)                                      # (B,S,d)
    y = rms_norm(y, params["norm"])
    u = y @ params["ffn_up"]
    ffn = params["ffn_down"].shape[0]
    y = (F.gelu(u[..., :ffn], approximate="tanh") * u[..., ffn:]) \
        @ params["ffn_down"]
    if stream:
        return y, carry
    return y


def slstm_state_shape(batch: int, d_model: int, num_heads: int):
    return {"c": (batch, d_model), "n": (batch, d_model),
            "h": (batch, d_model), "m": (batch, num_heads)}
