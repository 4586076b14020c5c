"""State-space blocks of the port: the Mamba2 (SSD) subset of
``repro.models.ssm`` that the zamba2 hybrid uses.

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
cast back, as in the reference. The mLSTM and sLSTM blocks of the
reference's module wait for the xLSTM slice.
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
