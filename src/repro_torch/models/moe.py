"""Mixture-of-Experts layer of the port (qwen2-moe, olmoe) —
``repro.models.moe``.

Two implementations, as in the reference:

* ``apply_moe(..., impl="gather")`` — the production path. Each expert
  takes its top-C tokens by routing weight (capacity-based, GShard-style
  dropping), gathers them into an (E, C, d) batch, runs the SwiGLU experts
  as batched products (``torch.bmm``) and adds each token's expert outputs
  back.
* ``apply_moe(..., impl="dense")`` — the oracle: every token through every
  expert, mask-weighted. Tests hold the gather path to it.

Params are a flat dict: ``router`` (d, E) and the shared gate
``shared.gate`` (d, 1) in f32, the experts ``w_gate``, ``w_up`` (E, d, f)
and ``w_down`` (E, f, d) in the model dtype, and with shared experts
``shared.w_gate``, ``shared.w_up`` (d, n·f_sh), ``shared.w_down``. A tree
built by the reference at ``tp > 1`` has padded experts; E is taken from
the router's columns, and the padded ones get -1e30 logits (never chosen).

**Selection.** ``jax.lax.top_k`` puts the lower index first among equal
values; ``torch.topk`` promises no order for ties. Ties are real at the
capacity boundary (identical tokens; position 0 of rows that start with
the same token). Both selections here are a stable descending sort, then
the first k or C: the same experts and the same dropped tokens as the
reference.

**Fixed order, no float atomics.** The reference combines with a
scatter-add (``out.at[top_idx].add(...)``), and the backward of its
dispatch (``jnp.take``) is a scatter-add too. Their direct translations
(``index_add_``, ``index_put_(accumulate=True)``, ``scatter_add_``, the
backward of indexing) add through float atomics on the card, in an order
that changes from run to run. Here both directions are gathers
(``_Dispatch``, ``_Combine``): every (expert, slot) holds one token, so a
token's output is the sum over its routed experts, in ascending expert
order, of ``w · ye[e, slot]`` — the order in which XLA's CPU scatter
applies the flattened (e, c) updates. A fill slot (a token an expert took
with weight 0) adds ±0 in the reference and is skipped here; so is its
gradient, which is exactly 0.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch import mathfn
from repro_torch.models.layers import dense_init

Params = Dict[str, torch.Tensor]
NEG_INF = -1e30


def padded_experts(num_experts: int, tp: int) -> int:
    return int(math.ceil(num_experts / max(tp, 1)) * max(tp, 1))


def init_moe(gen: torch.Generator, d_model: int, moe_cfg, dtype, device,
             tp: int = 1) -> Params:
    """Router + routed experts (+ the always-on shared experts), flat."""
    E = padded_experts(moe_cfg.num_experts, tp)
    f = moe_cfg.d_ff_expert
    params = {
        "router": dense_init(gen, (d_model, E), d_model, torch.float32,
                             device),
        "w_gate": dense_init(gen, (E, d_model, f), d_model, dtype, device),
        "w_up": dense_init(gen, (E, d_model, f), d_model, dtype, device),
        "w_down": dense_init(gen, (E, f, d_model), f, dtype, device),
    }
    if moe_cfg.num_shared_experts > 0:
        fsh = moe_cfg.num_shared_experts * moe_cfg.d_ff_shared
        params.update({
            "shared.w_gate": dense_init(gen, (d_model, fsh), d_model, dtype,
                                        device),
            "shared.w_up": dense_init(gen, (d_model, fsh), d_model, dtype,
                                      device),
            "shared.w_down": dense_init(gen, (fsh, d_model), fsh, dtype,
                                        device),
            "shared.gate": dense_init(gen, (d_model, 1), d_model,
                                      torch.float32, device),
        })
    return params


def _router_probs(params, x_flat: torch.Tensor, moe_cfg):
    """x_flat: (T, d) -> (probs (T, E) f32 with pads masked, logits)."""
    E_pad = params["router"].shape[1]
    logits = x_flat.float() @ params["router"]
    real = torch.arange(E_pad, device=logits.device) < moe_cfg.num_experts
    logits = logits.masked_fill(~real, NEG_INF)
    return torch.softmax(logits, dim=-1), logits


def _topk(x: torch.Tensor, k: int):
    """The k largest of each row, the lower index first among equal values
    (``jax.lax.top_k``'s order): (values, indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _topk_weights(probs: torch.Tensor, top_k: int):
    """(T, E) -> (sparse weight matrix (T, E) of the renormalized top-k
    probs, the top-k expert indices (T, k))."""
    vals, idx = _topk(probs, top_k)
    vals = vals / vals.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return torch.zeros_like(probs).scatter(1, idx, vals), idx


def _logsumexp(x: torch.Tensor) -> torch.Tensor:
    """logsumexp over the last axis through ``mathfn`` (fault F2)."""
    m = x.amax(dim=-1, keepdim=True).detach()
    return (m + mathfn.log(mathfn.exp(x - m).sum(dim=-1, keepdim=True))
            ).squeeze(-1)


def _aux_losses(probs, w, logits, moe_cfg) -> torch.Tensor:
    """GShard load-balance loss + router z-loss, f32."""
    E = moe_cfg.num_experts
    frac_routed = (w > 0).float().mean(dim=0) * E                 # (E_pad,)
    mean_prob = probs.mean(dim=0) * E
    lb = (frac_routed * mean_prob).sum() / E
    z = _logsumexp(logits).square().mean()
    return moe_cfg.router_aux_loss * lb + moe_cfg.router_z_loss * z


def _expert_ffn(params, xe: torch.Tensor) -> torch.Tensor:
    """xe: (E, C, d) -> (E, C, d); SwiGLU batched over the experts."""
    g = torch.bmm(xe, params["w_gate"])
    u = torch.bmm(xe, params["w_up"])
    return torch.bmm(F.silu(g) * u, params["w_down"])


def capacity(moe_cfg, T: int, capacity_factor: float) -> int:
    """C = ceil(k·T/E·cf), at least 1 and at most T (the reference's
    Python float arithmetic)."""
    C = max(1, int(math.ceil(moe_cfg.top_k * T / moe_cfg.num_experts
                             * capacity_factor)))
    return min(C, T)


@torch.no_grad()
def _routes(w: torch.Tensor, idx: torch.Tensor, C: int):
    """The capacity plan. w: (T, E) routing weights; idx: (T, k) each
    token's experts. Returns

      top_idx (E, C)  each expert's C tokens, by weight, the lower token
                      first among equals (``jax.lax.top_k`` on w.T)
      ek      (T, k)  each token's experts in ascending order
      flat    (T, k)  the row of (E·C) that holds (token, ek), 0 where
                      the expert dropped the token
      kept    (T, k)  whether the expert kept the token
    """
    T, E = w.shape
    top_idx = _topk(w.T, C)[1]
    slot = torch.full((E, T), -1, dtype=torch.int64, device=w.device)
    slot.scatter_(1, top_idx, torch.arange(C, device=w.device).expand(E, C))
    ek = idx.sort(dim=1).values
    s = slot.T.gather(1, ek)
    kept = s >= 0
    return top_idx, ek, ek * C + s.clamp_min(0), kept


class _Dispatch(torch.autograd.Function):
    """xe = x[top_idx] (E·C, d); its backward gathers each token's
    gradient from the slots that hold it, in ascending expert order."""

    @staticmethod
    def forward(ctx, x, top_idx, flat, kept):
        ctx.save_for_backward(flat, kept)
        return x.index_select(0, top_idx.reshape(-1))

    @staticmethod
    def backward(ctx, dxe):
        flat, kept = ctx.saved_tensors
        dx = dxe.new_zeros((flat.shape[0], dxe.shape[1]))
        for j in range(flat.shape[1]):
            dx = dx + torch.where(kept[:, j, None],
                                  dxe.index_select(0, flat[:, j]), 0)
        return dx, None, None, None


class _Combine(torch.autograd.Function):
    """out[t] = Σ over t's kept experts e, ascending, of w[t, e] ·
    ye[slot of t in e] (f32). ye: (E·C, d) f32; w: (T, E) f32. Backward:
    dye[e, s] = w[t, e] · dout[t] for the token t in slot (e, s) (0 for a
    fill slot), dw[t, e] = dout[t] · ye[slot] for t's kept experts."""

    @staticmethod
    def forward(ctx, ye, w, top_idx, ek, flat, kept):
        wk = w.gather(1, ek)
        out = ye.new_zeros((w.shape[0], ye.shape[1]))
        for j in range(ek.shape[1]):
            out = out + torch.where(kept[:, j, None],
                                    wk[:, j, None]
                                    * ye.index_select(0, flat[:, j]), 0)
        ctx.save_for_backward(ye, w, top_idx, ek, flat, kept)
        return out

    @staticmethod
    def backward(ctx, dout):
        ye, w, top_idx, ek, flat, kept = ctx.saved_tensors
        dye = dw = None
        if ctx.needs_input_grad[0]:
            rows = top_idx.reshape(-1)
            dye = w.T.gather(1, top_idx).reshape(-1, 1) \
                * dout.index_select(0, rows)
        if ctx.needs_input_grad[1]:
            dk = torch.stack([(dout * ye.index_select(0, flat[:, j])
                               ).sum(dim=-1) for j in range(ek.shape[1])], 1)
            dw = torch.zeros_like(w).scatter_(1, ek,
                                              torch.where(kept, dk, 0))
        return dye, dw, None, None, None, None


def _shared(params) -> Params:
    """The shared experts' params, from a layer's nested dict
    (``params["shared"]``) or from ``init_moe``'s flat one."""
    if "shared" in params:
        return params["shared"]
    return {k[len("shared."):]: v for k, v in params.items()
            if k.startswith("shared.")}


def apply_moe(params, x: torch.Tensor, moe_cfg, *,
              capacity_factor: float = 0.0,
              impl: str = "gather") -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d). Returns (out (B, S, d) in x's dtype, aux_loss f32
    scalar). capacity_factor 0 => take moe_cfg.capacity_factor."""
    capacity_factor = capacity_factor or moe_cfg.capacity_factor
    B, S, d = x.shape
    T = B * S
    x_flat = x.reshape(T, d)
    probs, logits = _router_probs(params, x_flat, moe_cfg)
    w, idx = _topk_weights(probs, moe_cfg.top_k)            # (T, E_pad)
    aux = _aux_losses(probs, w, logits, moe_cfg)
    E_pad = w.shape[1]

    if impl == "dense":
        # oracle: all tokens through all experts, weighted combine
        g = torch.einsum("td,edf->tef", x_flat, params["w_gate"])
        u = torch.einsum("td,edf->tef", x_flat, params["w_up"])
        y = torch.einsum("tef,efd->ted", F.silu(g) * u, params["w_down"])
        out = torch.einsum("ted,te->td", y.float(), w)
    elif impl == "gather":
        C = capacity(moe_cfg, T, capacity_factor)
        top_idx, ek, flat, kept = _routes(w, idx, C)
        xe = _Dispatch.apply(x_flat, top_idx, flat, kept).reshape(E_pad, C,
                                                                  d)
        ye = _expert_ffn(params, xe).float().reshape(E_pad * C, d)
        out = _Combine.apply(ye, w, top_idx, ek, flat, kept)
    else:
        raise ValueError(f"impl must be gather|dense, got {impl!r}")

    sp = _shared(params)
    if sp:
        shared = (F.silu(x_flat @ sp["w_gate"]) * (x_flat @ sp["w_up"])) \
            @ sp["w_down"]
        gate = torch.sigmoid(x_flat.float() @ sp["gate"])
        out = out + gate * shared.float()

    return out.reshape(B, S, d).to(x.dtype), aux
