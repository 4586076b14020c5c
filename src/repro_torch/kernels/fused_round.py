"""The fused trust round: K3, the async aggregate and flush, and the HBM
accounting of the whole fused chain.

The round streams the (W, D) update matrix through the trust kernels, each
reading it from HBM once, so twice a round, as the TPU chain does:

  K1  ``trust_score.trust_score_stats``  dot / sq_u / sq_c
  (O(W) score and weight math in ``core.trust`` / ``core.async_agg``)
  K2  ``trust_agg.trust_agg``            the sync aggregate, or
  K3  ``fused_async_agg``                in async mode, the aggregate of
                                         (pending + update) AND the flushed
                                         pending buffer in the same pass

``fused_async_agg`` launches the CUDA kernel (``csrc/fused_async_agg.cu``)
for tensors on the card and runs the plain version,
``fused_async_agg_ref``, for tensors on the CPU. The pending buffer is
unpadded (W, D) float32: the TPU's (256, 512) tile padding does not carry
over, and ``core.fl_step.init_async_state_for`` allocates this shape.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, trust_agg, trust_score


def fused_async_agg_ref(updates: torch.Tensor, pending: torch.Tensor,
                        weights: torch.Tensor, keep: torch.Tensor):
    """Plain PyTorch version: total = pending + updates (f32);
    agg = Σ_w weights[w]·total[w]; new_pending = total·keep[:, None].
    → ((D,) f32, (W, D) f32)."""
    total = pending.float() + updates.float()
    agg = torch.einsum("w,wd->d", weights.float(), total)
    return agg, total * keep.float()[:, None]


def fused_async_agg(updates: torch.Tensor, pending: torch.Tensor,
                    weights: torch.Tensor, keep: torch.Tensor):
    """updates (W, D) float32 or bfloat16; pending (W, D) float32;
    weights, keep (W,) float32 → (agg (D,) float32, new_pending (W, D)
    float32) in one pass over the update matrix. On CUDA tensors this
    launches the kernel (counted in ``.launches``); on CPU tensors it
    returns the plain version."""
    _build.check_updates(updates)
    W, D = updates.shape
    _build.check_operand(pending, "pending", (W, D), updates)
    _build.check_operand(weights, "weights", (W,), updates)
    _build.check_operand(keep, "keep", (W,), updates)
    if updates.device.type == "cpu":
        return fused_async_agg_ref(updates, pending, weights, keep)
    _build.check_no_grad("fused_async_agg", updates, pending, weights,
                         keep)
    dev = updates.device
    f32 = dict(dtype=torch.float32, device=dev)
    partial = torch.empty((_build.splits(W), D), **f32)
    agg = torch.empty((D,), **f32)
    new_pending = torch.empty((W, D), **f32)
    _build.launch("repro_fused_async_agg", dev, _build.ptr(updates),
                  int(updates.dtype == torch.bfloat16), _build.ptr(pending),
                  _build.ptr(weights), _build.ptr(keep), W, D,
                  _build.SPLIT_ROWS, _build.ptr(partial), _build.ptr(agg),
                  _build.ptr(new_pending))
    fused_async_agg.launches += 1
    return agg, new_pending


fused_async_agg.launches = 0


def hbm_bytes(W: int, D: int, itemsize: int) -> dict:
    """HBM traffic of one K3 call: the update matrix once, pending read and
    new pending written (f32), weights and keep, the partials' write and
    read, and the (D,) aggregate. ``minimum`` counts each input read once
    and each output written once."""
    upd = W * D * itemsize
    other = 2 * W * D * 4 + 2 * W * 4 + 2 * _build.splits(W) * D * 4 + D * 4
    return {"update_read": upd, "other": other, "total": upd + other,
            "minimum": upd + 2 * W * D * 4 + 2 * W * 4 + D * 4}


def streamed_bytes(W: int, D: int, dtype: torch.dtype, *,
                   async_mode: bool = False) -> dict:
    """Per-round HBM traffic of the fused chain (K1, then K2 or K3) in the
    port's own geometry: each kernel's ``hbm_bytes``, the update matrix
    once each. Returns {update_read, other, total} in bytes."""
    isz = torch.empty((), dtype=dtype).element_size()
    parts = [trust_score.hbm_bytes(W, D, isz),
             (hbm_bytes if async_mode else trust_agg.hbm_bytes)(W, D, isz)]
    return {k: float(sum(p[k] for p in parts))
            for k in ("update_read", "other", "total")}


def update_passes(W: int, D: int, dtype: torch.dtype, *,
                  async_mode: bool = False) -> float:
    """How many times the fused chain streams the W×D update volume: 2 (K1,
    then K2 or K3), as in the TPU chain."""
    isz = torch.empty((), dtype=dtype).element_size()
    return streamed_bytes(W, D, dtype, async_mode=async_mode)[
        "update_read"] / (W * D * isz)
