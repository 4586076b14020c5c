"""K2: trust-weighted aggregate of the packed (W, D) update matrix.

``out[d] = Σ_w weights[w] · updates[w, d]`` — the cluster-head hot loop of
the sync round. ``trust_agg`` launches the CUDA kernel
(``csrc/trust_agg.cu``) for a tensor on the card and runs the plain
version, ``trust_agg_ref``, for a tensor on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def trust_agg_ref(updates: torch.Tensor, weights: torch.Tensor
                  ) -> torch.Tensor:
    """Plain PyTorch version: (W, D) × (W,) → (D,) f32."""
    return torch.einsum("w,wd->d", weights.float(), updates.float())


def trust_agg(updates: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """updates (W, D) float32 or bfloat16, weights (W,) float32 → (D,)
    float32, summed over W in a fixed order. On a CUDA tensor this launches
    the kernel (counted in ``.launches``); on a CPU tensor it returns the
    plain version."""
    _build.check_updates(updates)
    W, D = updates.shape
    _build.check_operand(weights, "weights", (W,), updates)
    if updates.device.type == "cpu":
        return trust_agg_ref(updates, weights)
    dev = updates.device
    partial = torch.empty((_build.splits(W), D), dtype=torch.float32,
                          device=dev)
    out = torch.empty((D,), dtype=torch.float32, device=dev)
    _build.launch("repro_trust_agg", dev, _build.ptr(updates),
                  int(updates.dtype == torch.bfloat16), _build.ptr(weights),
                  W, D, _build.SPLIT_ROWS, _build.ptr(partial),
                  _build.ptr(out))
    trust_agg.launches += 1
    return out


trust_agg.launches = 0


def hbm_bytes(W: int, D: int, itemsize: int) -> dict:
    """HBM traffic of one K2 call: the update matrix once, the weights,
    the partials' write and read, and the (D,) output. ``minimum`` counts
    each input read once and each output written once."""
    upd = W * D * itemsize
    other = W * 4 + 2 * _build.splits(W) * D * 4 + D * 4
    return {"update_read": upd, "other": other, "total": upd + other,
            "minimum": upd + W * 4 + D * 4}
