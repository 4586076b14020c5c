"""K2: trust-weighted aggregate of the packed (W, D) update matrix.

``out[d] = Σ_w weights[w] · updates[w, d]`` — the cluster-head hot loop of
the sync round. ``trust_agg`` launches the CUDA kernel
(``csrc/trust_agg.cu``) for a tensor on the card and runs the plain
version, ``trust_agg_ref``, for a tensor on the CPU.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build

SMS = 132              # streaming multiprocessors of an H100 SXM
THREADS = 32           # threads per block (kThreads in csrc/trust_agg.cu)
MAX_SPLITS = 8
MIN_SPLIT_ROWS = 64    # rows a split must have before W is cut further


class Plan(NamedTuple):
    """One launch of K2: a block of THREADS threads per column tile,
    ``vec`` columns per thread, and ``splits`` row splits of ``rows`` rows
    per tile (split ``s`` takes rows ``[s * rows, min(W, (s + 1) * rows))``);
    the grid is ``tiles`` x ``splits`` blocks."""
    vec: int
    tiles: int
    splits: int
    rows: int


def plan(W: int, D: int, itemsize: int, aligned: bool = True) -> Plan:
    """32-thread column tiles (171 blocks at D = 21840 f32, more than the
    card's SMs); at large W up to MAX_SPLITS row splits of at least
    MIN_SPLIT_ROWS rows, which keeps ~85 KB of rows in flight per SM."""
    vec = 16 // itemsize
    if not aligned or D % vec:
        vec = 1
    tiles = -(-(-(-D // vec)) // THREADS)
    splits = max(1, min(MAX_SPLITS, W // MIN_SPLIT_ROWS))
    rows = -(-W // splits)
    return Plan(vec, tiles, -(-W // rows), rows)


def trust_agg_ref(updates: torch.Tensor, weights: torch.Tensor
                  ) -> torch.Tensor:
    """Plain PyTorch version: (W, D) × (W,) → (D,) f32."""
    return torch.einsum("w,wd->d", weights.float(), updates.float())


def trust_agg(updates: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """updates (W, D) float32 or bfloat16, weights (W,) float32 → (D,)
    float32, summed over W in a fixed order. On a CUDA tensor this launches
    the kernel (counted in ``.launches``; with more than one row split it
    uses a small scratch kept per device and stream, ``_build.scratch``; on
    a fake tensor the abstract branch, ``_build.abstract``); on a CPU
    tensor it returns the plain version."""
    _build.check_updates(updates)
    W, D = updates.shape
    _build.check_operand(weights, "weights", (W,), updates)
    if updates.device.type == "cpu":
        return trust_agg_ref(updates, weights)
    _build.check_no_grad("trust_agg", updates, weights)
    p = plan(W, D, updates.element_size(), _build.aligned16(updates))
    dev = _build.device_of(updates)
    out = torch.empty((D,), dtype=torch.float32, device=dev)
    if _build.is_fake(updates):
        _build.abstract("trust_agg", updates, flops=flops(W, D),
                        nbytes=hbm_bytes(W, D, updates.element_size())[
                            "total"],
                        scratch=_build.scratch_bytes(p.tiles, p.splits * D)
                        if p.splits > 1 else 0)
        return out
    cnt = part = None            # one split writes out directly
    if p.splits > 1:
        cnt, part = _build.scratch("trust_agg", dev, p.tiles, p.splits * D)
    _build.launch("repro_trust_agg", dev, _build.ptr(updates),
                  int(updates.dtype == torch.bfloat16), _build.ptr(weights),
                  W, D, p.vec, p.splits, _build.ptr(cnt),
                  _build.ptr(part), _build.ptr(out))
    trust_agg.launches += 1
    return out


trust_agg.launches = 0


def hbm_bytes(W: int, D: int, itemsize: int) -> dict:
    """HBM traffic of one K2 call: the update matrix once, the weights, the
    (D,) output, and with more than one split the splits' f32 sums, each
    written once and read once by the split that combines them. ``minimum``
    counts each input read once and each output written once."""
    upd = W * D * itemsize
    splits = plan(W, D, itemsize).splits
    partials = 0 if splits == 1 else 2 * splits * D * 4
    other = W * 4 + D * 4 + partials
    return {"update_read": upd, "other": other, "total": upd + other,
            "minimum": upd + W * 4 + D * 4}


def flops(W: int, D: int) -> int:
    """Multiply-adds of one K2 call (2 flops each)."""
    return 2 * W * D
