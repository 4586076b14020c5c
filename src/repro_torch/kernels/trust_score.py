"""K1: per-worker trust statistics of the packed (W, D) update matrix.

Against the consensus c = mean_w u_w::

    dot[w] = <u_w, c>      sq_u[w] = ‖u_w‖²      sq_c = ‖c‖²

everything ``EvaluatePerformance`` needs for the cosine and norm terms.
``trust_score_stats`` launches the CUDA kernel (``csrc/trust_score.cu``)
for a tensor on the card and runs the plain version, ``trust_score_ref``,
for a tensor on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def trust_score_ref(updates: torch.Tensor):
    """Plain PyTorch version: (W, D) → (dot (W,), sq_u (W,), sq_c ()) f32."""
    u = updates.float()
    c = u.mean(dim=0)
    return u @ c, (u * u).sum(dim=1), (c * c).sum()


def trust_score_stats(updates: torch.Tensor):
    """(W, D) float32 or bfloat16 → (dot (W,), sq_u (W,), sq_c ()) float32,
    read in f32 and summed in f32 in a fixed order. On a CUDA tensor this
    launches the kernel (and counts the launch in ``.launches``); on a CPU
    tensor it returns the plain version."""
    _build.check_updates(updates)
    if updates.device.type == "cpu":
        return trust_score_ref(updates)
    W, D = updates.shape
    dev = updates.device
    f32 = dict(dtype=torch.float32, device=dev)
    partial = torch.empty((_build.splits(W), D), **f32)
    c = torch.empty((D,), **f32)
    dot = torch.empty((W,), **f32)
    sq_u = torch.empty((W,), **f32)
    sq_c = torch.empty((), **f32)
    _build.launch("repro_trust_score", dev, _build.ptr(updates),
                  int(updates.dtype == torch.bfloat16), W, D,
                  _build.SPLIT_ROWS, _build.ptr(partial), _build.ptr(c),
                  _build.ptr(dot), _build.ptr(sq_u), _build.ptr(sq_c))
    trust_score_stats.launches += 1
    return dot, sq_u, sq_c


trust_score_stats.launches = 0


def hbm_bytes(W: int, D: int, itemsize: int) -> dict:
    """HBM traffic of one K1 call in the port's geometry: the update matrix
    is streamed twice (column pass, then row pass), plus the partials'
    write and read, the consensus written once and read by the row pass
    (from L2), and the (2W + 1) f32 outputs. ``minimum`` counts each input
    read once and each output written once."""
    upd = W * D * itemsize
    other = 2 * _build.splits(W) * D * 4 + 2 * D * 4 + (2 * W + 1) * 4
    return {"update_read": 2 * upd, "other": other,
            "total": 2 * upd + other, "minimum": upd + (2 * W + 1) * 4}
