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

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build, trust_agg, trust_score

SMS = 132              # streaming multiprocessors of an H100 SXM
MAX_THREADS = 256      # widest block (kMaxThreads in csrc/fused_async_agg.cu)
THREADS = 32           # threads per block while W is too short to split
SPLIT_THREADS = 128    # threads per block where W has rows for splits
BLOCKS = 4 * SMS       # blocks the plan's row splits aim for
MIN_SPLIT_ROWS = 64    # rows a split must have before W is cut further

# errors the plain version can plant, so a check can show that its
# tolerance sees them (``chip_smoke.py`` and the tests)
FAULTS = ("keep_ignored",          # new pending = total, whatever keep says
          "pending_dropped",       # total = u: pending not added
          "last_row_dropped",      # row W - 1 in neither output
          "split_summed_twice",    # the plan's first split's sums added twice
          "weights_shifted")       # row r takes weights[r + 1]


class Plan(NamedTuple):
    """One launch of K3: a block of ``threads`` threads per column tile,
    ``vec`` columns per thread, and ``splits`` row splits of ``rows`` rows
    per tile (split ``s`` takes rows ``[s * rows, min(W, (s + 1) * rows))``);
    the grid is ``tiles`` x ``splits`` blocks."""
    vec: int
    threads: int
    tiles: int
    splits: int
    rows: int


def plan(W: int, D: int, itemsize: int, aligned: bool = True) -> Plan:
    """16-byte pieces where D and the alignment allow them (else one column
    a thread). Below 2 * MIN_SPLIT_ROWS rows: one row split and column
    tiles of THREADS threads (171 blocks at D = 21840 f32, more than the
    card's SMs). From there on: tiles of SPLIT_THREADS threads, cut into
    row splits of at least MIN_SPLIT_ROWS rows that bring the grid towards
    BLOCKS blocks. Depends on the shape alone, so the summation order does
    too."""
    vec = 16 // itemsize
    if not aligned or D % vec:
        vec = 1
    threads = SPLIT_THREADS if W >= 2 * MIN_SPLIT_ROWS else THREADS
    tiles = -(-(-(-D // vec)) // threads)
    splits = max(1, min(W // MIN_SPLIT_ROWS, -(-BLOCKS // tiles)))
    rows = -(-W // splits)
    return Plan(vec, threads, tiles, -(-W // rows), rows)


def fused_async_agg_ref(updates: torch.Tensor, pending: torch.Tensor,
                        weights: torch.Tensor, keep: torch.Tensor,
                        fault: Optional[str] = None):
    """Plain PyTorch version: total = pending + updates (f32);
    agg = Σ_w weights[w]·total[w]; new_pending = total·keep[:, None].
    → ((D,) f32, (W, D) f32). ``fault`` (one of ``FAULTS``) plants that
    error: keep ignored (new pending = total), pending not added (total =
    updates), the last row in neither output (its new pending 0), the first
    split of the kernel's plan for this shape summed twice (with one split,
    the whole aggregate), or row r weighted by weights[r + 1] (the last row
    by weights[0])."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; known: {FAULTS}")
    w = weights.float()
    total = updates.float() if fault == "pending_dropped" else \
        pending.float() + updates.float()
    if fault == "last_row_dropped":
        total = torch.cat([total[:-1], torch.zeros_like(total[-1:])])
    if fault == "weights_shifted":
        w = torch.roll(w, -1)
    agg = torch.einsum("w,wd->d", w, total)
    if fault == "split_summed_twice":
        rows = plan(*updates.shape, updates.element_size()).rows
        agg = agg + torch.einsum("w,wd->d", w[:rows], total[:rows])
    if fault == "keep_ignored":
        return agg, total.clone()
    return agg, total * keep.float()[:, None]


def fused_async_agg(updates: torch.Tensor, pending: torch.Tensor,
                    weights: torch.Tensor, keep: torch.Tensor):
    """updates (W, D) float32 or bfloat16; pending (W, D) float32;
    weights, keep (W,) float32 → (agg (D,) float32, new_pending (W, D)
    float32, a new buffer) in one pass over the update matrix, summed over
    W in a fixed order. On CUDA tensors this launches the kernel (counted
    in ``.launches``; with more than one row split it uses a small scratch
    kept per device and stream, ``_build.scratch``; on fake tensors the
    abstract branch, ``_build.abstract``); on CPU tensors it returns the
    plain version."""
    _build.check_updates(updates)
    W, D = updates.shape
    _build.check_operand(pending, "pending", (W, D), updates)
    _build.check_operand(weights, "weights", (W,), updates)
    _build.check_operand(keep, "keep", (W,), updates)
    if updates.device.type == "cpu":
        return fused_async_agg_ref(updates, pending, weights, keep)
    _build.check_no_grad("fused_async_agg", updates, pending, weights,
                         keep)
    p = plan(W, D, updates.element_size(),
             _build.aligned16(updates) and _build.aligned16(pending))
    dev = _build.device_of(updates)
    f32 = dict(dtype=torch.float32, device=dev)
    agg = torch.empty((D,), **f32)
    new_pending = torch.empty((W, D), **f32)
    if _build.is_fake(updates):
        _build.abstract("fused_async_agg", updates, flops=flops(W, D),
                        nbytes=hbm_bytes(W, D, updates.element_size())[
                            "total"],
                        scratch=_build.scratch_bytes(p.tiles, p.splits * D)
                        if p.splits > 1 else 0)
        return agg, new_pending
    cnt = part = None            # one split writes agg directly
    if p.splits > 1:
        cnt, part = _build.scratch("fused_async_agg", dev, p.tiles,
                                   p.splits * D)
    _build.launch("repro_fused_async_agg", dev, _build.ptr(updates),
                  int(updates.dtype == torch.bfloat16), _build.ptr(pending),
                  _build.ptr(weights), _build.ptr(keep), W, D, p.vec,
                  p.threads, p.splits, _build.ptr(cnt), _build.ptr(part),
                  _build.ptr(agg), _build.ptr(new_pending))
    fused_async_agg.launches += 1
    return agg, new_pending


fused_async_agg.launches = 0


def hbm_bytes(W: int, D: int, itemsize: int) -> dict:
    """HBM traffic of one K3 call: the update matrix once, pending read and
    new pending written (f32), weights and keep, the (D,) aggregate, and
    with more than one split the splits' f32 sums, each written once and
    read once by the split that combines them. ``minimum`` counts each
    input read once and each output written once."""
    upd = W * D * itemsize
    splits = plan(W, D, itemsize).splits
    partials = 0 if splits == 1 else 2 * splits * D * 4
    least = 2 * W * D * 4 + 2 * W * 4 + D * 4
    return {"update_read": upd, "other": least + partials,
            "total": upd + least + partials, "minimum": upd + least}


def flops(W: int, D: int) -> int:
    """Flops of one K3 call: total = pending + u and new pending = total ·
    keep (W D each), the weighted sum (2 W D)."""
    return 4 * W * D


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
