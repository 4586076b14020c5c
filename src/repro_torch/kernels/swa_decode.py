"""K5: sliding-window single-token decode attention with grouped KV heads.

One query token per sequence attends over at most ``window`` slots of its
KV cache: for q (B, H, hd) and caches (B, S, KV, hd), the G = H / KV query
rows of KV head ``kv`` see the slots ``pos`` with
``max(cur - window + 1, 0) <= pos <= cur``; softmax in f32, output in
``q.dtype``. ``swa_decode`` launches the CUDA kernel (``csrc/swa_decode.cu``)
for tensors on the card and runs the plain version, ``swa_decode_ref``, for
tensors on the CPU.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build

MAX_CHUNKS = 8   # blocks per (b, kv), combined by the last to finish
CHUNK_ALIGN = 64  # a block's 4 warps take 16-slot tiles in turn
MAX_G = 16       # query rows per KV head: the rows of one mma tile
HEAD_DIMS = (32, 64, 80, 128)   # hd the kernel is built for


def swa_decode_ref(q: torch.Tensor, k_cache: torch.Tensor,
                   v_cache: torch.Tensor, cur_index: int, window: int
                   ) -> torch.Tensor:
    """Plain PyTorch version: q (B, H, hd), caches (B, S, KV, hd) →
    (B, H, hd) in ``q.dtype``, everything in between in f32."""
    B, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qs = q.reshape(B, KV, G, hd).float() * (hd ** -0.5)
    s = torch.einsum("bkgh,bskh->bkgs", qs, k_cache.float())
    pos = torch.arange(S, device=q.device)
    valid = (pos <= cur_index) & ((cur_index - pos) < window)
    s = s.masked_fill(~valid, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", p, v_cache.float())
    return o.reshape(B, H, hd).to(q.dtype)


def window_slots(cur_index: int, window: int) -> int:
    """Cache slots a decode at ``cur_index`` attends to."""
    return cur_index - max(cur_index - window + 1, 0) + 1


class Plan(NamedTuple):
    """How one kernel launch covers the window: ``nchunks`` blocks per
    (b, kv), block ``c`` taking the slots
    ``[lo + c * chunk, min(lo + (c + 1) * chunk, cur + 1))``."""
    lo: int
    chunk: int
    nchunks: int


def plan(cur_index: int, window: int) -> Plan:
    """The window's slots cut into at most MAX_CHUNKS chunks of a multiple
    of CHUNK_ALIGN slots, none empty."""
    lo = max(cur_index - window + 1, 0)
    n = cur_index - lo + 1
    chunk = -(-n // MAX_CHUNKS)
    chunk = -(-chunk // CHUNK_ALIGN) * CHUNK_ALIGN
    return Plan(lo, chunk, -(-n // chunk))


def partial_floats(G: int, hd: int) -> int:
    """f32 values of one chunk's partial in the scratch: m and l (16 each,
    one per row of the kernel's 16-row tile) and acc (G, hd)."""
    return 32 + G * hd


def _check(q, k_cache, v_cache, cur_index, window):
    if q.ndim != 3 or k_cache.ndim != 4:
        raise ValueError(f"q must be (B, H, hd) and the caches (B, S, KV, "
                         f"hd), got {tuple(q.shape)} and "
                         f"{tuple(k_cache.shape)}")
    B, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    if tuple(k_cache.shape) != (B, S, KV, hd) or \
            v_cache.shape != k_cache.shape:
        raise ValueError(f"caches {tuple(k_cache.shape)} and "
                         f"{tuple(v_cache.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if KV < 1 or H % KV != 0:
        raise ValueError(f"H = {H} is not a multiple of KV = {KV}")
    if not 0 <= cur_index < S:
        raise ValueError(f"cur_index {cur_index} outside the cache [0, {S})")
    if window < 1:
        raise ValueError(f"window {window}: the kernel needs window >= 1")
    if not (q.device == k_cache.device == v_cache.device):
        raise ValueError("q and the caches lie on different devices")
    if not (q.dtype == k_cache.dtype == v_cache.dtype) or \
            q.dtype not in _build.KERNEL_DTYPES:
        raise TypeError(f"q, k, v dtypes {q.dtype}, {k_cache.dtype}, "
                        f"{v_cache.dtype}: the kernel takes one of float32 "
                        f"or bfloat16 for all three")


def _check_card(q, k_cache, v_cache):
    """What the CUDA kernel needs beyond the function's own domain."""
    B, H, hd = q.shape
    vec = 16 // q.element_size()
    G = H // k_cache.shape[2]
    if G > MAX_G or hd not in HEAD_DIMS:
        raise ValueError(f"G = {G}, hd = {hd}: the kernel takes G <= "
                         f"{MAX_G} and hd in {HEAD_DIMS}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    if k_cache.stride() != v_cache.stride() or k_cache.stride(3) != 1 or \
            any(s % vec for s in k_cache.stride()[:3]):
        raise ValueError(f"cache strides {k_cache.stride()} / "
                         f"{v_cache.stride()}: both the same, rows "
                         f"contiguous, 16-byte multiples")
    if not all(_build.aligned16(x) for x in (q, k_cache, v_cache)):
        raise ValueError("q and the caches must be 16-byte aligned")


def swa_decode(q: torch.Tensor, k_cache: torch.Tensor,
               v_cache: torch.Tensor, cur_index: int, window: int
               ) -> torch.Tensor:
    """q (B, H, hd), caches (B, S, KV, hd), both float32 or both bfloat16,
    ``0 <= cur_index < S``, ``window >= 1`` → (B, H, hd) in q's dtype. The
    caches may be strided views (the layer of a stacked cache) as long as
    each row of hd values is contiguous. On CUDA tensors this launches the
    kernel (counted in ``.launches``); on CPU tensors it returns the plain
    version. The kernel's small scratch for more than one chunk (their
    partials and arrival counters) is kept per device and stream
    (``_build.scratch``). On fake tensors it takes the abstract branch
    (``_build.abstract``)."""
    cur_index, window = int(cur_index), int(window)
    _check(q, k_cache, v_cache, cur_index, window)
    if q.device.type == "cpu":
        return swa_decode_ref(q, k_cache, v_cache, cur_index, window)
    _check_card(q, k_cache, v_cache)
    _build.check_no_grad("swa_decode", q, k_cache, v_cache)
    B, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    p = plan(cur_index, window)
    out = torch.empty_like(q)
    sb, ss, sh, _ = k_cache.stride()
    dev = _build.device_of(q)
    floats = B * KV * p.nchunks * partial_floats(H // KV, hd)
    if _build.is_fake(q):
        _build.abstract("swa_decode", q,
                        flops=flops(B, H, hd, window, cur_index),
                        nbytes=hbm_bytes(B, H, KV, hd, window, cur_index,
                                         q.element_size())["total"],
                        scratch=_build.scratch_bytes(B * KV, floats)
                        if p.nchunks > 1 else 0, tensor_cores=True)
        return out
    cnt = part = None            # one chunk writes out directly
    if p.nchunks > 1:
        cnt, part = _build.scratch("swa_decode", dev, B * KV, floats)
    _build.launch("repro_swa_decode", dev, _build.ptr(q),
                  _build.ptr(k_cache), _build.ptr(v_cache),
                  int(q.dtype == torch.bfloat16), B, H, KV, hd, sb, ss, sh,
                  cur_index, window, S, p.chunk, p.nchunks, _build.ptr(cnt),
                  _build.ptr(part), _build.ptr(out))
    swa_decode.launches += 1
    return out


swa_decode.launches = 0


def hbm_bytes(B: int, H: int, KV: int, hd: int, window: int, cur: int,
              itemsize: int) -> dict:
    """HBM traffic of one K5 call. ``minimum`` counts q and the output once
    and the window's K and V rows once (what the function must move);
    ``total`` adds the chunks' f32 partials, each written once and read once
    by the block that combines them (none with one chunk)."""
    n = window_slots(cur, window)
    nchunks = plan(cur, window).nchunks
    qo = 2 * B * H * hd * itemsize
    kv = 2 * B * KV * n * hd * itemsize
    partials = 0 if nchunks == 1 else \
        2 * B * KV * nchunks * partial_floats(H // KV, hd) * 4
    return {"kv_read": kv, "other": qo + partials,
            "total": qo + kv + partials, "minimum": qo + kv}


def flops(B: int, H: int, hd: int, window: int, cur: int) -> int:
    """Multiply-adds of q·k and p·v over the window (2 flops each)."""
    return 4 * B * H * hd * window_slots(cur, window)
