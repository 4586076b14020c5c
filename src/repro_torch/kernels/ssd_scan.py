"""K4: the SSD / decay-attention chunk scan of Mamba2's prefill.

For each (batch, head) the linear-attention-with-scalar-decay recurrence

    y_t = q_t · h_t,   h_t = exp(a_t) · h_{t-1} + i_t · k_t ⊗ v_t

over q, k (B, S, H, dk), v (B, S, H, dv) and gates a, i (B, S, H), computed
by chunks of ``chunk`` positions: within a chunk the (Q × Q) decay-masked
scores, across chunks the (dk × dv) state. Returns y (B, S, H, dv) in v's
dtype and the final state (B, H, dk, dv) in float32, starting from
``initial_state`` (zeros if None). ``ssd_scan`` launches the CUDA kernel
(``csrc/ssd_scan.cu``) for tensors on the card and runs the plain version,
``ssd_scan_ref``, for tensors on the CPU.

The kernel does its four products on the tensor cores (bf16 ``mma.sync``,
f32 sums), one launch per call, one block per (batch, head) walking the
chunks with the state in f32. bf16 q, k, v are exact operands; the gated
scores, the carried state and w·v are f32 by nature and enter as two bf16
parts each (three, and q, k, v too, for f32 inputs; f32 at dk or dv > 64
keeps its products on the ordinary cores). ``ssd_scan_ref(...,
parts=n)`` rounds those operands the same way, so the CPU can show what the
split costs against the card tolerance below; the planted fault
``p_one_part`` is the gated scores with one part only. ``bound`` gives the
least time the card could take for a call.

The backward: when autograd records, ``ssd_scan`` goes through
``_SSDScan``, whose forward also keeps the state before each chunk (the
kernel writes them to an optional (B, nc, H, dk, dv) f32 output) and whose
backward is ``ssd_scan_bwd``: the backward kernel (``csrc/ssd_scan_bwd.cu``)
on the card, the plain backward ``ssd_scan_bwd_ref`` (the VJP by chunks, in
f32) on the CPU. At dk, dv <= 64 and chunks that are a multiple of 16 the
kernel does its products on the tensor cores, a cluster of four blocks per
(batch, head) taking the chunks in parallel; the operands that are f32 by
nature (the gated scores P and R, the states H_n and their gradients, and
exp(cum_t) q_t) enter as bf16 parts, two for bf16 inputs, three for f32
ones, and ``ssd_scan_bwd_ref(..., parts=n)`` rounds them the same way;
wider heads and other chunks keep the first design's f32 FMAs, one block
per (batch, head) (``bwd_design`` says which a call takes). The reference
has no kernel here: it trains through XLA's autodiff of the jnp scan.
``bwd_bound`` gives the backward's least time.

Wide heads (mLSTM: dk = dh, dv = dh + 1, chunks of up to 256; ``is_wide``)
take a second path, ``csrc/ssd_scan_wide.cu``: f32 q, k and v, the
products on the tensor cores, three launches a call (``WIDE_LAUNCHES``),
the chunk-parallel split: q, k, v and w·v split into bf16 parts once, then
the state before every chunk (blocks that own a 128 × 128 tile of a
(batch, head)'s state and walk the chunks) and the gated scores of every
(batch, head, chunk), all in a scratch buffer, then y by (batch, head,
chunk) tiles. The gated scores, the states and w·v enter as
``WIDE_PARTS`` bf16 parts (``ssd_scan_ref(..., parts=WIDE_PARTS)``
emulates that), q, k and v as three (exact), and a part that is zero
across a slab (the serve's bf16-valued q, k, v) skips its products. Under
grad its second launch also writes the f32 state before each chunk, and
its backward is ``csrc/ssd_scan_wide_bwd.cu`` (``WIDE_BWD_LAUNCHES``
launches, ``WIDE_BWD_DESIGN``: the forward's design turned around, on the
tensor cores, with the state's gradient walked in reverse by blocks that
own a tile of it; ``ssd_scan_bwd_ref(..., parts=WIDE_PARTS)`` emulates its
split), counted in ``ssd_scan.bwd_launches`` as the narrow one. It
computes no product of a state known to be zero: none of H_0 without an
initial state, none of the final state's gradient where it is None, and
dh0 only where it is asked for.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch import mathfn
from repro_torch.kernels import _build

MAX_CHUNK = 128          # chunk positions the narrow kernel takes
MAX_D = 128              # dk and dv the narrow kernel takes
WIDE_MAX_CHUNK = 256     # chunk positions the wide path takes
WIDE_MAX_DK = 1024       # dk the wide path takes (dv is free)
WIDE_LAUNCHES = 3        # kernel launches a call of the wide path makes
WIDE_PARTS = 2           # bf16 parts of P, the states and w·v there
WIDE_DESIGN = ("chunk-parallel split on the tensor cores: bf16 parts of q, "
               "k, v, w·v; states before each chunk and gated scores; y")
WIDE_BWD_LAUNCHES = 5    # kernel launches a wide backward call makes
WIDE_BWD_DESIGN = ("tensor cores on bf16 parts: the parts of q, k, v, dy, "
                   "e^cum q and the states; the gated scores; the state's "
                   "gradient walked in reverse by its tiles; dq, dk, dv; "
                   "da, di")

# The card check (``chip_smoke.py``, ``tests/test_torch_cuda.py``) holds
# the kernel elementwise to the plain version's f32 result on the same
# inputs, y and the f32 final state each:
#   |kernel - plain_f32| <= ATOL_REL * max|plain_f32| + RTOL * |plain_f32|.
# The two sum in different orders. The largest gap comes from the chunk's
# cumsum of the gates: at zamba2's gates |cum| reaches ~900, where one f32
# rounding moves exp(cum_t - cum_s) by ~1e-4, 1.8e-5 of max|y| in a CPU
# emulation of the kernel's scan order. The kernel's two-part bf16 split
# of the gated scores, the state and w·v adds ~2^-17 of each term (the CPU
# emulation ``parts=2`` stays inside the check); a single part, 2^-9,
# does not (the fault ``p_one_part``). RTOL is 0 but for the kernel's bf16
# y, which it rounds once more, by at most half a bf16 step (2^-8 of the
# value).
ATOL_REL = 1e-4
RTOL = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -8}

# errors the plain version can plant, so a check can show that its
# tolerance sees them (``chip_smoke.py`` and the tests)
FAULTS = ("carry_reset",            # the state is dropped at every chunk
          "decay_off_by_one",       # inter-chunk decay one step short
          "no_diagonal",            # intra-chunk mask drops s == t
          "final_state_stale",      # final state misses the last chunk
          "p_one_part")             # gated scores rounded once to bf16

# The backward kernel against the plain backward's f32 result on the same
# inputs, each of dq, dk, dv, da, di and dh0 relative to its own largest
# plain value (``bwd_margins``):
#   |kernel - plain_f32| <= BWD_ATOL_REL * max|plain_f32| + RTOL * |plain_f32|,
# RTOL for bf16 dq, dk, dv only, which the kernel rounds once more. Both are
# f32 throughout and differ in the order of their sums; as in the forward,
# the largest gap comes from the chunk's cumsum of the gates, at zamba2's
# gates up to ~900 in size. On the CPU the plain backward in f32 stays
# within 1.7e-5 of max (da; dv 1.2e-5, dq and dk 7.7e-6) of the same
# formulas in f64 at zamba2's training shape and gates, and within 6e-7
# at gentle ones; a kernel that sums in other orders may sit on the other
# side, so the bound allows three times twice that. Each planted fault
# (``BWD_FAULTS``) moves some output by >= 0.1 of its max where it applies.
BWD_ATOL_REL = 1e-4

# errors the plain backward can plant (``ssd_scan_bwd_ref(fault=...)``)
BWD_FAULTS = ("bwd_carry_dropped",        # dH reset at every chunk
              "bwd_da_forward_cumsum",    # da as a forward cumsum of dcum
              "bwd_di_no_state_term",     # di misses e^{tot-cum_s} kᵀ dH v
              "bwd_dq_no_inter",          # dq misses e^{cum_t} H_n dy_t
              "bwd_one_part")             # the split operands in one part

# what the backward kernel's instantiations are, by the number its dispatch
# gives (``bwd_design``)
BWD_DESIGNS = ("tensor cores, clusters of 4, bf16",
               "tensor cores, clusters of 4, f32",
               "f32 FMAs, one block per (b, h), bf16, rows in shared memory",
               "f32 FMAs, one block per (b, h), bf16, rows from global memory",
               "f32 FMAs, one block per (b, h), f32, rows in shared memory",
               "f32 FMAs, one block per (b, h), f32, rows from global memory")


def bf16_parts(x: torch.Tensor, n: int) -> torch.Tensor:
    """The f32 value of x split into n bf16 parts, part j rounding what
    parts 0 .. j - 1 left: what the kernel's tensor cores multiply for an
    operand that is f32 by nature. One part is x rounded to bf16 (8 bits),
    two keep ~16 bits, three ~24."""
    out = torch.zeros_like(x)
    rest = x
    for _ in range(n):
        part = rest.to(torch.bfloat16).to(x.dtype)
        out = out + part
        rest = rest - part
    return out


def segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., Q) log-decays → (..., Q, Q) with out[t, s] = Σ a[s+1..t],
    -inf above the diagonal (the reference's ``ssm._segsum``)."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=a.device).tril()
    return diff.masked_fill(~mask, float("-inf"))


def ssd_scan_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 a: torch.Tensor, i: torch.Tensor, *, chunk: int,
                 initial_state: Optional[torch.Tensor] = None,
                 fault: Optional[str] = None, parts: Optional[int] = None,
                 return_states: bool = False):
    """Plain PyTorch version, the reference's chunked algorithm
    (``ssm.chunked_decay_attention``) in f32 → (y in v's dtype, final state
    f32), and with ``return_states`` the f32 state before each chunk
    (B, nc, H, dk, dv), what the backward reads. ``fault`` (one of
    ``FAULTS``) plants that error. ``parts`` rounds the three operands
    that the kernel splits into bf16 parts — the gated scores, the carried
    state in q·h and w·v in the state update — to that many parts
    (``bf16_parts``), so the CPU can show what the split costs against the
    card tolerance."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; known: {FAULTS}")
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    nc = S // chunk
    f32 = torch.float32
    qc = q.to(f32).reshape(B, nc, chunk, H, dk)
    kc = k.to(f32).reshape(B, nc, chunk, H, dk)
    vc = v.to(f32).reshape(B, nc, chunk, H, dv)
    ac = a.to(f32).reshape(B, nc, chunk, H)
    ic = i.to(f32).reshape(B, nc, chunk, H)

    # intra-chunk (quadratic in the chunk)
    seg = segsum(ac.movedim(3, 2))                          # (B,nc,H,Q,Q)
    if fault == "no_diagonal":
        seg = seg + torch.diag(torch.full((chunk,), float("-inf"),
                                          device=q.device))
    L = mathfn.exp(seg)
    scores = torch.einsum("bnqhd,bnshd->bnhqs", qc, kc)
    gated = scores * L * ic.movedim(3, 2)[..., None, :]
    if parts is not None or fault == "p_one_part":
        gated = bf16_parts(gated, 1 if fault == "p_one_part" else parts)
    y_intra = torch.einsum("bnhqs,bnshv->bnqhv", gated, vc)

    # chunk summary states: Σ_j exp(Σ_{l>j} a) i_j k_j ⊗ v_j
    cum = torch.cumsum(ac, dim=2)                           # (B,nc,Q,H)
    total = cum[:, :, -1:, :]
    wv = (mathfn.exp(total - cum) * ic)[..., None] * vc     # (B,nc,Q,H,dv)
    if parts is not None:
        wv = bf16_parts(wv, parts)
    state_n = torch.einsum("bnqhd,bnqhv->bnhdv", kc, wv)

    # inter-chunk recurrence over the chunk index
    chunk_decay = mathfn.exp(total[:, :, 0, :])             # (B,nc,H)
    decay_from_start = mathfn.exp(cum)
    if fault == "decay_off_by_one":
        chunk_decay = mathfn.exp(total[:, :, 0, :] - ac[:, :, -1, :])
        decay_from_start = mathfn.exp(cum - ac)
    h = (torch.zeros((B, H, dk, dv), dtype=f32, device=q.device)
         if initial_state is None else initial_state.to(f32))
    h_before = []
    for n in range(nc):
        if fault == "carry_reset" and n > 0:
            h = torch.zeros_like(h)
        h_before.append(h)
        h = h * chunk_decay[:, n, :, None, None] + state_n[:, n]
    states = h_before = torch.stack(h_before, dim=1)        # (B,nc,H,dk,dv)

    if parts is not None:
        h_before = bf16_parts(h_before, parts)
    y_inter = torch.einsum("bnqhd,bnhdv->bnqhv", qc, h_before)
    y_inter = y_inter * decay_from_start[..., None]
    y = (y_intra + y_inter).reshape(B, S, H, dv)
    if fault == "final_state_stale":
        h = h_before[:, -1]
    if return_states:
        return y.to(v.dtype), h, states
    return y.to(v.dtype), h


def excess(got: torch.Tensor, want32: torch.Tensor,
           rtol: float = 0.0) -> float:
    """Largest amount by which ``got`` lies outside the card tolerance
    around the plain f32 result ``want32`` (above): > 0 fails."""
    tol = ATOL_REL * want32.abs().max() + rtol * want32.abs()
    return float(((got.float() - want32).abs() - tol).max())


BWD_NAMES = ("dq", "dk", "dv", "da", "di", "dh0")


def bwd_margins(got, want32) -> dict:
    """For each output of the backward (``BWD_NAMES``), how many times over
    the card tolerance around the plain f32 result ``want32`` (above)
    ``got`` lies at its worst element: max |got - plain| / tolerance. Any
    value > 1 fails; a planted fault must push one above 1. dq, dk and dv
    in bf16 take RTOL."""
    out = {}
    for name, g, w in zip(BWD_NAMES, got, want32):
        w = w.float()
        tol = BWD_ATOL_REL * w.abs().max() + RTOL.get(g.dtype, 0.0) * w.abs()
        out[name] = float(((g.float() - w).abs()
                           / tol.clamp_min(1e-30)).max())
    return out


def _check(q, k, v, a, i, chunk, initial_state):
    if q.ndim != 4 or k.shape != q.shape or v.ndim != 4 or \
            v.shape[:3] != q.shape[:3]:
        raise ValueError(f"q, k must be (B, S, H, dk) and v (B, S, H, dv), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, dk = q.shape
    for name, g in (("a", a), ("i", i)):
        if tuple(g.shape) != (B, S, H):
            raise ValueError(f"{name} must be (B, S, H) = {(B, S, H)}, got "
                             f"{tuple(g.shape)}")
    if chunk < 1 or S % chunk:
        raise ValueError(f"S = {S} is not a multiple of chunk = {chunk}")
    if initial_state is not None and \
            tuple(initial_state.shape) != (B, H, dk, v.shape[-1]):
        raise ValueError(f"initial_state {tuple(initial_state.shape)} is "
                         f"not (B, H, dk, dv)")
    tensors = [q, k, v, a, i] + ([initial_state] if initial_state is not None
                                 else [])
    if any(x.device != q.device for x in tensors):
        raise ValueError("the operands lie on different devices")


def is_wide(dk: int, dv: int, chunk: int) -> bool:
    """Whether a call on the card at these sizes takes the wide path
    (``csrc/ssd_scan_wide.cu``) rather than the narrow kernel
    (``csrc/ssd_scan.cu``, dk, dv and chunk all <= 128)."""
    return chunk > MAX_CHUNK or dk > MAX_D or dv > MAX_D


def _check_card(q, k, v, chunk):
    """What the CUDA kernels need beyond the function's own domain."""
    dk, dv = q.shape[-1], v.shape[-1]
    if not (q.dtype == k.dtype == v.dtype) or \
            q.dtype not in _build.KERNEL_DTYPES:
        raise TypeError(f"q, k, v dtypes {q.dtype}, {k.dtype}, {v.dtype}: "
                        f"the kernel takes one of float32 or bfloat16 for "
                        f"all three")
    if is_wide(dk, dv, chunk):
        if chunk > WIDE_MAX_CHUNK or dk > WIDE_MAX_DK:
            raise ValueError(
                f"chunk {chunk}, dk {dk}, dv {dv}: the kernel takes chunk "
                f"<= {MAX_CHUNK} and dk, dv <= {MAX_D}, or (the wide path) "
                f"chunk <= {WIDE_MAX_CHUNK} and dk <= {WIDE_MAX_DK}")
        if q.dtype != torch.float32:
            raise TypeError(f"q, k, v dtype {q.dtype}: the wide path (dk or "
                            f"dv > {MAX_D} or chunk > {MAX_CHUNK}) takes "
                            f"float32 only")
    if any(x.stride(3) != 1 for x in (q, k, v)):
        raise ValueError("q, k, v need contiguous rows (last stride 1)")


def wide_scratch_bytes(B: int, S: int, H: int, dk: int, dv: int,
                       chunk: int) -> int:
    """Bytes of the scratch buffer a wide call on the card needs (the
    kernel library's own count, so it builds the library): the bf16 parts
    of q, k, v and w·v, of the gated scores and of the state before each
    chunk, the chunks' cumsums and the parts in use. 0.66 GB at
    xlstm-1.3b's prefill."""
    out = ctypes.c_longlong()
    err = _build.load().repro_ssd_scan_wide_scratch(
        B, S, H, dk, dv, chunk, ctypes.addressof(out))
    if err:
        raise ValueError(f"no wide scan at B {B}, S {S}, H {H}, dk {dk}, "
                         f"dv {dv}, chunk {chunk}")
    return out.value


def wide_bwd_scratch_bytes(B: int, S: int, H: int, dk: int, dv: int,
                           chunk: int, *, initial_state: bool = True,
                           dh_final: bool = True) -> int:
    """Bytes of the scratch buffer a wide backward call on the card needs
    (the kernel library's own count, so it builds the library), with or
    without an initial state and a final state's gradient: the bf16 parts
    of q, k, v, dy and e^{cum} q, of the states before each chunk and of
    their gradients after it (those not known to be zero), of the gated
    scores P and R, the chunks' cumsums, the parts in use and the tiles'
    partial sums. 0.39 GB at xlstm-1.3b's training shape without either."""
    out = ctypes.c_longlong()
    err = _build.load().repro_ssd_scan_wide_bwd_scratch(
        B, S, H, dk, dv, chunk, int(initial_state), int(dh_final),
        ctypes.addressof(out))
    if err:
        raise ValueError(f"no wide backward at B {B}, S {S}, H {H}, dk {dk}, "
                         f"dv {dv}, chunk {chunk}")
    return out.value


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def wide_scratch_layout_bytes(B: int, S: int, H: int, dk: int, dv: int,
                              chunk: int) -> int:
    """``wide_scratch_bytes`` without the library: the same count from the
    layout in ``csrc/ssd_scan_wide.cu`` (``Layout``), for the dry run's
    abstract branch, which builds nothing. Three parts of q, k and v, two
    of the states, the gated scores and w·v; rows padded to 8."""
    bh, nc, Q = B * H, S // chunk, chunk
    bhn = bh * nc
    dkp, dvp = _round_up(dk, 8), _round_up(dv, 8)
    total = 2 * bhn * 2 * dk * dvp + 2 * bhn * 2 * Q * _round_up(Q, 8)
    total += 2 * bh * 3 * S * (2 * dkp + dvp) + 2 * bh * 2 * S * dvp
    total += _round_up(4 * bh * S, 16)
    return total + _round_up(12 * bhn * -(-Q // 32), 16)


def wide_bwd_scratch_layout_bytes(B: int, S: int, H: int, dk: int, dv: int,
                                  chunk: int, *, initial_state: bool = True,
                                  dh_final: bool = True) -> int:
    """``wide_bwd_scratch_bytes`` without the library: the same count from
    the layout in ``csrc/ssd_scan_wide_bwd.cu`` (``Layout``)."""
    bh, nc, Q = B * H, S // chunk, chunk
    bhn = bh * nc
    dkp, dvp, Qp = _round_up(dk, 8), _round_up(dv, 8), _round_up(Q, 8)
    nh = nc - (0 if initial_state else 1)
    ng = nc - (0 if dh_final else 1)
    ntt, ndt, net = -(-Q // 128), -(-dk // 128), -(-dv // 128)

    def f32(n):
        return _round_up(4 * n, 16)
    total = 2 * bh * 3 * S * (2 * dkp + 2 * dvp) + 2 * bh * 2 * S * dkp
    total += 2 * bh * (nh + ng) * 2 * dk * dvp + 2 * 2 * bhn * 2 * Q * Qp
    total += f32(bh * S) + f32(bhn * -(-Q // 32) * 4)
    total += 2 * f32(bhn * ntt * Q) + 2 * f32(bhn * ndt * Q)
    return total + f32(bhn * ndt * net)


def _launch_fwd(q, k, v, a, i, h0, chunk: int, with_states: bool):
    """One K4 call on the card → (y, final state, and the state before each
    chunk (B, nc, H, dk, dv) f32 when ``with_states``, else None): the
    narrow kernel's one launch, or the wide path's three (``is_wide``)."""
    _check_card(q, k, v, chunk)
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    dev = q.device
    f32 = torch.float32
    a32 = a.detach().to(f32).contiguous()
    i32 = i.detach().to(f32).contiguous()
    h0 = None if h0 is None else h0.detach().to(f32).contiguous()
    y = torch.empty((B, S, H, dv), dtype=v.dtype, device=dev)
    h = torch.empty((B, H, dk, dv), dtype=f32, device=dev)
    states = torch.empty((B, S // chunk, H, dk, dv), dtype=f32,
                         device=dev) if with_states else None
    wide = is_wide(dk, dv, chunk)
    if _build.is_fake(q):
        held = wide_scratch_layout_bytes(B, S, H, dk, dv, chunk) \
            if wide else 0
        least = hbm_bytes(B, S, H, dk, dv, v.element_size(),
                          qk_per_head=q.stride(2) != 0,
                          qk_itemsize=q.element_size())["minimum"]
        _build.abstract(
            "ssd_scan", q, flops=flops(B, S, H, dk, dv, chunk),
            nbytes=total_bytes(least, scratch=held, saved=0 if states is None
                               else states.numel() * 4),
            scratch=held, tensor_cores=True)
        return y, h, states
    ptrs = [_build.ptr(x) for x in (q, k, v, a32, i32, h0)]
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    if wide:
        # the bf16 parts of q, k, v, w·v, the gated scores and the state
        # before every chunk, which the three launches pass on
        nbytes = wide_scratch_bytes(B, S, H, dk, dv, chunk)
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        _build.launch("repro_ssd_scan_wide", dev, *ptrs, B, S, H, dk, dv,
                      chunk, *strides, _build.ptr(scratch), nbytes,
                      _build.ptr(y), _build.ptr(h), _build.ptr(states))
    else:
        _build.launch("repro_ssd_scan", dev, *ptrs,
                      int(v.dtype == torch.bfloat16), B, S, H, dk, dv, chunk,
                      *strides, _build.ptr(y), _build.ptr(h),
                      _build.ptr(states))
    ssd_scan.launches += 1
    return y, h, states


class _SSDScan(torch.autograd.Function):
    """K4 under autograd: the forward keeps the state before each chunk,
    the backward is ``ssd_scan_bwd`` (the kernel on the card, the plain
    backward on the CPU). q and k may be head-stride-0 views: their
    gradients come back per head, and autograd's expand backward sums
    them over the heads."""

    @staticmethod
    def forward(ctx, q, k, v, a, i, h0, chunk):
        if q.device.type == "cpu":
            y, h, states = ssd_scan_ref(q, k, v, a, i, chunk=chunk,
                                        initial_state=h0,
                                        return_states=True)
        else:
            y, h, states = _launch_fwd(q, k, v, a, i, h0, chunk, True)
        ctx.save_for_backward(q, k, v, a, i, h0, states)
        ctx.chunk = chunk
        # an unused final state's gradient stays None (no zeros are made,
        # and the kernel reads no dh_final)
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        q, k, v, a, i, h0, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(v.shape, dtype=v.dtype, device=v.device)
        # dh0 only where there is an initial state to take it
        dq, dk, dv, da, di, dh0 = ssd_scan_bwd(
            q, k, v, a, i, dy, dh, chunk=ctx.chunk, initial_state=h0,
            states=states, want_dh0=h0 is not None)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                da.to(a.dtype), di.to(i.dtype),
                None if h0 is None else dh0.to(h0.dtype), None)


def ssd_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             a: torch.Tensor, i: torch.Tensor, *, chunk: int,
             initial_state: Optional[torch.Tensor] = None):
    """q, k (B, S, H, dk), v (B, S, H, dv), gates a, i (B, S, H), S a
    multiple of ``chunk`` → (y (B, S, H, dv) in v's dtype, final state
    (B, H, dk, dv) f32). On CUDA tensors this launches the kernel (each
    call counted once in ``.launches``): q, k, v read through their strides
    (a head stride of 0 reads one row for every head) with contiguous rows;
    the gates and the initial state are read as contiguous f32. Which
    kernel, by shape: dk, dv and chunk all <= 128 take the narrow kernel,
    one launch, q, k, v float32 or bfloat16 alike; wider heads or chunks
    (``is_wide``: mLSTM's dk = dh, dv = dh + 1) take the wide path, three
    launches, float32 only, chunk <= 256 and dk <= 1024; anything else
    raises. On CPU tensors it returns the plain version.

    When autograd records (grad mode on and an input that requires grad),
    the call goes through ``_SSDScan``: the forward also writes the state
    before each chunk, and the backward launches the backward kernel on
    the card (counted in ``.bwd_launches``; the wide backward at wide
    shapes) or runs the plain backward on the CPU."""
    chunk = int(chunk)
    _check(q, k, v, a, i, chunk, initial_state)
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad
            for x in (q, k, v, a, i, initial_state)):
        return _SSDScan.apply(q, k, v, a, i, initial_state, chunk)
    if q.device.type == "cpu":
        return ssd_scan_ref(q, k, v, a, i, chunk=chunk,
                            initial_state=initial_state)
    y, h, _ = _launch_fwd(q, k, v, a, i, initial_state, chunk, False)
    return y, h


ssd_scan.launches = 0
ssd_scan.bwd_launches = 0


def ssd_scan_bwd_ref(q, k, v, a, i, dy, dh_final=None, *, chunk: int,
                     initial_state=None, states=None,
                     fault: Optional[str] = None,
                     parts: Optional[int] = None):
    """The plain backward of ``ssd_scan``, by chunks in f32, as the kernel
    computes it: given dy (B, S, H, dv) and the gradient of the final
    state ``dh_final`` (B, H, dk, dv; None for zeros), returns (dq, dk,
    dv, da, di, dh0), all f32, dh0 the initial state's gradient.
    ``states`` (B, nc, H, dk, dv) are the states before each chunk, from
    the forward; None recomputes them. Per chunk, with cum_t = Σ_{l<=t}
    a_l, tot = cum_{Q-1}, L_ts = e^{cum_t - cum_s} (s <= t), w_s =
    e^{tot - cum_s} i_s, H_n the state before the chunk and dH the
    gradient of the state after it (carried in reverse from dh_final):

      dq_t  = Σ_{s<=t} (dy_t·v_s) L_ts i_s k_s + e^{cum_t} H_n dy_t
      dk_s  = Σ_{t>=s} (dy_t·v_s) L_ts i_s q_t + w_s dH v_s
      dv_s  = Σ_{t>=s} (q_t·k_s) L_ts i_s dy_t + w_s dHᵀ k_s
      di_s  = Σ_{t>=s} (q_t·k_s)(dy_t·v_s) L_ts + e^{tot-cum_s} k_sᵀ dH v_s
      dcum  = row sums minus column sums of G_ts = (q_t·k_s)(dy_t·v_s)
              L_ts i_s, + e^{cum_t} q_t·H_n dy_t at t, - w_s k_sᵀ dH v_s
              at s, + e^{tot}<H_n, dH> + Σ_s w_s k_sᵀ dH v_s at Q - 1
      da_l  = Σ_{t>=l} dcum_t
      dH_n  = e^{tot} dH + Σ_t e^{cum_t} q_t dy_tᵀ,   dh0 = dH_0.

    Every exponent is <= 0 (a <= 0). ``fault`` (one of ``BWD_FAULTS``)
    plants that error. ``parts`` rounds the operands that the tensor-core
    kernel splits into bf16 parts to that many parts (``bf16_parts``): R
    and P, H_n in H_n dy_t, dH in dH v_s and dHᵀ k_s, and e^{cum_t} q_t in
    the Σ_t update of dH; the planted fault ``bwd_one_part`` is one part.
    <H_n, dH> and the scores' elementwise products stay f32, as in the
    kernel. q, k, v and dy stay whole: the wide kernel splits them into
    three parts, which hold them, but drops the part products i + j >= 3,
    each with a third part (~2^-24 of a term), so the emulation is exact
    for bf16-valued q, k, v and up to those products for dy and f32
    values."""
    if fault is not None and fault not in BWD_FAULTS:
        raise ValueError(f"unknown fault {fault!r}; known: {BWD_FAULTS}")
    if fault == "bwd_one_part":
        parts = 1

    def split(x):
        return x if parts is None else bf16_parts(x, parts)
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    nc = S // chunk
    f32 = torch.float32
    if states is None:
        states = ssd_scan_ref(q, k, v, a, i, chunk=chunk,
                              initial_state=initial_state,
                              return_states=True)[2]
    states = states.to(f32)
    qc = q.to(f32).reshape(B, nc, chunk, H, dk)
    kc = k.to(f32).reshape(B, nc, chunk, H, dk)
    vc = v.to(f32).reshape(B, nc, chunk, H, dv)
    dyc = dy.to(f32).reshape(B, nc, chunk, H, dv)
    ac = a.to(f32).reshape(B, nc, chunk, H)
    ic = i.to(f32).reshape(B, nc, chunk, H)

    cum = torch.cumsum(ac, dim=2)                           # (B,nc,Q,H)
    tot = cum[:, :, -1]                                     # (B,nc,H)
    ecum = mathfn.exp(cum)
    ew = mathfn.exp(tot[:, :, None] - cum)                  # e^{tot-cum_s}
    w = ew * ic

    # intra-chunk: the (Q x Q) products, causal
    L = mathfn.exp(segsum(ac.movedim(3, 2)))                # (B,nc,H,t,s)
    i_s = ic.movedim(3, 2)[..., None, :]
    scores = torch.einsum("bnthd,bnshd->bnhts", qc, kc)
    dyv = torch.einsum("bnthv,bnshv->bnhts", dyc, vc)
    sdl = scores * dyv * L
    R = split(dyv * L * i_s)
    P = split(scores * L * i_s)
    dq = torch.einsum("bnhts,bnshd->bnthd", R, kc)
    dk_ = torch.einsum("bnhts,bnthd->bnshd", R, qc)
    dv_ = torch.einsum("bnhts,bnthv->bnshv", P, dyc)
    di = sdl.sum(-2).movedim(2, 3)                          # (B,nc,Q,H)
    G = sdl * i_s
    dcum = (G.sum(-1) - G.sum(-2)).movedim(2, 3)

    # the state's gradient, carried in reverse over the chunks
    etot = mathfn.exp(tot)
    if parts is None:
        qdy = torch.einsum("bnth,bnthd,bnthv->bnhdv", ecum, qc, dyc)
    else:
        qdy = torch.einsum("bnthd,bnthv->bnhdv",
                           split(ecum[..., None] * qc), dyc)
    dH = torch.zeros((B, H, dk, dv), dtype=f32, device=q.device) \
        if dh_final is None else dh_final.to(f32)
    after = []
    for n in reversed(range(nc)):
        if fault == "bwd_carry_dropped" and n < nc - 1:
            dH = torch.zeros_like(dH)
        after.append(dH)
        dH = dH * etot[:, n, :, None, None] + qdy[:, n]
    dH_after = torch.stack(after[::-1], dim=1)              # (B,nc,H,dk,dv)

    # inter-chunk: y_t += e^{cum_t} q_t·H_n
    Hdy = torch.einsum("bnhde,bnthe->bnthd", split(states), dyc)
    if fault != "bwd_dq_no_inter":
        dq = dq + ecum[..., None] * Hdy
    dcum = dcum + ecum * (qc * Hdy).sum(-1)
    # the state update: H_{n+1} = e^{tot} H_n + Σ_s w_s k_s v_sᵀ
    Z = torch.einsum("bnhde,bnshe->bnshd", split(dH_after), vc)  # dH v_s
    dk_ = dk_ + w[..., None] * Z
    dv_ = dv_ + w[..., None] * torch.einsum("bnhde,bnshd->bnshe",
                                            split(dH_after), kc)
    kdhv = (kc * Z).sum(-1)                                 # (B,nc,Q,H)
    if fault != "bwd_di_no_state_term":
        di = di + ew * kdhv
    dcum = dcum - w * kdhv
    dtot = etot * (states * dH_after).sum((-2, -1)) + (w * kdhv).sum(2)
    dcum = torch.cat([dcum[:, :, :-1], dcum[:, :, -1:] + dtot[:, :, None]],
                     dim=2)
    if fault == "bwd_da_forward_cumsum":
        da = torch.cumsum(dcum, dim=2)
    else:
        da = torch.flip(torch.cumsum(torch.flip(dcum, (2,)), dim=2), (2,))
    return (dq.reshape(B, S, H, dk), dk_.reshape(B, S, H, dk),
            dv_.reshape(B, S, H, dv), da.reshape(B, S, H),
            di.reshape(B, S, H), dH)


def ssd_scan_bwd(q, k, v, a, i, dy, dh_final=None, *, chunk: int,
                 initial_state=None, states=None, want_dh0: bool = True):
    """The backward of ``ssd_scan`` → (dq, dk, dv, da, di, dh0). On CUDA
    tensors it launches the backward kernel (``csrc/ssd_scan_bwd.cu``, or
    at wide shapes (``is_wide``) the wide backward's ``WIDE_BWD_LAUNCHES``
    launches, ``csrc/ssd_scan_wide_bwd.cu``, f32 only; either counted once
    in ``ssd_scan.bwd_launches``) and needs ``states``, the states before
    each chunk that the forward wrote; dq, dk and dv come in the inputs'
    dtype, da, di and dh0 in f32, and dq, dk per head even where q and k
    are head-stride-0 views. On CPU tensors it returns the plain backward,
    ``ssd_scan_bwd_ref`` (all f32). With ``want_dh0`` False dh0 comes back
    as None, and the wide backward skips the products that only it needs;
    without ``initial_state`` it reads no state before the first chunk,
    and without ``dh_final`` none of the final state's gradient."""
    chunk = int(chunk)
    _check(q, k, v, a, i, chunk, initial_state)
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    if tuple(dy.shape) != (B, S, H, dv):
        raise ValueError(f"dy {tuple(dy.shape)} is not (B, S, H, dv)")
    if q.device.type == "cpu":
        out = ssd_scan_bwd_ref(q, k, v, a, i, dy, dh_final, chunk=chunk,
                               initial_state=initial_state, states=states)
        return out if want_dh0 else (*out[:5], None)
    _check_card(q, k, v, chunk)
    nc = S // chunk
    if states is None or tuple(states.shape) != (B, nc, H, dk, dv) or \
            states.dtype != torch.float32 or not states.is_contiguous():
        raise ValueError("the backward kernel reads the forward's states "
                         "before each chunk: (B, nc, H, dk, dv) f32, "
                         "contiguous")
    dev = q.device
    f32 = torch.float32
    dy = dy.detach().to(v.dtype).contiguous()
    a32 = a.detach().to(f32).contiguous()
    i32 = i.detach().to(f32).contiguous()
    dhf = None if dh_final is None else dh_final.detach().to(f32).contiguous()
    dq = torch.empty((B, S, H, dk), dtype=q.dtype, device=dev)
    dk_ = torch.empty((B, S, H, dk), dtype=q.dtype, device=dev)
    dv_ = torch.empty((B, S, H, dv), dtype=q.dtype, device=dev)
    da = torch.empty((B, S, H), dtype=f32, device=dev)
    di = torch.empty((B, S, H), dtype=f32, device=dev)
    wide = is_wide(dk, dv, chunk)
    # the narrow kernel carries the state's gradient in dh0's buffer, so it
    # always has one; the wide backward writes dh0 only where asked for
    dh0 = torch.empty((B, H, dk, dv), dtype=f32, device=dev) \
        if want_dh0 or not wide else None
    if _build.is_fake(q):
        has_h0 = initial_state is not None
        held = wide_bwd_scratch_layout_bytes(
            B, S, H, dk, dv, chunk, initial_state=has_h0,
            dh_final=dhf is not None) if wide else 0
        # the wide backward skips the products of states known to be zero
        # and of a dh0 not asked for; the narrow one computes them all
        known = dict(initial_state=has_h0, dh_final=dhf is not None,
                     dh0=want_dh0) if wide else {}
        least = bwd_hbm_bytes(B, S, H, dk, dv, chunk, v.element_size(),
                              qk_per_head=q.stride(2) != 0,
                              qk_itemsize=q.element_size(),
                              **known)["minimum"]
        _build.abstract(
            "ssd_scan_bwd", q,
            flops=bwd_flops(B, S, H, dk, dv, chunk, **known),
            nbytes=total_bytes(least, scratch=held), scratch=held,
            tensor_cores=True)
        return dq, dk_, dv_, da, di, dh0 if want_dh0 else None
    ins = [_build.ptr(x) for x in (q, k, v, a32, i32, states, dy, dhf)]
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    outs = [_build.ptr(x) for x in (dq, dk_, dv_, da, di, dh0)]
    if wide:
        has_h0 = initial_state is not None
        nbytes = wide_bwd_scratch_bytes(B, S, H, dk, dv, chunk,
                                        initial_state=has_h0,
                                        dh_final=dhf is not None)
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        _build.launch("repro_ssd_scan_wide_bwd", dev, *ins, B, S, H, dk, dv,
                      chunk, int(has_h0), *strides, _build.ptr(scratch),
                      nbytes, *outs)
    else:
        _build.launch("repro_ssd_scan_bwd", dev, *ins,
                      int(v.dtype == torch.bfloat16), B, S, H, dk, dv, chunk,
                      *strides, *outs)
    ssd_scan.bwd_launches += 1
    return dq, dk_, dv_, da, di, dh0 if want_dh0 else None


def bwd_design(dtype: torch.dtype, dk: int, dv: int, chunk: int) -> int:
    """The instantiation of the backward kernel that a call on the card
    with these operands launches: an index into ``BWD_DESIGNS``, from the
    kernel library's own dispatch (so it builds the library)."""
    n = _build.load().repro_ssd_scan_bwd_design(
        int(dtype == torch.bfloat16), int(dk), int(dv), int(chunk))
    if n < 0:
        raise ValueError(f"dk {dk}, dv {dv}, chunk {chunk}: the kernel "
                         f"takes chunk <= {MAX_CHUNK} and dk, dv <= {MAX_D}")
    return n


def hbm_bytes(B: int, S: int, H: int, dk: int, dv: int, itemsize: int, *,
              qk_per_head: bool = False,
              qk_itemsize: Optional[int] = None) -> dict:
    """HBM bytes one K4 call must move: q and k once, in their own item
    size (``qk_itemsize``, default ``itemsize``): one row for all heads
    where their head stride is 0 (Mamba2's B and C), a row per head with
    ``qk_per_head`` (mLSTM); v once, the f32 gates once, y written once and
    the f32 final state written once."""
    qk = 2 * B * S * dk * (H if qk_per_head else 1) * \
        (qk_itemsize or itemsize)
    vy = 2 * B * S * H * dv * itemsize
    gates = 2 * B * S * H * 4
    state = B * H * dk * dv * 4
    return {"qk": qk, "v_y": vy, "gates": gates, "state": state,
            "minimum": qk + vy + gates + state}


def total_bytes(minimum: int, *, saved: int = 0, scratch: int = 0) -> int:
    """The HBM bytes a call moves in all (the dry run's count): the
    ``minimum`` of ``hbm_bytes`` or ``bwd_hbm_bytes``, the ``saved`` bytes
    of f32 states before the chunks that a forward under grad writes for
    its backward, and the wide path's ``scratch`` written once and read
    once."""
    return minimum + saved + 2 * scratch


def flops(B: int, S: int, H: int, dk: int, dv: int, chunk: int) -> int:
    """Multiply-adds (2 flops each) the recurrence needs by chunks: the
    causal half of the scores and of their product with v (Q(Q+1)/2
    pairs), q against the carried state, and the state update."""
    pairs = chunk * (chunk + 1) // 2
    per_chunk = pairs * (dk + dv) + 2 * chunk * dk * dv
    return 2 * B * H * (S // chunk) * per_chunk


def bound(B: int, S: int, H: int, dk: int, dv: int, chunk: int,
          itemsize: int, hbm_bytes_per_s: float, tensor_flops_per_s: float,
          f32_flops_per_s: float, *, qk_per_head: bool = False,
          qk_itemsize: Optional[int] = None) -> dict:
    """The least time (ms) the card could take for one K4 call: the larger
    of its minimum HBM bytes (``hbm_bytes``, with q and k counted as
    ``qk_per_head`` and ``qk_itemsize`` say) over the memory rate and its
    flops over the bf16 tensor cores' dense rate, in either dtype (the
    narrow kernel's products run there). ``f32_core_bound_ms`` is the same
    work with the flops on the ordinary f32 cores, the bound of the
    ordinary-core designs."""
    t_bytes = hbm_bytes(B, S, H, dk, dv, itemsize, qk_per_head=qk_per_head,
                        qk_itemsize=qk_itemsize)["minimum"] / \
        hbm_bytes_per_s * 1e3
    fl = flops(B, S, H, dk, dv, chunk)
    t_ops = fl / tensor_flops_per_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "f32_core_bound_ms": max(t_bytes, fl / f32_flops_per_s * 1e3)}


def bwd_hbm_bytes(B: int, S: int, H: int, dk: int, dv: int, chunk: int,
                  itemsize: int, *, qk_per_head: bool = False,
                  qk_itemsize: Optional[int] = None,
                  dh_final: bool = True, initial_state: bool = True,
                  dh0: bool = True) -> dict:
    """HBM bytes one backward call must move: q and k once (as in
    ``hbm_bytes``: one row for all heads unless ``qk_per_head``, in
    ``qk_itemsize``, default ``itemsize``), v and dy once, the f32 gates
    once, the f32 states before each chunk (the first only with an
    ``initial_state``: without one it is known to be zero) and dh_final
    once (where it is given); dq and dk (per head, in q's item size), dv,
    the f32 da and di, and dh0 (where it is asked for) written once. The
    defaults count everything."""
    qk_size = qk_itemsize or itemsize
    qk = 2 * B * S * dk * (H if qk_per_head else 1) * qk_size
    v_dy = 2 * B * S * H * dv * itemsize
    gates = 2 * B * S * H * 4
    states = (S // chunk - (0 if initial_state else 1) +
              (1 if dh_final else 0) + (1 if dh0 else 0)) * B * H * \
        dk * dv * 4
    grads = B * S * H * (2 * dk * qk_size + dv * itemsize) + \
        2 * B * S * H * 4
    return {"qk": qk, "v_dy": v_dy, "gates": gates, "states": states,
            "grads": grads, "minimum": qk + v_dy + gates + states + grads}


def bwd_flops(B: int, S: int, H: int, dk: int, dv: int, chunk: int, *,
              initial_state: bool = True, dh_final: bool = True,
              dh0: bool = True) -> int:
    """Multiply-adds (2 flops each) of ``ssd_scan_bwd_ref``'s products by
    chunks: over the Q(Q+1)/2 causal pairs the scores q·k and dy·v, then
    R k, Rᵀ q and Pᵀ dy; four (Q, dk, dv) products (H_n dy, dH v, dHᵀ k and
    the dH update) and <H_n, dH>. Less the products of states known to be
    zero, as the wide backward skips them: without an initial state H_0 dy
    and <H_0, dH_0>; without ``dh_final`` dH v and dHᵀ k at the last chunk
    and its <H, dH>; without ``dh0`` the update at the first chunk, which
    only dh0 reads. The defaults count everything."""
    nc = S // chunk
    pairs = chunk * (chunk + 1) // 2
    state = chunk * dk * dv
    per_chunk = pairs * (3 * dk + 2 * dv) + 4 * state + dk * dv
    skipped = (0 if initial_state else state) + \
        (0 if dh_final else 2 * state) + (0 if dh0 else state)
    zero_dots = {n for n, known in ((0, not initial_state),
                                    (nc - 1, not dh_final)) if known}
    skipped += len(zero_dots) * dk * dv
    return 2 * B * H * (nc * per_chunk - skipped)


def bwd_bound(B: int, S: int, H: int, dk: int, dv: int, chunk: int,
              itemsize: int, hbm_bytes_per_s: float,
              tensor_flops_per_s: float, f32_flops_per_s: float, *,
              qk_per_head: bool = False,
              qk_itemsize: Optional[int] = None,
              dh_final: bool = True, initial_state: bool = True,
              dh0: bool = True) -> dict:
    """The least time (ms) the card could take for one backward call, as
    ``bound``: the larger of its minimum HBM bytes (``bwd_hbm_bytes``) over
    the memory rate and its flops (``bwd_flops``) over the bf16 tensor
    cores' dense rate, both less what ``initial_state``, ``dh_final`` and
    ``dh0`` say is known to be zero or not asked for; ``f32_core_bound_ms``
    with those flops on the ordinary f32 cores, the yardstick of a design
    that does them there."""
    t_bytes = bwd_hbm_bytes(B, S, H, dk, dv, chunk, itemsize,
                            qk_per_head=qk_per_head,
                            qk_itemsize=qk_itemsize, dh_final=dh_final,
                            initial_state=initial_state,
                            dh0=dh0)["minimum"] / hbm_bytes_per_s * 1e3
    fl = bwd_flops(B, S, H, dk, dv, chunk, initial_state=initial_state,
                   dh_final=dh_final, dh0=dh0)
    t_ops = fl / tensor_flops_per_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "f32_core_bound_ms": max(t_bytes, fl / f32_flops_per_s * 1e3)}
