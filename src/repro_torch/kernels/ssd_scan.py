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
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import mathfn
from repro_torch.kernels import _build

MAX_CHUNK = 128          # chunk positions the kernel takes
MAX_D = 128              # dk and dv the kernel takes

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
                 fault: Optional[str] = None, parts: Optional[int] = None):
    """Plain PyTorch version, the reference's chunked algorithm
    (``ssm.chunked_decay_attention``) in f32 → (y in v's dtype, final state
    f32). ``fault`` (one of ``FAULTS``) plants that error. ``parts``
    rounds the three operands that the kernel splits into bf16 parts —
    the gated scores, the carried state in q·h and w·v in the state
    update — to that many parts (``bf16_parts``), so the CPU can show
    what the split costs against the card tolerance."""
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
    h_before = torch.stack(h_before, dim=1)                 # (B,nc,H,dk,dv)

    if parts is not None:
        h_before = bf16_parts(h_before, parts)
    y_inter = torch.einsum("bnqhd,bnhdv->bnqhv", qc, h_before)
    y_inter = y_inter * decay_from_start[..., None]
    y = (y_intra + y_inter).reshape(B, S, H, dv)
    if fault == "final_state_stale":
        h = h_before[:, -1]
    return y.to(v.dtype), h


def excess(got: torch.Tensor, want32: torch.Tensor,
           rtol: float = 0.0) -> float:
    """Largest amount by which ``got`` lies outside the card tolerance
    around the plain f32 result ``want32`` (above): > 0 fails."""
    tol = ATOL_REL * want32.abs().max() + rtol * want32.abs()
    return float(((got.float() - want32).abs() - tol).max())


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


def _check_card(q, k, v, chunk):
    """What the CUDA kernel needs beyond the function's own domain."""
    dk, dv = q.shape[-1], v.shape[-1]
    if not (q.dtype == k.dtype == v.dtype) or \
            q.dtype not in _build.KERNEL_DTYPES:
        raise TypeError(f"q, k, v dtypes {q.dtype}, {k.dtype}, {v.dtype}: "
                        f"the kernel takes one of float32 or bfloat16 for "
                        f"all three")
    if chunk > MAX_CHUNK or dk > MAX_D or dv > MAX_D:
        raise ValueError(f"chunk {chunk}, dk {dk}, dv {dv}: the kernel takes "
                         f"chunk <= {MAX_CHUNK} and dk, dv <= {MAX_D}")
    if any(x.stride(3) != 1 for x in (q, k, v)):
        raise ValueError("q, k, v need contiguous rows (last stride 1)")


def ssd_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             a: torch.Tensor, i: torch.Tensor, *, chunk: int,
             initial_state: Optional[torch.Tensor] = None):
    """q, k (B, S, H, dk), v (B, S, H, dv), gates a, i (B, S, H), S a
    multiple of ``chunk`` → (y (B, S, H, dv) in v's dtype, final state
    (B, H, dk, dv) f32). On CUDA tensors this launches the kernel (counted
    in ``.launches``): q, k, v float32 or bfloat16 alike, read through their
    strides (a head stride of 0 reads one row for every head) with
    contiguous rows; the gates and the initial state are read as
    contiguous f32. On CPU tensors it returns the plain version."""
    chunk = int(chunk)
    _check(q, k, v, a, i, chunk, initial_state)
    if q.device.type == "cpu":
        return ssd_scan_ref(q, k, v, a, i, chunk=chunk,
                            initial_state=initial_state)
    _check_card(q, k, v, chunk)
    _build.check_no_grad("ssd_scan", q, k, v, a, i, initial_state)
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    dev = q.device
    a32 = a.to(torch.float32).contiguous()
    i32 = i.to(torch.float32).contiguous()
    h0 = None if initial_state is None else \
        initial_state.to(torch.float32).contiguous()
    y = torch.empty((B, S, H, dv), dtype=v.dtype, device=dev)
    h = torch.empty((B, H, dk, dv), dtype=torch.float32, device=dev)
    _build.launch("repro_ssd_scan", dev, _build.ptr(q), _build.ptr(k),
                  _build.ptr(v), _build.ptr(a32), _build.ptr(i32),
                  None if h0 is None else _build.ptr(h0),
                  int(v.dtype == torch.bfloat16), B, S, H, dk, dv, chunk,
                  *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                  _build.ptr(y), _build.ptr(h))
    ssd_scan.launches += 1
    return y, h


ssd_scan.launches = 0


def hbm_bytes(B: int, S: int, H: int, dk: int, dv: int,
              itemsize: int) -> dict:
    """HBM bytes one K4 call must move: q and k once (one row serves every
    head, as in Mamba2), v once, the f32 gates once, y written once and
    the f32 final state written once."""
    qk = 2 * B * S * dk * itemsize
    vy = 2 * B * S * H * dv * itemsize
    gates = 2 * B * S * H * 4
    state = B * H * dk * dv * 4
    return {"qk": qk, "v_y": vy, "gates": gates, "state": state,
            "minimum": qk + vy + gates + state}


def flops(B: int, S: int, H: int, dk: int, dv: int, chunk: int) -> int:
    """Multiply-adds (2 flops each) the recurrence needs by chunks: the
    causal half of the scores and of their product with v (Q(Q+1)/2
    pairs), q against the carried state, and the state update."""
    pairs = chunk * (chunk + 1) // 2
    per_chunk = pairs * (dk + dv) + 2 * chunk * dk * dv
    return 2 * B * H * (S // chunk) * per_chunk


def bound(B: int, S: int, H: int, dk: int, dv: int, chunk: int,
          itemsize: int, hbm_bytes_per_s: float, tensor_flops_per_s: float,
          f32_flops_per_s: float) -> dict:
    """The least time (ms) the card could take for one K4 call: the larger
    of its minimum HBM bytes over the memory rate and its flops over the
    bf16 tensor cores' dense rate, in either dtype (the kernel's products
    run there). ``f32_core_bound_ms`` is the same work with the flops on
    the ordinary f32 cores, the bound of the first, ordinary-core design."""
    t_bytes = hbm_bytes(B, S, H, dk, dv, itemsize)["minimum"] / \
        hbm_bytes_per_s * 1e3
    fl = flops(B, S, H, dk, dv, chunk)
    t_ops = fl / tensor_flops_per_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "f32_core_bound_ms": max(t_bytes, fl / f32_flops_per_s * 1e3)}
