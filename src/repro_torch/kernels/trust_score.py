"""K1: per-worker trust statistics of the packed (W, D) update matrix.

Against the consensus c = mean_w u_w::

    dot[w] = <u_w, c>      sq_u[w] = ‖u_w‖²      sq_c = ‖c‖²

everything ``EvaluatePerformance`` needs for the cosine and norm terms.
``trust_score_stats`` launches the CUDA kernel (``csrc/trust_score.cu``)
for a tensor on the card and runs the plain version, ``trust_score_ref``,
for a tensor on the CPU. The kernel reads the matrix from HBM once, in one
launch: thread block clusters hold column strips of all W rows in their
registers and share the strips' column sums through distributed shared
memory (``plan``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build

SMS = 132                 # streaming multiprocessors of an H100 SXM
THREADS = 256             # kThreads in csrc/trust_score.cu
# rows of a strip a thread holds, by element size (rows_a_thread in
# csrc/trust_score.cu), and the bytes of a strip a block holds
ROWS_A_THREAD = {4: 20, 2: 16}
BLOCK_BYTES = {isz: THREADS * 16 * k for isz, k in ROWS_A_THREAD.items()}
MAX_W = 65536             # rows the kernel takes (16 blocks of 16-byte
                          # strips hold 65536 bf16 rows)
STRIPS = (256, 128, 64, 32, 16)   # bytes of a strip row, widest first
CLUSTERS = (1, 2, 4, 8, 16)       # blocks of a cluster, fewest first

# errors the plain version can plant, so a check can show that its
# tolerance sees them (``chip_smoke.py`` and the tests)
FAULTS = ("last_strip_dropped",        # the plan's last column strip missing
          "consensus_without_last_rank",   # c misses the last rank's rows
          "sq_c_first_strip")          # |c|² of the first strip only


class Plan(NamedTuple):
    """One launch of K1: ``clusters`` clusters of ``cluster`` blocks; a
    strip is ``cols`` columns (``strip`` bytes a row), ``strips`` of them;
    block r of a cluster holds rows [r * rows, (r + 1) * rows); cluster g
    walks strips g, g + clusters, ..."""
    cluster: int
    strip: int
    cols: int
    rows: int
    clusters: int
    strips: int


def plan(W: int, D: int, itemsize: int, *, cluster: Optional[int] = None,
         strip: Optional[int] = None) -> Plan:
    """The widest strip rows (256 bytes: 16 threads a row, a warp two
    rows), then the smallest cluster whose blocks hold their rows of a
    strip in registers (at most BLOCK_BYTES[itemsize]); one block an SM. Depends on
    the shape alone, so the summation order does too. ``cluster`` and
    ``strip`` pin those choices (to time other plans)."""
    if not 1 <= W <= MAX_W:
        raise ValueError(f"W = {W}: K1 takes 1 to {MAX_W} rows")
    for sb in STRIPS if strip is None else (strip,):
        cols = sb // itemsize
        strips = -(-D // cols)
        for c in CLUSTERS if cluster is None else (cluster,):
            rows = -(-W // c)
            if rows * sb <= BLOCK_BYTES[itemsize]:
                return Plan(c, sb, cols, rows, min(strips, SMS // c), strips)
    raise ValueError(f"no K1 plan for W = {W}, D = {D}, itemsize "
                     f"{itemsize}, cluster {cluster}, strip {strip}")


def trust_score_ref(updates: torch.Tensor, fault: Optional[str] = None):
    """Plain PyTorch version: (W, D) → (dot (W,), sq_u (W,), sq_c ()) f32.
    ``fault`` (one of ``FAULTS``) plants that error, in the kernel's plan
    for this shape: the last column strip dropped from every statistic, the
    consensus summed without the last cluster rank's rows (all rows at one
    block a cluster), or ‖c‖² over the first strip only."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; known: {FAULTS}")
    u = updates.float()
    W, D = u.shape
    p = plan(W, D, updates.element_size()) if fault else None
    if fault == "last_strip_dropped":
        u = u[:, :(p.strips - 1) * p.cols]
    if fault == "consensus_without_last_rank":
        c = u[:(p.cluster - 1) * p.rows].sum(dim=0) / W
    else:
        c = u.mean(dim=0)
    sq_c = (c[:p.cols] if fault == "sq_c_first_strip" else c).square().sum()
    return u @ c, (u * u).sum(dim=1), sq_c


def trust_score_stats(updates: torch.Tensor):
    """(W, D) float32 or bfloat16 → (dot (W,), sq_u (W,), sq_c ()) float32,
    read in f32 and summed in f32 in a fixed order. On a CUDA tensor this
    launches the kernel (and counts the launch in ``.launches``; W at most
    MAX_W; on a fake tensor the abstract branch, ``_build.abstract``); on a
    CPU tensor it returns the plain version."""
    _build.check_updates(updates)
    if updates.device.type == "cpu":
        return trust_score_ref(updates)
    _build.check_no_grad("trust_score_stats", updates)
    W, D = updates.shape
    return _launch(updates, plan(W, D, updates.element_size()))


def _launch(updates: torch.Tensor, p: Plan):
    """One launch of the kernel on ``updates`` (on the card) in plan ``p``;
    its arrival counters and partial sums live in a scratch kept per device
    and stream (``_build.scratch``)."""
    W, D = updates.shape
    dev = _build.device_of(updates)
    floats = 2 * p.clusters * W + p.clusters
    f32 = dict(dtype=torch.float32, device=dev)
    dot = torch.empty((W,), **f32)
    sq_u = torch.empty((W,), **f32)
    sq_c = torch.empty((), **f32)
    if _build.is_fake(updates):
        _build.abstract("trust_score", updates, flops=flops(W, D),
                        nbytes=hbm_bytes(W, D, updates.element_size())[
                            "total"],
                        scratch=_build.scratch_bytes(p.cluster, floats))
        return dot, sq_u, sq_c
    cnt, part = _build.scratch("trust_score", dev, p.cluster, floats)
    _build.launch("repro_trust_score", dev, _build.ptr(updates),
                  int(updates.dtype == torch.bfloat16), W, D, p.cluster,
                  p.strip, p.rows, p.clusters,
                  _build.ptr(cnt), _build.ptr(part), _build.ptr(dot),
                  _build.ptr(sq_u), _build.ptr(sq_c))
    trust_score_stats.launches += 1
    return dot, sq_u, sq_c


trust_score_stats.launches = 0


def hbm_bytes(W: int, D: int, itemsize: int) -> dict:
    """HBM traffic of one K1 call: the update matrix once, the clusters'
    row and ‖c‖² sums (2 · clusters · W + clusters f32), each written once
    and read once by the block that combines them, and the (2W + 1) f32
    outputs. ``minimum`` counts each input read once and each output
    written once."""
    upd = W * D * itemsize
    G = plan(W, D, itemsize).clusters
    outputs = (2 * W + 1) * 4
    other = 2 * (2 * G * W + G) * 4 + outputs
    return {"update_read": upd, "other": other, "total": upd + other,
            "minimum": upd + outputs}


def flops(W: int, D: int) -> int:
    """Flops of one K1 call: the consensus (W D adds), dot and sq_u (2 W D
    each) and sq_c (2 D)."""
    return 5 * W * D + 2 * D
