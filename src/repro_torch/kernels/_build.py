"""Build, load and call the port's CUDA kernels.

The sources under ``repro_torch/csrc/`` compile with plain ``nvcc`` for
``sm_90a`` into one shared library with a C interface, loaded through
``ctypes``. The library is built at first use into
``build/repro_torch_kernels/<hash>/`` at the root of the checkout, keyed by
a hash of the sources and the compiler flags, so an edited source never
loads a stale build. Each ``.cu`` compiles in its own ``nvcc`` process, all
started together, and one more ``nvcc`` links the objects. Nothing but the
repository's sources and the CUDA toolkit goes into the build.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``launch`` raises on a non-zero code. Nothing here
runs at import time: the CPU tests import every module of the package.

Every wrapper has an abstract branch (``abstract``) for fake tensors, the
dry run's (``repro_torch.launch.dryrun``): there it neither builds, loads
nor launches anything.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    "repro_trust_score": [_P] + [_I] * 7 + [_P] * 6,
    "repro_trust_agg": [_P, _I, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    "repro_fused_async_agg": [_P, _I, _P, _P, _P] + [_I] * 5 + [_P] * 5,
    "repro_swa_decode": [_P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _L, _I, _I,
                         _I, _I, _I, _P, _P, _P, _P],
    "repro_ssd_scan": [_P] * 6 + [_I] * 7 + [_L] * 9 + [_P] * 4,
    "repro_ssd_scan_bwd": [_P] * 8 + [_I] * 7 + [_L] * 9 + [_P] * 7,
    "repro_ssd_scan_bwd_design": [_I] * 4,
    "repro_ssd_scan_wide": [_P] * 6 + [_I] * 6 + [_L] * 9 + [_P, _L] +
    [_P] * 4,
    "repro_ssd_scan_wide_scratch": [_I] * 6 + [_P],
    "repro_ssd_scan_wide_bwd": [_P] * 8 + [_I] * 7 + [_L] * 9 + [_P, _L] +
    [_P] * 7,
    "repro_ssd_scan_wide_bwd_scratch": [_I] * 8 + [_P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # wall time of this process's build
build_log = ""                          # nvcc/ptxas output of that build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "librepro_torch_kernels.so"


def build() -> Path:
    """Compile the library if this source hash has none yet; return it."""
    global build_seconds, build_log
    lib = library_path()
    if lib.exists():
        return lib
    out = lib.parent
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.monotonic()
    procs = []
    for src in sorted(CSRC.glob("*.cu")):
        # per-process object names: concurrent builders never share a file
        obj = out / f"{src.stem}-{os.getpid()}.o"
        procs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src), "-o",
             str(obj)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for src, _, p in procs:
        text, _ = p.communicate()
        logs.append(f"== {src.name}\n{text}")
        if p.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
    tmp = out / f"tmp-{os.getpid()}.so"
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
         *(str(obj) for _, obj, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib)                 # atomic: never a half-written .so
    build_seconds = time.monotonic() - t0
    build_log = "\n".join(logs)
    return lib


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry ``name`` with ``args`` followed by the current stream
    of ``device``; raise if the launch reported an error."""
    lib = load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(*args, stream)
    if err != 0:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def launch_records(fn, calls: int = 4):
    """What ``calls`` calls of ``fn`` asked of the card, from
    torch.profiler: the names of the runtime API calls that put work on a
    stream (kernel launches, copies, memsets), in order, and the names of
    the device activities recorded. The runtime calls are recorded on the
    host and come complete. The device records do not: on the H100 the
    profiler has lost some or all of a short session's kernel records once
    the process had run other work for a while, so only the names of those
    recorded can be checked."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    prof.stop()
    events = prof.events()
    enqueued = [e.name for e in events if e.device_type == DeviceType.CPU
                and any(w in e.name for w in ("Launch", "Memcpy", "Memset"))]
    device = [e.name for e in events if e.device_type == DeviceType.CUDA
              and e.name not in ("Activity Buffer Request", "Buffer Flush")]
    return enqueued, device


# -- argument checks shared by the wrappers ------------------------------------

KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def check_updates(updates: torch.Tensor) -> None:
    """The (W, D) update matrix every trust kernel takes (the meta device
    stands in for the card in the dry run on a build without CUDA)."""
    if updates.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"updates on unsupported device {updates.device}")
    if updates.dtype not in KERNEL_DTYPES:
        raise TypeError(f"updates dtype {updates.dtype}: the kernels take "
                        f"float32 or bfloat16")
    if updates.ndim != 2 or updates.shape[0] < 1 or updates.shape[1] < 1:
        raise ValueError(f"updates must be a non-empty (W, D) matrix, got "
                         f"shape {tuple(updates.shape)}")
    if updates.device.type != "cpu" and not updates.is_contiguous():
        raise ValueError("updates must be contiguous")


def check_no_grad(kernel: str, *tensors: Optional[torch.Tensor]) -> None:
    """For the kernels without a backward (K1-K3 and K5; K4 has one, in
    ``ssd_scan``'s ``autograd.Function``): their outputs come from
    ``torch.empty`` and carry no graph. On the card, refuse a call that
    autograd would differentiate through (grad mode on and an input that
    requires grad), whose gradient would otherwise be lost without a word
    (fault F4). The plain versions on the CPU are differentiable and need
    no such check."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: the CUDA kernel has no backward, and an input "
            f"requires grad; call it under torch.no_grad() (or on CPU "
            f"tensors, whose plain version autograd follows)")


def check_operand(x: torch.Tensor, name: str, shape: tuple,
                  like: torch.Tensor) -> None:
    """A float32 operand of a kernel: on ``like``'s device, this shape,
    contiguous on the card."""
    if x.device != like.device:
        raise ValueError(f"{name} on {x.device}, updates on {like.device}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(x.shape)} != {tuple(shape)}")
    if x.device.type != "cpu":
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def aligned16(x: torch.Tensor) -> bool:
    """Whether x's first element lies on a 16-byte boundary. A fake tensor
    has no address: its offset into its storage decides (the caching
    allocator hands out storages on 512-byte boundaries)."""
    if isinstance(x, FakeTensor):
        return x.storage_offset() * x.element_size() % 16 == 0
    return x.data_ptr() % 16 == 0


def ptr(x: Optional[torch.Tensor]) -> ctypes.c_void_p:
    """x's device address, or a null pointer for None."""
    return ctypes.c_void_p(None if x is None else x.data_ptr())


def device_of(x: torch.Tensor) -> torch.device:
    """x's CUDA device with its index (a meta tensor's device as it is)."""
    return x.device if x.device.index is not None or \
        x.device.type != "cuda" else \
        torch.device("cuda", torch.cuda.current_device())


# (kernel, device index, stream) -> (arrival counters, f32 scratch)
_scratch: dict = {}


def scratch(kernel: str, device: torch.device, counters: int, floats: int):
    """The int32 arrival counters and the f32 scratch that one launch of
    ``kernel`` uses to combine its blocks' partial sums, kept per device and
    current stream (one launch at a time uses them) and grown when a call
    needs more. The kernels leave their counters at 0, so the counters are
    zeroed only when allocated (a fill kernel, that once)."""
    stream = torch.cuda.current_stream(device).cuda_stream
    key = (kernel, device.index, stream)
    cnt, part = _scratch.get(key, (None, None))
    if cnt is None or cnt.numel() < counters:
        cnt = torch.zeros(max(counters, 1024), dtype=torch.int32,
                          device=device)
    if part is None or part.numel() < floats:
        part = torch.empty(max(floats, 1 << 18), dtype=torch.float32,
                           device=device)
    _scratch[key] = (cnt, part)
    return cnt, part


def scratch_bytes(counters: int, floats: int) -> int:
    """Bytes of the scratch ``scratch`` allocates for a launch that needs
    ``counters`` arrival counters and ``floats`` f32 partial sums."""
    return 4 * max(counters, 1024) + 4 * max(floats, 1 << 18)


# -- the dry run's abstract branch ---------------------------------------------

def is_fake(x: torch.Tensor) -> bool:
    """Whether x is a fake tensor (the dry run's), which takes a wrapper's
    abstract branch."""
    return isinstance(x, FakeTensor)


def abstract(kernel: str, x: torch.Tensor, *, flops: int, nbytes: int,
             scratch: int = 0, tensor_cores: bool = False) -> None:
    """The abstract branch of a kernel wrapper, for a fake tensor ``x``:
    the dry run traces a step on fake tensors, which allocate nothing. It
    holds a fake tensor of ``scratch`` bytes on x's device while the call
    lasts, as the launch holds its scratch, and adds the kernel's
    ``flops`` (on the tensor cores, or on the ordinary f32 cores) and
    ``nbytes`` of HBM traffic to the innermost dry-run counter. The wrapper
    then returns the outputs it made with ``torch.empty``, of the real
    launch's shapes, dtypes and strides. Nothing is built, loaded or
    launched, and no launch counter moves. The counter is the innermost
    active dispatch mode that counts kernels (``launch.dryrun.Counter``),
    if any."""
    from torch.utils._python_dispatch import \
        _get_current_dispatch_mode_stack
    assert is_fake(x)
    held = torch.empty(scratch, dtype=torch.uint8, device=x.device) \
        if scratch else None
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if hasattr(mode, "kernel"):
            mode.kernel(kernel, flops, nbytes, tensor_cores)
            break
    del held
