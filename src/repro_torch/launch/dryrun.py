"""The dry run on one card (``repro.launch.dryrun``): every (architecture ×
input shape) traced once on fake tensors, its work counted and bounded by
the H100's published peaks, without a card.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--json out.json]
      [--max-calls N]

For each pair that ``registry.applicable`` allows, ``specs.setup_for``
builds the port's own step (an FL round of W workers, a prefill or a
decode step) on fake tensors on the card (``torch._subclasses.
FakeTensorMode``: shapes, dtypes and strides, no storage; on a PyTorch
built without CUDA the meta device stands in for the card, ``specs.DEVICE``),
and ``run_one`` runs it once under a counting ``TorchDispatchMode``
(``Counter``). It counts each ATen call on the card's tensors:

  * FLOPs by ``torch.utils.flop_counter``'s formulas (matmuls,
    convolutions, attention), by the dtype the product runs in: bf16 (and
    f16) at the tensor cores' ``PEAK_FLOPS_BF16``, f32 at the ordinary
    cores' ``PEAK_FLOPS_F32`` (the port runs f32 products with TF32 off);
  * bytes: the input and output bytes of every call that makes or writes
    storage, each call on its own (the unfused count, which is what the
    eager port moves), each distinct element once (a broadcast dimension
    is read once); views and bare allocations count 0;
  * the peak: the high-water mark of the live storage bytes on the card,
    the step's arguments included, each storage once (views share it),
    each rounded up to the caching allocator's 512-byte blocks.

The hand-written kernels take their wrappers' abstract branch on fake
tensors (``kernels._build.abstract``): their outputs come from
``torch.empty``, their scratch is held for the call, and their own FLOPs
(on the tensor cores for K4 and K5) and HBM bytes are added. Nothing is
built, loaded or launched.

The result keeps the reference's keys with their one-card meaning: one
device, mesh 1x1, no collectives (``collective_bytes_per_device`` and
``collective_s`` 0), ``compute_s`` = bf16 FLOPs / PEAK_FLOPS_BF16 + f32
FLOPs / PEAK_FLOPS_F32, ``memory_s`` = bytes / HBM_BW, ``lower_s`` the
trace's wall, and ``fits_one_card`` (the peak within HBM_BYTES). Nothing is
compiled and there is no HLO, so the reference's ``compile_s`` and its HLO
parser (``collective_bytes``) have no counterpart. These are counts and
bounds from published peaks, not times. ``--max-calls`` stops a trace
that would take longer than the caller wants to wait (a ``CUT`` line, no
failure): xlstm-1.3b's train_4k round runs the sLSTM loop, ~500 ATen
calls a position a block, ~178 M calls in all, hours of one core
(``tools/dryrun_projection.py`` projects such a step from shorter
traces). Importing this module changes
no environment variable.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.base import FederationConfig, INPUT_SHAPES, \
    ModelConfig, ShapeConfig
from repro_torch.configs.registry import ARCH_IDS, applicable, get_config, \
    get_shape
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import specs as speclib

aten = torch.ops.aten
BLOCK = 512            # the CUDA caching allocator's block: sizes round up
# calls that allocate without writing (their storage counts for the peak)
_ALLOCATE = {aten.empty.memory_format, aten.empty_strided.default,
             aten.empty_like.default, aten.new_empty.default,
             aten.new_empty_strided.default}
_FILL = {aten.fill_, aten.zero_}          # write their output only
_HALF = (torch.bfloat16, torch.float16)


def _nbytes(t: torch.Tensor) -> int:
    """The bytes of t's distinct elements: a broadcast dimension (stride 0)
    is read once."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n


def _tensors(x, found: list) -> list:
    """The tensors in x (a tensor, or lists, tuples and dicts of them),
    appended to ``found``."""
    if isinstance(x, torch.Tensor):
        found.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, found)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors(y, found)
    return found


class TraceCut(Exception):
    """A trace stopped at its budget of ATen calls (``Counter.max_calls``)."""


class Counter(TorchDispatchMode):
    """Counts the ATen calls of a step on fake tensors: ``flops`` by
    bucket ("bf16", "f32"), ``nbytes`` moved, ``calls``, and the live and
    peak storage bytes on the card (``track`` the arguments first). The
    kernels' abstract branches add theirs through ``kernel``
    (``_build.abstract`` finds the counter on the dispatch mode stack).
    With ``max_calls`` the call past that many raises ``TraceCut``."""

    def __init__(self, max_calls: int = None):
        super().__init__()
        self.max_calls = max_calls
        self.flops = {"bf16": 0, "f32": 0}
        self.nbytes = 0
        self.calls = 0
        self.live = 0
        self.peak = 0
        self.kernels = {}
        self._sizes = {}

    # -- storage -------------------------------------------------------------

    def track(self, t: torch.Tensor) -> None:
        """Count t's storage as live (once) until it is freed."""
        if t.device.type == "cpu":
            return
        s = t.untyped_storage()
        key = s._cdata
        if key in self._sizes:
            return
        size = -(-s.nbytes() // BLOCK) * BLOCK
        self._sizes[key] = size
        self.live += size
        self.peak = max(self.peak, self.live)
        weakref.finalize(s, self._free, key)

    def _free(self, key) -> None:
        self.live -= self._sizes.pop(key, 0)

    # -- counting ------------------------------------------------------------

    def kernel(self, name: str, flops: int, nbytes: int,
               tensor_cores: bool) -> None:
        """A hand-written kernel's own work (its wrapper's abstract
        branch)."""
        self.flops["bf16" if tensor_cores else "f32"] += flops
        self.nbytes += nbytes
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0,
                                           "bytes": 0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes

    def _moved(self, func, ins, outs) -> int:
        """Bytes a call moves: 0 for an allocation, a query without a
        tensor result (``prim.device``) or a view (every output on an
        input's storage, no argument written); the source and the
        destination of a copy; the output of a fill; otherwise every
        input read and every output written."""
        if func in _ALLOCATE or not outs:
            return 0
        packet = func._overloadpacket
        if packet is aten.copy_:
            return _nbytes(ins[0]) + _nbytes(ins[1])
        if packet in _FILL:
            return sum(_nbytes(t) for t in outs)
        if not func._schema.is_mutable:
            sources = {t.untyped_storage()._cdata for t in ins}
            if all(t.untyped_storage()._cdata in sources for t in outs):
                return 0
        return sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.max_calls is not None and self.calls >= self.max_calls:
            raise TraceCut(self.calls)
        out = func(*args, **kwargs)
        self.calls += 1
        outs = _tensors(out, [])
        for t in outs:
            self.track(t)
        ins = _tensors(kwargs, _tensors(args, []))
        if all(t.device.type == "cpu" for t in ins + outs):
            return out
        packet = func._overloadpacket
        if packet in flop_registry and outs:
            n = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops["bf16" if outs[0].dtype in _HALF else "f32"] += n
        self.nbytes += self._moved(func, ins, outs)
        return out


def _model_flops(cfg: ModelConfig, sh: ShapeConfig):
    """(MODEL_FLOPS, N active) of ``cfg`` at ``sh``: 6·N·D for a train
    round, 2·N·D for a prefill, 2·N a decoded token; N the parameters
    (``specs.init_specs``), of a MoE the active ones (top_k of the routed
    experts a layer)."""
    n_total = sum(x.numel() for x in speclib.init_specs(cfg).values())
    if cfg.moe.enabled:
        e = cfg.moe
        per_layer_routed = 3 * cfg.d_model * e.d_ff_expert
        n_active = (n_total
                    - cfg.num_layers * e.num_experts * per_layer_routed
                    + cfg.num_layers * e.top_k * per_layer_routed)
    else:
        n_active = n_total
    tokens = sh.global_batch * (sh.seq_len if sh.kind != "decode" else 1)
    factor = 6 if sh.kind == "train" else 2
    return factor * n_active * tokens, n_active


def model_flops(arch: str, shape_name: str):
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE) for train; 2·N·D
    for prefill; 2·N per token for decode. Returns (flops, N active)."""
    return _model_flops(get_config(arch), get_shape(shape_name))


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            head_gather: bool = False, local_steps: int = 1,
            setup_override=None, max_calls: int = None) -> dict:
    """Trace (arch, shape)'s step once on fake tensors and count it.
    ``setup_override`` takes ``specs.setup_for``'s place (same arguments,
    a ``specs.Setup`` back). A trace that reaches ``max_calls`` ATen calls
    stops there: the result then holds only ``cut`` True, the calls and
    the trace's wall so far (``lower_s``)."""
    mesh = meshlib.make_production_mesh(multi_pod=multi_pod)
    fed = FederationConfig()
    kw = {}
    if INPUT_SHAPES[shape_name].kind == "train":
        kw = {"head_gather": head_gather, "local_steps": local_steps}
    setup = setup_override or speclib.setup_for
    with speclib.new_fake_mode():
        step = setup(arch, shape_name, mesh, fed, **kw)
        counter = Counter(max_calls)
        for t in _tensors(step.args, []):
            counter.track(t)
        args_bytes = counter.live
        t0 = time.monotonic()
        try:
            with counter:
                out = step.fn(*step.args)
        except TraceCut:
            return {"arch": arch, "shape": shape_name, "cut": True,
                    "aten_calls": counter.calls,
                    "lower_s": time.monotonic() - t0}
        t_lower = time.monotonic() - t0
        del out
        mf, n_active = _model_flops(step.cfg, step.shape)
    peak = counter.peak
    f16, f32 = counter.flops["bf16"], counter.flops["f32"]
    flops_total = f16 + f32
    compute_s = f16 / meshlib.PEAK_FLOPS_BF16 + f32 / meshlib.PEAK_FLOPS_F32
    memory_s = counter.nbytes / meshlib.HBM_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": 0.0}
    return {
        "arch": arch, "shape": shape_name, "mesh": "1x1", "devices": 1,
        "flops_per_device": flops_total,
        "flops_bf16": f16, "flops_f32": f32,
        "bytes_per_device": counter.nbytes,
        "collective_bytes_per_device": 0, "collective_breakdown": {},
        **terms,
        "compute_bf16_s": f16 / meshlib.PEAK_FLOPS_BF16,
        "compute_f32_s": f32 / meshlib.PEAK_FLOPS_F32,
        "dominant": max(terms, key=terms.get),
        "model_flops": mf, "params_active": n_active,
        "useful_flops_ratio": mf / flops_total if flops_total else 0.0,
        "peak_memory_per_device_gb": peak / 2**30,
        "temp_gb": (peak - args_bytes) / 2**30,
        "args_gb": args_bytes / 2**30,
        "peak_bytes": peak, "args_bytes": args_bytes,
        "fits_one_card": peak <= meshlib.HBM_BYTES,
        "aten_calls": counter.calls, "kernels": counter.kernels,
        "lower_s": t_lower,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--head-gather", action="store_true",
                    help="paper-faithful cluster-head gather aggregation")
    ap.add_argument("--local-steps", type=int, default=1)
    ap.add_argument("--json", default="")
    ap.add_argument("--max-calls", type=int, default=None,
                    help="stop a trace after this many ATen calls (CUT)")
    args = ap.parse_args(argv)
    if args.multi_pod:
        try:
            meshlib.make_production_mesh(multi_pod=True)
        except ValueError as e:
            sys.exit(f"dryrun: {e}")

    if args.all:
        combos = [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape required unless --all")
        combos = [(args.arch, args.shape)]

    results, failures, cuts = [], [], []

    def save():
        if args.json:
            with open(args.json, "w") as f:
                json.dump(results, f, indent=1)
    for a, s in combos:
        ok, reason = applicable(a, s)
        if not ok:
            print(f"SKIP  {a:18s} {s:12s} {reason}")
            results.append({"arch": a, "shape": s, "skipped": reason})
            continue
        try:
            r = run_one(a, s, head_gather=args.head_gather,
                        local_steps=args.local_steps,
                        max_calls=args.max_calls)
            results.append(r)
            if r.get("cut"):
                cuts.append((a, s))
                print(f"CUT   {a:18s} {s:12s} after {r['aten_calls']} ATen "
                      f"calls in {r['lower_s']:.0f}s (--max-calls)")
            else:
                print(f"OK    {a:18s} {s:12s} mesh={r['mesh']} "
                      f"compute={r['compute_s']:.4f}s "
                      f"memory={r['memory_s']:.4f}s "
                      f"coll={r['collective_s']:.4f}s "
                      f"dom={r['dominant']:10s} "
                      f"mem/dev={r['peak_memory_per_device_gb']:.2f}GiB "
                      f"fits={'yes' if r['fits_one_card'] else 'no'} "
                      f"lower={r['lower_s']:.0f}s")
            sys.stdout.flush()
        except Exception as e:
            failures.append((a, s, repr(e)))
            print(f"FAIL  {a:18s} {s:12s} {e!r}")
            traceback.print_exc()
            sys.stdout.flush()
        save()
    save()
    if failures:
        print(f"\n{len(failures)} FAILURES")
        sys.exit(1)
    if cuts:
        print(f"\n{len(cuts)} CUT at --max-calls {args.max_calls}: "
              + ", ".join(f"{a} {s}" for a, s in cuts))
    print("\nALL DRY-RUNS PASSED")


if __name__ == "__main__":
    main()
