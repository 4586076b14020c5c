"""The port's CPU plain versions give the same bits on the first call in a
process as on later ones (fault F2, ROADMAP.md Queue 3).

On the CPU, PyTorch computes float32 ``exp``, ``log`` and ``sqrt`` with
MKL's vector math library, one call per OpenMP thread's slice, and the
threads' first calls in a fresh process can race in MKL's set-up: one
slice of the first ``torch.exp`` then came back from MKL's AVX2 kernel in
its low-accuracy mode, up to 1.5e-4 relative. The port computes those
functions through ``repro_torch.mathfn``, which does not enter MKL. The
race shows only now and then, so the first test runs the first calls in
fresh processes, and the second shows that the results do not depend on
which kernel MKL picks at all: each process is told a different
instruction set (``MKL_ENABLE_INSTRUCTIONS``), which changes the bits of
``torch.exp`` itself.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

SRC = str(Path(__file__).resolve().parents[1] / "src")
SSD_TOL = 3e-4           # f32, the reference's own (tests/test_torch_ssm.py)
SWA_TOL = 1e-5           # f32 softmax attention against f64 numpy

# The F2 inputs: the first case of test_torch_ssm.py's
# test_ssd_scan_matches_chunked_decay_attention (B 2, S 128, H 3, dk 16,
# dv 8, chunk 32, f32, no initial state), drawn the same way; the decay
# scores exp(segsum) are then 24,576 values, 8 threads' slices of 3,072.
CHILD = r"""
import hashlib, json, sys
import numpy as np
import torch
from repro_torch.kernels.ssd_scan import ssd_scan_ref
from repro_torch.kernels.swa_decode import swa_decode_ref

B, S, H, dk, dv, chunk = 2, 128, 3, 16, 8, 32
rng = np.random.default_rng(100 * S + H)
f = np.float32
q = rng.standard_normal((B, S, 1, dk)).astype(f)
k = rng.standard_normal((B, S, 1, dk)).astype(f)
v = rng.standard_normal((B, S, H, dv)).astype(f)
a = -(rng.random((B, S, H)) * 0.4).astype(f)
i = rng.random((B, S, H)).astype(f)
ops = (torch.from_numpy(q).expand(B, S, H, dk),
       torch.from_numpy(k).expand(B, S, H, dk), torch.from_numpy(v),
       torch.from_numpy(a), torch.from_numpy(i))
y1, h1 = ssd_scan_ref(*ops, chunk=chunk)          # the process's first call
y2, h2 = ssd_scan_ref(*ops, chunk=chunk)

# the strict recurrence in f64 with np.exp
h = np.zeros((B, H, dk, dv))
ys = []
for t in range(S):
    h = (np.exp(a[:, t].astype(np.float64))[..., None, None] * h
         + i[:, t, :, None, None] * k[:, t, 0, None, :, None]
         * v[:, t, :, None, :])
    ys.append(np.einsum("bd,bhdv->bhv", q[:, t, 0], h))
y64 = np.stack(ys, 1)


def excess(got, want, tol):
    got = got.double().numpy()
    return float((np.abs(got - want) - tol * (1 + np.abs(want))).max())


# K5's plain version: masked_fill, then softmax over 2 x 2 x 4 x 600 scores
rs = np.random.default_rng(7)
Bs, Hs, KV, hd, Ss, cur, window = 2, 8, 2, 16, 600, 599, 256
sq = rs.standard_normal((Bs, Hs, hd)).astype(f)
kc = rs.standard_normal((Bs, Ss, KV, hd)).astype(f)
vc = rs.standard_normal((Bs, Ss, KV, hd)).astype(f)
sargs = (torch.from_numpy(sq), torch.from_numpy(kc), torch.from_numpy(vc),
         cur, window)
o1 = swa_decode_ref(*sargs)
o2 = swa_decode_ref(*sargs)
G = Hs // KV
sc = np.einsum("bkgh,bskh->bkgs", sq.reshape(Bs, KV, G, hd).astype(np.float64)
               * hd ** -0.5, kc.astype(np.float64))
sc[..., : cur - window + 1] = -np.inf
p = np.exp(sc - sc.max(-1, keepdims=True))
p /= p.sum(-1, keepdims=True)
o64 = np.einsum("bkgs,bskh->bkgh", p, vc.astype(np.float64)).reshape(Bs, Hs, hd)

print(json.dumps({
    "ssd_equal": bool(torch.equal(y1, y2) and torch.equal(h1, h2)),
    "ssd_y_excess": excess(y1, y64, %(ssd)r),
    "ssd_h_excess": excess(h1, h, %(ssd)r),
    "swa_equal": bool(torch.equal(o1, o2)),
    "swa_excess": excess(o1, o64, %(swa)r)}))
""" % {"ssd": SSD_TOL, "swa": SWA_TOL}

# mathfn's functions and, as the control, torch.exp itself, each on 24,576
# values (8 threads' slices)
HASHES = r"""
import hashlib, json
import numpy as np
import torch
from repro_torch import mathfn

x = torch.from_numpy(np.random.default_rng(0).standard_normal(24576)
                     .astype(np.float32) * 3)
out = {name: hashlib.md5(fn().numpy().tobytes()).hexdigest() for name, fn in {
    "torch.exp": lambda: torch.exp(x), "exp": lambda: mathfn.exp(x),
    "exp_": lambda: mathfn.exp_(x.clone()),
    "log": lambda: mathfn.log(x.abs() + 0.1),
    "sqrt": lambda: mathfn.sqrt(x.abs())}.items()}
print(json.dumps(out))
"""

# (aten op, dtypes) that PyTorch's CPU build computes with MKL's vector math
# library: an op whose bits change with MKL_ENABLE_INSTRUCTIONS
MKL_VML = {"exp": None, "exp_": None, "log": "f", "log_": "f", "log2": "f",
           "log2_": "f", "sqrt": "f", "sqrt_": "f", "tanh": "f", "tanh_": "f",
           "erf": "f", "erf_": "f"}


class _AtenOps(TorchDispatchMode):
    """Records (op, dtype) of every aten op run on a CPU tensor."""

    def __init__(self):
        super().__init__()
        self.ops = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        first = next((a for a in args if isinstance(a, torch.Tensor)), None)
        if first is not None and first.device.type == "cpu":
            self.ops.add((func.overloadpacket.__name__, first.dtype))
        return func(*args, **(kwargs or {}))


class _AtenCalls(TorchDispatchMode):
    """Records every aten op's name with its arguments."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls.append((func.overloadpacket.__name__, args,
                           kwargs or {}))
        return func(*args, **(kwargs or {}))

    def float_adds(self):
        """The ops that add floats into one place in an order the card does
        not fix: index_add, index_put with accumulate, scatter_add and
        scatter_reduce with a sum (or mean)."""
        bad = []
        for op, args, kw in self.calls:
            acc = kw.get("accumulate", len(args) > 3 and args[3])
            red = kw.get("reduce", args[4] if len(args) > 4 else None)
            if (op.startswith("index_add") or op.startswith("scatter_add")
                    or (op.startswith(("index_put", "_index_put_impl"))
                        and acc)
                    or (op.startswith("scatter_reduce")
                        and red in ("sum", "mean"))):
                bad.append(op)
        return bad


def _enters_vml(op, dtype):
    if op not in MKL_VML or not dtype.is_floating_point:
        return False
    return MKL_VML[op] is None or dtype != torch.float64


def _run(code, envs):
    """Run ``code`` in one fresh python per entry of ``envs``, all at once;
    return each one's last output line as JSON."""
    procs = []
    for extra in envs:
        env = dict(os.environ, **extra)
        env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        outs.append(json.loads(out.strip().splitlines()[-1]))
    return outs


def test_first_call_matches_later_calls_in_fresh_processes():
    """In each of 8 fresh processes, the first calls of K4's and K5's plain
    versions give the same bits as the second, within the reference's
    tolerance of f64 numpy (np.exp) on the same inputs."""
    for rec in _run(CHILD, [{}] * 8):
        assert rec["ssd_equal"] and rec["swa_equal"], rec
        assert rec["ssd_y_excess"] <= 0 and rec["ssd_h_excess"] <= 0, rec
        assert rec["swa_excess"] <= 0, rec


def test_mathfn_does_not_depend_on_mkl_kernel_choice():
    """``mathfn`` gives the same bits whichever instruction set MKL is told
    to use, where ``torch.exp`` does not: no state of MKL's set-up can
    reach it."""
    recs = _run(HASHES, [{}, {"MKL_ENABLE_INSTRUCTIONS": "AVX2"},
                         {"MKL_ENABLE_INSTRUCTIONS": "SSE4_2"}])
    assert len({rec["torch.exp"] for rec in recs}) > 1   # the control
    for name in ("exp", "exp_", "log", "sqrt"):
        assert len({rec[name] for rec in recs}) == 1, name


def test_plain_paths_do_not_enter_mkl_vector_math():
    """No CPU plain path computes exp, log, sqrt, tanh or erf through an op
    that MKL's vector math library serves: the kernels' plain versions, the
    prefill and decode attention, the Mamba2 decode step, the trust
    scores, and training: the LLM loss with its backward (a dense decoder,
    an MoE decoder and the zamba2 hybrid, through K4's plain backward), the
    attention's chunked backward, and the clipped AdamW step; and the MoE
    decoder's and xLSTM's prefill and decode (xLSTM's mLSTM and sLSTM
    gates: log σ, exp, tanh), MLA's prefill and absorbed decode, and
    whisper's loss and gradients (its GELU's tanh)."""
    from repro_torch.configs.base import FederationConfig, TrainConfig
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.core import trust
    from repro_torch.kernels import ref
    from repro_torch.models import api, layers, ssm
    from repro_torch.optim import optimizers

    rng = np.random.default_rng(0)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    u, w = t(64, 300), t(64).abs()
    q, k, v = t(2, 128, 3, 16), t(2, 128, 3, 16), t(2, 128, 3, 8)
    a, i = -t(2, 128, 3).abs() * 0.4, t(2, 128, 3).abs()
    pos = torch.arange(256)
    c = u.mean(0)
    stats = trust.TrustStats(u @ c, (u * u).sum(1), (c * c).sum(), w)
    cfg = get_smoke_config("smollm-135m").replace(dtype="float32")
    lm_params = api.init(cfg, torch.Generator().manual_seed(0),
                         torch.device("cpu"))
    toks = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int64))
    tc = TrainConfig(optimizer="adamw", grad_clip=1.0, weight_decay=0.01)
    big = {"a": t(3, 40, 64), "b": t(3, 5000)}   # > 2048 values a leaf

    def lm_loss_and_grad():
        p = {k: v.requires_grad_(True) for k, v in lm_params.items()}
        loss, _ = api.lm_loss_fn(cfg, remat=True, kv_chunk=32)(
            p, {"tokens": toks, "labels": toks})
        torch.autograd.grad(loss, list(p.values()))

    mcfg = get_smoke_config("qwen2-moe-a2.7b").replace(dtype="float32")
    m_params = api.init(mcfg, torch.Generator().manual_seed(0),
                        torch.device("cpu"))

    def moe_loss_and_grad():
        p = {k: v.requires_grad_(True) for k, v in m_params.items()}
        loss, _ = api.lm_loss_fn(mcfg, remat=True)(
            p, {"tokens": toks, "labels": toks})
        torch.autograd.grad(loss, list(p.values()))

    def moe_decode():
        with torch.no_grad():
            _, cache = api.prefill(m_params, mcfg, {"tokens": toks}, 65)
            api.decode_step(m_params, mcfg, cache, toks[:, :1], 64)

    xcfg = get_smoke_config("xlstm-1.3b").replace(dtype="float32")
    x_params = api.init(xcfg, torch.Generator().manual_seed(0),
                        torch.device("cpu"))

    def xlstm_decode():
        with torch.no_grad():
            _, cache = api.prefill(x_params, xcfg, {"tokens": toks}, 65)
            api.decode_step(x_params, xcfg, cache, toks[:, :1], 64)

    zcfg = get_smoke_config("zamba2-7b").replace(dtype="float32")
    z_params = api.init(zcfg, torch.Generator().manual_seed(0),
                        torch.device("cpu"))

    def hybrid_loss_and_grad():
        p = {k: v.requires_grad_(True) for k, v in z_params.items()}
        loss, _ = api.lm_loss_fn(zcfg, remat=True)(
            p, {"tokens": toks, "labels": toks})
        torch.autograd.grad(loss, list(p.values()))

    acfg = get_smoke_config("minicpm3-4b").replace(dtype="float32")
    a_params = api.init(acfg, torch.Generator().manual_seed(0),
                        torch.device("cpu"))

    def mla_decode():
        with torch.no_grad():
            _, cache = api.prefill(a_params, acfg, {"tokens": toks}, 65)
            api.decode_step(a_params, acfg, cache, toks[:, :1], 64)

    wcfg = get_smoke_config("whisper-base").replace(dtype="float32")
    w_params = api.init(wcfg, torch.Generator().manual_seed(0),
                        torch.device("cpu"))
    frames = t(2, wcfg.encoder_seq, wcfg.d_model)

    def whisper_loss_and_grad():
        p = {k: v.requires_grad_(True) for k, v in w_params.items()}
        loss, _ = api.lm_loss_fn(wcfg, remat=True)(
            p, {"tokens": toks, "labels": toks, "frames": frames})
        torch.autograd.grad(loss, list(p.values()))

    def attention_backward():
        qkv = [t(1, 256, 8, 16).requires_grad_(True),
               t(1, 256, 2, 16).requires_grad_(True),
               t(1, 256, 2, 16).requires_grad_(True)]
        o = layers.blocked_attention(*qkv, q_positions=pos,
                                     kv_positions=pos, window=0, kv_chunk=64)
        torch.autograd.grad(o.square().sum(), qkv)

    def adamw_step():
        state = optimizers.adamw_init(big)
        state["count"] = torch.zeros((3,), dtype=torch.int32)
        grads = optimizers.clip_grads({k: 50 * v for k, v in big.items()},
                                      tc.grad_clip)
        optimizers.adamw_update(big, grads, state, tc)
    paths = {
        "trust_score_ref": lambda: ref.trust_score_ref(u),
        "trust_agg_ref": lambda: ref.trust_agg_ref(u, w),
        "fused_async_agg_ref": lambda: ref.fused_async_agg_ref(u, u, w, w),
        "ssd_scan_ref": lambda: ref.ssd_scan_ref(q, k, v, a, i, chunk=32),
        "ssd_scan_bwd_ref": lambda: ref.ssd_scan_bwd_ref(
            q, k, v, a, i, t(2, 128, 3, 8), t(2, 3, 16, 8), chunk=32),
        "swa_decode_ref": lambda: ref.swa_decode_ref(
            t(2, 8, 16), t(2, 600, 2, 16), t(2, 600, 2, 16), 599, 256),
        "blocked_attention": lambda: layers.blocked_attention(
            t(1, 256, 8, 16), t(1, 256, 2, 16), t(1, 256, 2, 16),
            q_positions=pos, kv_positions=pos, window=0, kv_chunk=64),
        "decode_attention": lambda: layers.decode_attention(
            t(2, 1, 8, 16), t(2, 300, 2, 16), t(2, 300, 2, 16),
            cur_index=299, window=128),
        "decay_attention_step": lambda: ssm.decay_attention_step(
            t(4, 8, 16), t(4, 8, 16), t(4, 8, 16), -t(4, 8).abs(),
            t(4, 8).abs(), t(4, 8, 16, 16)),
        "scores_from_stats": lambda: trust.scores_from_stats(
            stats, FederationConfig()),
        "lm_loss_and_grad": lm_loss_and_grad,
        "hybrid_loss_and_grad": hybrid_loss_and_grad,
        "moe_loss_and_grad": moe_loss_and_grad,
        "moe_decode": moe_decode,
        "xlstm_decode": xlstm_decode,
        "mla_decode": mla_decode,
        "whisper_loss_and_grad": whisper_loss_and_grad,
        "blocked_attention_backward": attention_backward,
        "adamw_update": adamw_step,
    }
    for name, fn in paths.items():
        with _AtenOps() as rec:
            fn()
        assert rec.ops, name
        bad = sorted((op, str(dt)) for op, dt in rec.ops
                     if _enters_vml(op, dt))
        assert not bad, (name, bad)


def test_moe_layer_adds_in_a_fixed_order():
    """The MoE layer's forward and backward (gather path, shared experts,
    ties and capacity drops, f32 and bf16) add no float through
    index_add, index_put with accumulate, scatter_add or a summing
    scatter_reduce: the ops whose CUDA versions add through atomics in an
    order that changes from run to run. The recorder does see them in the
    reference's direct translation (a scatter-add combine)."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models import moe

    cfg = MoEConfig(num_experts=8, top_k=2, d_ff_expert=32,
                    num_shared_experts=1, d_ff_shared=16, capacity_factor=1.0)
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator().manual_seed(0)
        p = {k: v.requires_grad_(True) for k, v in
             moe.init_moe(gen, 16, cfg, dtype, "cpu").items()}
        x = torch.randn((2, 32, 16), generator=gen).to(dtype)
        x[:, 16:] = x[:, :16]                   # ties at the capacity
        x.requires_grad_(True)
        with _AtenCalls() as rec:
            out, aux = moe.apply_moe(p, x, cfg)
            (out.float().square().sum() + aux).backward()
        ops = {op for op, _, _ in rec.calls}
        assert {"sort", "index_select"} <= ops, ops
        assert not rec.float_adds(), rec.float_adds()
        assert torch.isfinite(x.grad).all()

    with _AtenCalls() as rec:           # the control: a scatter-add combine
        torch.zeros((4, 3)).index_add(0, torch.tensor([0, 0]),
                                      torch.ones((2, 3)))
        torch.zeros((4, 3)).index_put_((torch.tensor([1, 1]),),
                                       torch.ones((2, 3)), accumulate=True)
        torch.zeros(4).scatter_add(0, torch.tensor([2, 2]), torch.ones(2))
        torch.zeros(4).scatter_reduce(0, torch.tensor([3, 3]),
                                      torch.ones(2), "sum")
        w = torch.ones((4, 3), requires_grad=True)
        w[torch.tensor([0, 0])].sum().backward()
    assert len(rec.float_adds()) == 5, rec.float_adds()
