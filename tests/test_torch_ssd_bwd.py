"""K4's backward on the CPU against the JAX package: the plain backward
``ssd_scan.ssd_scan_bwd_ref`` (written out by chunks, as the kernel
computes it) and the ``autograd.Function`` that ``ssd_scan`` takes under
grad, both against ``jax.vjp`` of the reference's
``chunked_decay_attention`` with an initial state and its final state (so
that the gradients of both, dh0 and dh_final, are covered), and against
``torch.autograd`` through the plain forward ``ssd_scan_ref``; the plain
backward's planted faults against the card tolerance; and the backward's
bound accounting.

Inputs are made from a seed with numpy and handed to both packages. q and
k are one row per (b, s) shared by every head — ``broadcast_to`` in JAX, a
head-stride-0 ``expand`` in PyTorch, whose backward sums the per-head
gradients — or their own for every head. Gates: the model's (i =
softplus(N(0, 1)), a = i · -linspace(1, 16, H), zamba2's A at init) or
gentle ones (a ∈ [-0.02, 0]), under which the state carried across chunks
matters. The JAX model modules are imported through the ``jref`` fixture,
the workaround for fault F1 of the reference (ROADMAP.md, Queue 3; see
``tests/test_torch_hybrid.py``).

Tolerances, each output relative to its own largest reference value:

  f32   ``ssd_scan.BWD_ATOL_REL`` = 1e-4 · max|ref| (the card's bound; the
        plain backward in f32 stays within 1.7e-5 of the same formulas in
        f64 at zamba2's gates, 6e-7 at gentle ones)
  bf16  the same, plus 2^-7 · |ref| on dq, dk and dv: each side rounds
        its f32 gradient to bf16 once, so the two can lie one bf16 step
        apart. Where q and k are shared by the heads, each side rounds the
        H per-head gradients g_h to bf16 and then their sum over the
        heads, the reference possibly each partial sum: at most 2^-8 ·
        (H + 2) · Σ_h |g_h| apart (the f32 bound alone was exceeded 6-fold
        at 4 heads)
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import ssd_scan

jax.config.update("jax_enable_x64", False)

NAMES = ("dq", "dk", "dv", "da", "di", "dh0")
BF16_STEP = 2.0 ** -7

# (B, S, H, dk, dv, chunk, gates, dtype, per_head): the smoke config's SSD
# shape (8 heads, dk 16, dv 64, chunk 64) and smaller ones; one chunk;
# a chunk that is no multiple of 4; bf16; q and k of their own per head
CASES = [(2, 128, 8, 16, 64, 64, "gentle", "float32", False),
         (2, 128, 8, 16, 64, 64, "model", "float32", False),
         (2, 96, 3, 8, 12, 32, "gentle", "float32", True),
         (1, 64, 3, 8, 8, 64, "model", "float32", False),
         (1, 120, 2, 8, 8, 20, "gentle", "float32", False),
         (2, 128, 4, 16, 16, 64, "gentle", "bfloat16", False),
         (1, 128, 4, 16, 16, 64, "model", "bfloat16", True)]
IDS = ["-".join(map(str, c)) for c in CASES]


@pytest.fixture(scope="module")
def jref():
    from jax._src.interpreters import batching
    from jax._src.lax import lax as lax_internal
    proxy = batching.primitive_batchers
    batching.primitive_batchers = {lax_internal.optimization_barrier_p: None}
    try:
        import repro.models.sharding  # noqa: F401
    finally:
        batching.primitive_batchers = proxy
    from repro.models import ssm as jssm
    return types.SimpleNamespace(ssm=jssm)


def _bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16 values, kept as f32."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _inputs(B, S, H, dk, dv, gates, dtype, per_head, seed=0):
    """numpy operands, bf16-representable where ``dtype`` is bf16: q, k
    (B, S, Hq, dk) with Hq = H or 1, v and dy (B, S, H, dv), f32 gates a, i
    (B, S, H), the initial state and the final state's cotangent (B, H, dk,
    dv) f32."""
    rng = np.random.default_rng(seed + 1000 * S + 10 * H + dk)
    f = np.float32
    hq = H if per_head else 1
    x = {"q": rng.standard_normal((B, S, hq, dk)).astype(f),
         "k": rng.standard_normal((B, S, hq, dk)).astype(f),
         "v": rng.standard_normal((B, S, H, dv)).astype(f),
         "dy": rng.standard_normal((B, S, H, dv)).astype(f)}
    if dtype == "bfloat16":
        x = {n: _bf16(v) for n, v in x.items()}
    i = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(f)
    if gates == "model":
        a = (i * -np.linspace(1.0, 16.0, H)).astype(f)
    else:
        a = -(0.02 * rng.random((B, S, H))).astype(f)
    x.update(a=a, i=i, h0=rng.standard_normal((B, H, dk, dv)).astype(f),
             dh=rng.standard_normal((B, H, dk, dv)).astype(f))
    return x


def _jax_grads(jref, x, H, chunk, dtype):
    """jax.vjp of chunked_decay_attention (initial state in, final state
    out) at (dy, dh): the gradients of q, k (summed over the heads that
    share them), v, a, i and the initial state, as f32 numpy."""
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32

    def f(q, k, v, a, i, h0):
        shape = q.shape[:2] + (H, q.shape[-1])
        return jref.ssm.chunked_decay_attention(
            jnp.broadcast_to(q, shape), jnp.broadcast_to(k, shape), v, a, i,
            chunk=chunk, initial_state=h0, return_state=True)
    args = [jnp.asarray(x[n], jd) for n in ("q", "k", "v")] + \
        [jnp.asarray(x[n]) for n in ("a", "i", "h0")]
    (y, h), vjp = jax.vjp(f, *args)
    grads = vjp((jnp.asarray(x["dy"], y.dtype), jnp.asarray(x["dh"])))
    return [np.asarray(jnp.asarray(g, jnp.float32)) for g in grads]


def _worst(got, want, bf16_scale=None):
    """The largest |got - want| over its tolerance, per output name: > 1
    fails. ``bf16_scale`` maps the names rounded to bf16 to the magnitude
    a bf16 step is taken of."""
    out = {}
    bf16_scale = bf16_scale or {}
    for name, g, w in zip(NAMES, got, want):
        g = np.asarray(g, np.float32)
        tol = ssd_scan.BWD_ATOL_REL * np.abs(w).max() + \
            (BF16_STEP * bf16_scale[name] if name in bf16_scale else 0.0)
        out[name] = float((np.abs(g - w) / np.maximum(tol, 1e-30)).max())
    return out


def _torch(x, H, per_head, dtype, requires_grad=False):
    td = getattr(torch, dtype)
    t = {n: torch.from_numpy(v) for n, v in x.items()}
    for n in ("q", "k", "v", "dy"):
        t[n] = t[n].to(td)
    if requires_grad:
        for n in ("q", "k", "v", "a", "i", "h0"):
            t[n].requires_grad_(True)
    B, S, _, dk = t["q"].shape
    q, k = t["q"], t["k"]
    if not per_head:
        q, k = q.expand(B, S, H, dk), k.expand(B, S, H, dk)
    return t, q, k


@pytest.mark.parametrize("B,S,H,dk,dv,chunk,gates,dtype,per_head", CASES,
                         ids=IDS)
def test_plain_backward_matches_jax_vjp(jref, B, S, H, dk, dv, chunk, gates,
                                        dtype, per_head):
    """``ssd_scan_bwd_ref`` on the operands in f32 (bf16 values where the
    case is bf16) against the reference's f32 VJP; dq and dk are per head,
    summed here over the heads that share q and k."""
    x = _inputs(B, S, H, dk, dv, gates, dtype, per_head)
    want = _jax_grads(jref, x, H, chunk, "float32")
    t, q, k = _torch(x, H, per_head, "float32")
    got = list(ssd_scan.ssd_scan_bwd_ref(
        q, k, t["v"], t["a"], t["i"], t["dy"], t["dh"], chunk=chunk,
        initial_state=t["h0"]))
    assert [g.dtype for g in got] == [torch.float32] * 6
    assert got[0].shape == (B, S, H, dk) and got[5].shape == (B, H, dk, dv)
    if not per_head:
        got[0], got[1] = (g.sum(2, keepdim=True) for g in got[:2])
    worst = _worst([g.numpy() for g in got], want)
    assert max(worst.values()) <= 1, worst


@pytest.mark.parametrize("B,S,H,dk,dv,chunk,gates,dtype,per_head", CASES,
                         ids=IDS)
def test_autograd_function_matches_jax_vjp(jref, B, S, H, dk, dv, chunk,
                                           gates, dtype, per_head):
    """``ssd_scan`` under grad on CPU tensors in the case's dtype: it goes
    through ``_SSDScan`` (saved states, dtype casts, the expand backward,
    the initial and final states' gradients) and matches the reference's
    VJP in that dtype; no kernel launches."""
    x = _inputs(B, S, H, dk, dv, gates, dtype, per_head)
    want = _jax_grads(jref, x, H, chunk, dtype)
    t, q, k = _torch(x, H, per_head, dtype, requires_grad=True)
    launches = (ssd_scan.ssd_scan.launches, ssd_scan.ssd_scan.bwd_launches)
    y, h = ssd_scan.ssd_scan(q, k, t["v"], t["a"], t["i"], chunk=chunk,
                             initial_state=t["h0"])
    assert type(y.grad_fn).__name__ == "_SSDScanBackward"
    assert y.dtype == t["v"].dtype and h.dtype == torch.float32
    torch.autograd.backward([y, h], [t["dy"], t["dh"]])
    assert (ssd_scan.ssd_scan.launches,
            ssd_scan.ssd_scan.bwd_launches) == launches
    got = [t[n].grad for n in ("q", "k", "v", "a", "i", "h0")]
    assert [g.dtype for g in got[:3]] == [t["v"].dtype] * 3
    assert got[0].shape == t["q"].shape
    scale = {}
    if dtype == "bfloat16":
        plain = ssd_scan.ssd_scan_bwd_ref(
            q.detach().float(), k.detach().float(), t["v"].detach().float(),
            t["a"].detach(), t["i"].detach(), t["dy"], t["dh"], chunk=chunk,
            initial_state=t["h0"].detach())
        scale = {n: (g.abs() if per_head else
                     g.abs().sum(2, keepdim=True) * (H + 2) / 2).numpy()
                 for n, g in zip(("dq", "dk"), plain[:2])}
        scale["dv"] = np.abs(want[2])
    worst = _worst([g.float().numpy() for g in got], want, scale)
    assert max(worst.values()) <= 1, worst


@pytest.mark.parametrize("gates", ["gentle", "model"])
def test_plain_backward_matches_autograd_of_the_plain_forward(gates):
    """The hand-written backward against ``torch.autograd`` through
    ``ssd_scan_ref`` (f32, per-head q and k, an initial state)."""
    x = _inputs(2, 128, 3, 8, 12, gates, "float32", True, seed=5)
    t, q, k = _torch(x, 3, True, "float32", requires_grad=True)
    y, h = ssd_scan.ssd_scan_ref(q, k, t["v"], t["a"], t["i"], chunk=32,
                                 initial_state=t["h0"])
    want = torch.autograd.grad(
        (y * t["dy"]).sum() + (h * t["dh"]).sum(),
        [t[n] for n in ("q", "k", "v", "a", "i", "h0")])
    got = ssd_scan.ssd_scan_bwd_ref(
        *(t[n].detach() for n in ("q", "k", "v", "a", "i", "dy", "dh")),
        chunk=32, initial_state=t["h0"].detach())
    worst = _worst([g.numpy() for g in got], [w.numpy() for w in want])
    assert max(worst.values()) <= 1, worst


def test_saved_states_are_the_forward_states():
    """The states the plain forward hands the backward are the state before
    each chunk: the first is the initial state, and the scan from the last
    one over the last chunk gives the final state."""
    x = _inputs(1, 96, 2, 8, 8, "gentle", "float32", False, seed=2)
    t, q, k = _torch(x, 2, False, "float32")
    y, h, st = ssd_scan.ssd_scan_ref(q, k, t["v"], t["a"], t["i"], chunk=32,
                                     initial_state=t["h0"],
                                     return_states=True)
    assert st.shape == (1, 3, 2, 8, 8) and st.dtype == torch.float32
    assert torch.equal(st[:, 0], t["h0"])
    y2, h2 = ssd_scan.ssd_scan_ref(q[:, 64:], k[:, 64:], t["v"][:, 64:],
                                   t["a"][:, 64:], t["i"][:, 64:], chunk=32,
                                   initial_state=st[:, 2])
    torch.testing.assert_close(h2, h, rtol=0, atol=1e-5)
    torch.testing.assert_close(y2, y[:, 64:], rtol=0, atol=1e-5)
    again = ssd_scan.ssd_scan_bwd_ref(q, k, t["v"], t["a"], t["i"], t["dy"],
                                      t["dh"], chunk=32,
                                      initial_state=t["h0"])
    given = ssd_scan.ssd_scan_bwd_ref(q, k, t["v"], t["a"], t["i"], t["dy"],
                                      t["dh"], chunk=32,
                                      initial_state=t["h0"], states=st)
    assert all(torch.equal(a, b) for a, b in zip(again, given))


@pytest.mark.parametrize("gates", ["gentle", "model"])
def test_tolerance_rejects_planted_backward_faults(gates):
    """Each of ``BWD_FAULTS`` fails the card check (``bwd_margins`` above
    1) against the plain backward at the smoke shape over
    two chunks, while the plain backward passes against itself."""
    x = _inputs(2, 128, 8, 16, 64, gates, "float32", False, seed=3)
    t, q, k = _torch(x, 8, False, "float32")
    args = (q, k, t["v"], t["a"], t["i"], t["dy"], t["dh"])
    want = ssd_scan.ssd_scan_bwd_ref(*args, chunk=64, initial_state=t["h0"])
    assert max(ssd_scan.bwd_margins(want, want).values()) == 0
    for fault in ssd_scan.BWD_FAULTS:
        got = ssd_scan.ssd_scan_bwd_ref(*args, chunk=64,
                                        initial_state=t["h0"], fault=fault)
        assert max(ssd_scan.bwd_margins(got, want).values()) > 1, fault
    with pytest.raises(ValueError, match="unknown fault"):
        ssd_scan.ssd_scan_bwd_ref(*args, chunk=64, fault="nope")


@pytest.mark.parametrize("gates", ["model", "gentle"])
def test_two_part_split_stays_inside_the_backward_tolerance(gates):
    """The tensor-core backward kernel splits the operands that are f32 by
    nature (the gated scores P and R, the states H_n, their gradients dH
    and e^{cum_t} q_t) into two bf16 parts each for bf16 inputs. Emulated in
    the plain backward (``parts=2``) at a cut of zamba2's training shape
    (S 512, H 4, dk = dv = 64, chunk 128, bf16 operands, head-stride-0 q
    and k, an initial state and a final state's gradient), that stays
    inside ``ssd_scan.bwd_margins`` around the plain f32 backward, while
    one part (the fault ``bwd_one_part``, the low parts lost) falls
    outside it. Gates as the model draws them or gentle."""
    B, S, H, dk, dv, chunk = 2, 512, 4, 64, 64, 128
    rng = np.random.default_rng(11)
    f = np.float32

    def bf16(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(f)).to(
            torch.bfloat16).float()
    bc = bf16((B, S, 2 * dk))
    k = bc[..., :dk][:, :, None].expand(B, S, H, dk)
    q = bc[..., dk:][:, :, None].expand(B, S, H, dk)
    v, dy = bf16((B, S, H, dv)), bf16((B, S, H, dv))
    i = torch.nn.functional.softplus(
        torch.from_numpy(rng.standard_normal((B, S, H)).astype(f)))
    a = (i * -torch.linspace(1.0, 16.0, H) if gates == "model" else
         -0.02 * torch.from_numpy(rng.random((B, S, H)).astype(f)))
    h0 = torch.from_numpy(rng.standard_normal((B, H, dk, dv)).astype(f))
    dh = torch.from_numpy(rng.standard_normal((B, H, dk, dv)).astype(f))
    args = (q, k, v, a, i, dy, dh)
    want = ssd_scan.ssd_scan_bwd_ref(*args, chunk=chunk, initial_state=h0)
    two = ssd_scan.ssd_scan_bwd_ref(*args, chunk=chunk, initial_state=h0,
                                    parts=2)
    assert max(ssd_scan.bwd_margins(two, want).values()) <= 1
    one = ssd_scan.ssd_scan_bwd_ref(*args, chunk=chunk, initial_state=h0,
                                    fault="bwd_one_part")
    assert max(ssd_scan.bwd_margins(one, want).values()) > 1


@pytest.mark.parametrize("values", ["bf16", "f32"])
def test_wide_split_stays_inside_the_backward_tolerance(values):
    """The wide backward kernel (``csrc/ssd_scan_wide_bwd.cu``) splits the
    operands that are f32 by nature (P, R, the states H_n, their gradients
    and e^{cum_t} q_t) into ``WIDE_PARTS`` bf16 parts, and f32 q, k, v and
    dy into three, which hold them exactly. Emulated in the plain backward
    (``parts=WIDE_PARTS``) at one full-width head pair of xlstm-1.3b's
    training shape (S 512, H 2, dk 1024, dv 1025, chunk 256; mLSTM's gates
    with the input gate up to e^10; f32 dy; no initial state, no dh_final,
    as autograd calls it in training), with q, k and v bf16-valued (the
    model's) or full f32, that stays inside ``ssd_scan.bwd_margins`` around
    the plain f32 backward, one part (the fault ``bwd_one_part``) falls
    outside it, and ``parts=None`` is the plain backward bit for bit."""
    rng = np.random.default_rng(11)
    B, S, H, dk, Q = 1, 512, 2, 1024, 256
    dv = dk + 1
    f = np.float32

    def normal(shape, scale=1.0):
        x = torch.from_numpy((rng.standard_normal(shape) * scale).astype(f))
        return x.to(torch.bfloat16).float() if values == "bf16" else x
    q = normal((B, S, H, dk), dk ** -0.5)
    k = normal((B, S, H, dk), dk ** -0.5)
    v = normal((B, S, H, dv))
    v[..., -1] = 1.0
    a = torch.from_numpy((-np.logaddexp(
        0.0, -(3.0 + rng.standard_normal((B, S, H))))).astype(f))
    i = torch.from_numpy(np.exp(np.clip(
        4.0 * rng.standard_normal((B, S, H)), -10, 10)).astype(f))
    dy = torch.from_numpy(rng.standard_normal((B, S, H, dv)).astype(f))
    args = (q, k, v, a, i, dy)
    want = ssd_scan.ssd_scan_bwd_ref(*args, chunk=Q)
    two = ssd_scan.ssd_scan_bwd_ref(*args, chunk=Q,
                                    parts=ssd_scan.WIDE_PARTS)
    assert max(ssd_scan.bwd_margins(two, want).values()) <= 1
    one = ssd_scan.ssd_scan_bwd_ref(*args, chunk=Q, fault="bwd_one_part")
    assert max(ssd_scan.bwd_margins(one, want).values()) > 1
    again = ssd_scan.ssd_scan_bwd_ref(*args, chunk=Q, parts=None)
    assert all(torch.equal(x, y) for x, y in zip(again, want))


def test_no_gradient_wanted_takes_no_function():
    """Without grad (or with no input that requires it) ``ssd_scan``
    returns the plain forward's values with no graph, as the serve path
    needs."""
    x = _inputs(1, 64, 2, 8, 8, "gentle", "float32", False)
    t, q, k = _torch(x, 2, False, "float32", requires_grad=True)
    with torch.no_grad():
        y, h = ssd_scan.ssd_scan(q, k, t["v"], t["a"], t["i"], chunk=32)
    assert y.grad_fn is None and h.grad_fn is None
    want, _ = ssd_scan.ssd_scan_ref(q.detach(), k.detach(), t["v"].detach(),
                                    t["a"].detach(), t["i"].detach(),
                                    chunk=32)
    assert torch.equal(y, want)


def test_backward_bound_accounting():
    """``bwd_hbm_bytes`` and ``bwd_flops`` at zamba2's training shape (B 4,
    S 512, H 112, dk = dv = 64, chunk 128, bf16), term by term."""
    B, S, H, dk, dv, Q = 4, 512, 112, 64, 64, 128
    nb = ssd_scan.bwd_hbm_bytes(B, S, H, dk, dv, Q, 2)
    assert nb["qk"] == 2 * B * S * dk * 2
    assert nb["v_dy"] == 2 * B * S * H * dv * 2
    assert nb["gates"] == 2 * B * S * H * 4
    assert nb["states"] == (B * (S // Q) * H + 2 * B * H) * dk * dv * 4
    assert nb["grads"] == B * S * H * (2 * dk + dv) * 2 + 2 * B * S * H * 4
    assert nb["minimum"] == sum(v for n, v in nb.items() if n != "minimum")
    assert nb["minimum"] == 195_035_136
    pairs = Q * (Q + 1) // 2
    fl = ssd_scan.bwd_flops(B, S, H, dk, dv, Q)
    assert fl == 2 * B * H * (S // Q) * (pairs * (3 * dk + 2 * dv)
                                        + (4 * Q + 1) * dk * dv)
    assert fl == 16_999_514_112
    b = ssd_scan.bwd_bound(B, S, H, dk, dv, Q, 2, 3.35e12, 989e12, 67e12)
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(195_035_136 / 3.35e12 * 1e3)
    assert b["f32_core_bound_ms"] == pytest.approx(fl / 67e12 * 1e3)
    # xlstm-1.3b's training shape (B 4, S 512, H 4, dk 1024, dv 1025, chunk
    # 256, f32, q and k per head): everything, then as autograd calls the
    # wide backward in training (no initial state, no dh_final, no dh0:
    # H_0 dy, the last chunk's dH v and dHᵀ k, the first chunk's update and
    # both chunks' <H, dH> are products of known zeros or unread)
    B, S, H, dk, dv, Q = 4, 512, 4, 1024, 1025, 256
    assert ssd_scan.bwd_flops(B, S, H, dk, dv, Q) == 79_637_331_968
    state = Q * dk * dv
    cut = dict(initial_state=False, dh_final=False, dh0=False)
    fl = ssd_scan.bwd_flops(B, S, H, dk, dv, Q, **cut)
    assert fl == 45_176_864_768
    assert fl == 79_637_331_968 - 2 * B * H * (4 * state + 2 * dk * dv)
    # each skip alone, and the two zero dots of one chunk counted once
    assert ssd_scan.bwd_flops(B, S, H, dk, dv, Q, initial_state=False) == \
        79_637_331_968 - 2 * B * H * (state + dk * dv)
    assert ssd_scan.bwd_flops(B, S, H, dk, dv, Q, dh_final=False) == \
        79_637_331_968 - 2 * B * H * (2 * state + dk * dv)
    assert ssd_scan.bwd_flops(B, S, H, dk, dv, Q, dh0=False) == \
        79_637_331_968 - 2 * B * H * state
    assert ssd_scan.bwd_flops(B, Q, H, dk, dv, Q, initial_state=False,
                              dh_final=False) == \
        ssd_scan.bwd_flops(B, Q, H, dk, dv, Q) - 2 * B * H * (
            3 * state + dk * dv)
    # bytes: without an initial state the state before the first chunk is
    # not read, without dh0 nothing is written for it; the 48 states of a
    # call with both (and no dh_final) come down to the 16 before chunk 1
    one = dk * dv * 4
    full = ssd_scan.bwd_hbm_bytes(B, S, H, dk, dv, Q, 4, qk_per_head=True,
                                  dh_final=False)
    nb = ssd_scan.bwd_hbm_bytes(B, S, H, dk, dv, Q, 4, qk_per_head=True,
                                **cut)
    assert full["states"] == 3 * B * H * one
    assert nb["states"] == B * H * one
    assert full["minimum"] - nb["minimum"] == 2 * B * H * one
    assert nb["minimum"] == 302_284_800
    for flag in ("initial_state", "dh0"):
        assert ssd_scan.bwd_hbm_bytes(
            B, S, H, dk, dv, Q, 4, qk_per_head=True, dh_final=False,
            **{flag: False})["minimum"] == full["minimum"] - B * H * one
    b = ssd_scan.bwd_bound(B, S, H, dk, dv, Q, 4, 3.35e12, 989e12, 67e12,
                           qk_per_head=True, **cut)
    assert b["bound_by"] == "bytes"
    assert round(b["bound_ms"], 4) == 0.0902
    assert b["bound_ms"] == pytest.approx(302_284_800 / 3.35e12 * 1e3)
    assert round(b["f32_core_bound_ms"], 3) == 0.674
    assert b["f32_core_bound_ms"] == pytest.approx(fl / 67e12 * 1e3)
    # with an initial state and dh0 asked for (no dh_final), as before
    b = ssd_scan.bwd_bound(B, S, H, dk, dv, Q, 4, 3.35e12, 989e12, 67e12,
                           qk_per_head=True, dh_final=False)
    assert round(b["bound_ms"], 4) == 0.1303
