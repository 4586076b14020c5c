"""xLSTM federation on the port against the JAX package, on the CPU: the
sLSTM scan's hand-written VJP (``ssm._SLSTMScan``) against ``jax.vjp`` of
the reference's ``_slstm_scan``, xLSTM's causal-LM loss and gradients (with
and without rematerialisation of each super-layer), K4's backward getting
no gradient for a final state the loss does not use, the AdamW state of
its tree carried across by ``convert``, and ``repro_torch.launch.train --arch
xlstm-1.3b`` and ``federated_llm`` on the CPU. A 2 × 2 ``SDFLBProtocol``
over the smoke config in both packages is in
``tests/test_torch_xlstm_round.py``.

Config: xlstm-1.3b's smoke config (one super-layer of one mLSTM and one
sLSTM block; d 256, 4 heads, mLSTM heads of dh 128 with chunk 64, V 512,
bf16) over S = 128, two mLSTM chunks. Weights are the JAX init,
converted; tokens and the scan's inputs come from numpy. On the CPU the
mLSTM blocks run K4's plain forward and plain backward through
``ssd_scan``'s ``autograd.Function`` at mLSTM's heads (dk 128, dv 129).
The JAX package is imported through the ``jref`` fixture, the workaround
for fault F1 of the reference (ROADMAP.md, Queue 3; see
``tests/test_torch_llm.py``).

Tolerances, each against the reference's value (``tests/
test_torch_hybrid_train.py``'s for the loss and the gradients):

  sLSTM scan, f32  1e-5 · max|x| per output: the carries and hs after 64
                   steps (measured ≤ 3.0e-7), dR, db, d_pre and the initial
                   carry's gradients (measured ≤ 4.1e-7)
  f32 loss         2e-5 absolute   (measured ≤ 4.8e-7)
  f32 gradients    1e-4 · max|g|   per leaf (measured ≤ 5.5e-6, r_gates)
  bf16 loss        2e-3 absolute   (measured ≤ 5.5e-4)
  bf16 gradients   5e-2 · max|g| per leaf, against the reference's taken
                   block by block on the port's own bf16 trajectory
                   (measured ≤ 1.8e-2, six seeds), and so the gradient
                   each block hands back to its input (measured ≤ 1.65e-2);
                   each block's output
                   against the reference block's at the port's input within
                   2e-2 · max (≈ 5 bf16 steps at the largest value; measured
                   ≤ 1.33e-2), and the reference's head and loss at the
                   port's last hidden state within 2e-5 of the port's loss
                   (measured ≤ 9.5e-7). Not the whole-model bf16 gradient
                   of the reference, widened by its own bf16-vs-f32 gap as
                   in ``test_torch_hybrid_train.py``: the sLSTM's VJP moves
                   some 20 times what its input moves, and bf16 rounding
                   alone moves that input as far between the packages as
                   between bf16 and f32 (0.96 % and 0.82 % of its largest
                   value, seed 1). There the reference's own sLSTM block,
                   fed the port's bf16 input and cotangent, moves its
                   r_gates gradient by 0.236 of its largest value and lands
                   within 0.0085 of the port's, while the reference's own
                   bf16-vs-f32 gap there is 0.050
                   (``test_reference_slstm_gradient_moves_with_the_
                   rounding_of_its_input``).

"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.kernels import ssd_scan
from repro_torch.models import api, layers, ssm
from repro_torch.optim import optimizers

jax.config.update("jax_enable_x64", False)

ARCH, B, S = "xlstm-1.3b", 2, 128
SCAN_TOL = 1e-5
LOSS_TOL = {"float32": 2e-5, "bfloat16": 2e-3}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
BLOCK_OUT_TOL = 2e-2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: the sLSTM scan is a loop
    of small ops, and parallel test workers that each spin a pool of
    threads for them slow one another by two orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    from repro.configs.base import TrainConfig as JTrain
    from repro.configs.registry import get_smoke_config as jsmoke
    from repro.models import api as japi
    from repro.models import ssm as jssm
    from repro.models import xlstm as jxlstm
    from repro.optim import optimizers as jopt
    return types.SimpleNamespace(api=japi, ssm=jssm, xlstm=jxlstm, opt=jopt,
                                 smoke=jsmoke, Train=JTrain)


def _leaves(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


def _batch(cfg, seed):
    """Tokens and labels (B, S) int32, the last 5 labels of each row
    masked (-100)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = toks.copy()
    labels[:, -5:] = -100
    return toks, labels


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_slstm_scan_vjp_matches_reference(jref):
    """``_SLSTMScan`` (f32, d 256, 4 heads, batch 2, 64 steps from a
    nonzero carry) against ``jax.vjp`` of the reference's ``_slstm_scan``
    on the same inputs and cotangents: the final carry and hs forward, and
    dR, db, d_pre and the initial carry's (c, n, h) gradients; m has none
    (the reference returns zeros for it)."""
    H, d, Bs, Ss = 4, 256, 2, 64
    dh = d // H
    rng = np.random.default_rng(11)

    def f32(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)
    r = f32(H, dh, 4 * dh, scale=dh ** -0.5)
    b = f32(4 * d, scale=0.1)
    pre = f32(Bs, Ss, 4 * d)
    carry = (f32(Bs, d), np.abs(f32(Bs, d)) + 0.5, f32(Bs, d, scale=0.5),
             f32(Bs, H))
    d_carry = (f32(Bs, d), f32(Bs, d), f32(Bs, d), f32(Bs, H))
    d_hs = f32(Bs, Ss, d)

    (jcarry, jhs), vjp = jax.vjp(
        lambda r_, b_, p_, c_: jref.ssm._slstm_scan(r_, b_, p_, c_, H),
        jnp.asarray(r), jnp.asarray(b), jnp.asarray(pre.transpose(1, 0, 2)),
        tuple(jnp.asarray(x) for x in carry))
    jd_r, jd_b, jd_pre, jd_carry = vjp(
        (tuple(jnp.asarray(x) for x in d_carry),
         jnp.asarray(d_hs.transpose(1, 0, 2))))

    leaves = [torch.from_numpy(x).requires_grad_(True)
              for x in (r, b, pre, *carry[:3])]
    tr, tb, tpre, tc, tn, th = leaves
    *tcarry, ths = ssm._SLSTMScan.apply(tr, tb, tpre, H, tc, tn, th,
                                        torch.from_numpy(carry[3]))
    assert not tcarry[3].requires_grad
    for got, want in zip(tcarry + [ths],
                         list(jcarry) + [np.asarray(jhs).transpose(1, 0, 2)]):
        assert _rel(got.detach(), want) <= SCAN_TOL
    torch.autograd.backward(
        tcarry[:3] + [ths],
        [torch.from_numpy(x) for x in d_carry[:3]] + [torch.from_numpy(d_hs)])
    want = [jd_r, jd_b, np.asarray(jd_pre).transpose(1, 0, 2), *jd_carry[:3]]
    for name, x, w in zip(("dR", "db", "d_pre", "dc", "dn", "dh"), leaves,
                          want):
        assert x.grad.shape == tuple(np.shape(w)), name
        assert _rel(x.grad, w) <= SCAN_TOL, name
    assert not np.asarray(jd_carry[3]).any()


LOSS_CASES = [("float32", False, 1), ("float32", True, 4),
              ("bfloat16", True, 1), ("bfloat16", False, 3)]


def _port_grads_at_boundaries(cfg, params, batch, remat):
    """The port's loss and every leaf's gradient, with the residual stream
    where each block of ``xlstm_forward`` takes it (the input of each
    block's RMSNorm and of the final norm, in order) and its gradient."""
    pr = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    xs, dxs = [], {}
    orig = layers.rms_norm

    def spy(x, w, eps=1e-5):
        k = len(xs)
        xs.append(x)
        x.register_hook(lambda g: dxs.__setitem__(k, g))
        return orig(x, w, eps)
    # the forward only: remat's recomputation in backward is not recorded
    layers.rms_norm = spy
    try:
        loss, _ = api.lm_loss_fn(cfg, remat=remat)(pr, batch)
    finally:
        layers.rms_norm = orig
    g = dict(zip(pr, torch.autograd.grad(loss, list(pr.values()))))
    return loss.detach(), g, [x.detach() for x in xs], \
        [dxs[k] for k in range(len(xs))]


def _reference_blocks(jref, jcfg, labels):
    """The reference's blocks as ``xlstm_forward`` runs them, on the
    residual stream: ``m_block(lp, x)`` and ``s_block(sp, x)`` (``x +
    block(rms_norm(x))``), ``tail(final_norm, lm_head, x)`` (the final
    norm, the head and the loss), and ``m_vjp``, ``s_vjp``: a block's
    output at (p, x) and its VJP there given dy, (y, dp, dx), jitted."""
    from repro.models import layers as jL
    eps = jcfg.norm_eps

    def m_block(lp, x):
        return x + jref.ssm.apply_mlstm(lp["mlstm"], jL.rms_norm(
            x, lp["norm"], eps), jcfg.ssm, chunk=jcfg.ssm.chunk_size)

    def s_block(sp, x):
        return x + jref.ssm.apply_slstm(sp["slstm"], jL.rms_norm(
            x, sp["norm"], eps), jcfg.num_heads)

    def tail(fn, head, x):
        tg = jref.api._shifted_targets(jnp.asarray(labels), x.shape[1], 0)
        return jref.api._chunked_xent(jL.rms_norm(x, fn, eps), head, tg)

    def vjp_at(f):
        def g(p, x, dy):
            y, pull = jax.vjp(f, p, x)
            return (y, *pull(dy))
        return jax.jit(g)
    return types.SimpleNamespace(m_block=m_block, s_block=s_block,
                                 tail=tail, m_vjp=vjp_at(m_block),
                                 s_vjp=vjp_at(s_block))


def _reference_at_boundaries(jref, jcfg, jp, toks, labels, xs, dxs):
    """The reference's gradient of every leaf, block by block on the
    port's own trajectory: each block's VJP (``_reference_blocks``, and the
    embedding's gather) at the port's residual stream where the block
    takes it and the port's gradient where the block hands it on. Returns
    the reference's loss at the port's last hidden state, its gradients,
    each block's output beside the port's (relative gaps) and each block's
    input gradient beside the port's (relative gaps)."""
    n_m, n_super = jref.xlstm._split_layers(jcfg)
    j = lambda t: jnp.asarray(t.float().numpy()).astype(jcfg.dtype)  # noqa
    blk = _reference_blocks(jref, jcfg, labels)
    m_vjp, s_vjp, tail = blk.m_vjp, blk.s_vjp, blk.tail
    assert len(xs) == n_super * (n_m + 1) + 1
    m_g, s_g, outs, ins, b = [], [], [], [], 0
    for n in range(n_super):
        m_row = []
        for i in range(n_m):
            lp = jax.tree.map(lambda a: a[n, i], jp["super"]["m"])
            y, g, dx = m_vjp(lp, j(xs[b]), j(dxs[b + 1]))
            m_row.append(g)
            outs.append((y, xs[b + 1]))
            ins.append((dx, dxs[b]))
            b += 1
        m_g.append(jax.tree.map(lambda *a: jnp.stack(a), *m_row))
        sp = jax.tree.map(lambda a: a[n], jp["super"]["s"])
        y, g, dx = s_vjp(sp, j(xs[b]), j(dxs[b + 1]))
        s_g.append(g)
        outs.append((y, xs[b + 1]))
        ins.append((dx, dxs[b]))
        b += 1
    loss, (d_fn, d_head, dx) = jax.jit(jax.value_and_grad(
        tail, (0, 1, 2)))(jp["final_norm"], jp["lm_head"], j(xs[b]))
    ins.append((dx, dxs[b]))
    _, vjp = jax.vjp(lambda e: jnp.take(e, jnp.asarray(toks), axis=0),
                     jp["embed"])
    (d_embed,) = vjp(j(dxs[0]))
    grads = {"embed": d_embed, "final_norm": d_fn, "lm_head": d_head,
             "super": {"m": jax.tree.map(lambda *a: jnp.stack(a), *m_g),
                       "s": jax.tree.map(lambda *a: jnp.stack(a), *s_g)}}
    return float(loss), grads, \
        [_rel(x.float().numpy(), y) for y, x in outs], \
        [_rel(x.float().numpy(), y) for y, x in ins]


@pytest.mark.parametrize("dtype,remat,seed", LOSS_CASES,
                         ids=[f"{d}-{'remat' if r else 'plain'}"
                              for d, r, _ in LOSS_CASES])
def test_xlstm_loss_and_grads_match_reference(jref, dtype, remat, seed):
    """The loss against the reference's ``loss_fn`` on the same weights and
    batch. f32: every leaf's gradient against ``jax.value_and_grad`` of it.
    bf16: every leaf's gradient against the reference's taken block by
    block on the port's own trajectory (``_reference_at_boundaries``), and
    each block's output against the reference block's on the port's input.
    Not against the reference's whole-model bf16 gradient: bf16 rounding
    differs between the packages by as much as between bf16 and f32 (the
    sLSTM's input: 0.96 % of its largest value against the reference's
    own 0.82 %, seed 1), and the sLSTM's VJP moves some 20-fold what its
    input moves (the test below)."""
    jcfg = jref.smoke(ARCH).replace(dtype=dtype)
    cfg = get_smoke_config(ARCH).replace(dtype=dtype)
    jp, _ = jref.api.init(jcfg, jax.random.PRNGKey(seed), tp=1)
    p = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    toks, labels = _batch(cfg, S + seed)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    if dtype == "float32":
        (jl, _), jg = jax.jit(jax.value_and_grad(
            jref.api.loss_fn(jcfg, remat=remat), has_aux=True))(jp, jb)
        pr = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        loss, m = api.lm_loss_fn(cfg, remat=remat)(pr, batch)
        g = dict(zip(pr, torch.autograd.grad(loss, list(pr.values()))))
        loss = loss.detach()
        assert float(m["aux"]) == 0.0
    else:
        jl, _ = jax.jit(jref.api.loss_fn(jcfg, remat=remat))(jp, jb)
        loss, g, xs, dxs = _port_grads_at_boundaries(cfg, p, batch, remat)
        tail_loss, jg, out_err, in_grad_err = _reference_at_boundaries(
            jref, jcfg, jp, toks, labels, xs, dxs)
        assert max(out_err) <= BLOCK_OUT_TOL
        assert max(in_grad_err) <= GRAD_TOL[dtype]
        assert abs(float(loss) - tail_loss) <= LOSS_TOL["float32"]
    assert loss.dtype == torch.float32
    assert abs(float(loss) - float(jl)) <= LOSS_TOL[dtype]
    got = convert.params_to_jax(g)
    assert jax.tree.structure(got) == jax.tree.structure(
        jax.tree.map(np.asarray, jg))
    for a, b in zip(_leaves(got), _leaves(jg)):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= GRAD_TOL[dtype] * np.abs(b).max()


def _slstm_sensitivity(jref, seed):
    """bf16 at the smoke config: the sLSTM block's input on the port's
    trajectory and on the reference's own bf16 and f32 ones, and the
    reference sLSTM block's r_gates gradient at each (given the cotangent
    of the same trajectory), beside the port's. Returns the relative gaps:
    (port's input vs the reference's, the reference's bf16 input vs its
    f32 one, the reference's gradient at the port's input vs at its own,
    the reference's own bf16-vs-f32 gap, the port vs the reference at the
    port's input)."""
    jcfg = jref.smoke(ARCH).replace(dtype="bfloat16")
    cfg = get_smoke_config(ARCH).replace(dtype="bfloat16")
    jp, _ = jref.api.init(jcfg, jax.random.PRNGKey(seed), tp=1)
    toks, labels = _batch(cfg, S + seed)
    blk = _reference_blocks(jref, jcfg, labels)

    @jax.jit
    def own(params):
        """The reference's own sLSTM input and output cotangent, and its
        r_gates gradient there."""
        lp = jax.tree.map(lambda a: a[0, 0], params["super"]["m"])
        sp = jax.tree.map(lambda a: a[0], params["super"]["s"])
        x1 = blk.m_block(lp, jnp.take(params["embed"], jnp.asarray(toks),
                                      axis=0))
        x2 = blk.s_block(sp, x1)
        dx2 = jax.grad(blk.tail, 2)(params["final_norm"],
                                    params["lm_head"], x2)
        return x1, dx2, jax.vjp(lambda s_: blk.s_block(s_, x1), sp)[1](
            dx2)[0]["slstm"]["r_gates"]
    x1, _, g_own = own(jp)
    x1_32, _, g_32 = own(jax.tree.map(lambda a: a.astype(jnp.float32), jp))
    p = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    _, g, xs, dxs = _port_grads_at_boundaries(cfg, p, batch, False)
    j = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)  # noqa
    sp = jax.tree.map(lambda a: a[0], jp["super"]["s"])
    g_at_port = blk.s_vjp(sp, j(xs[1]), j(dxs[2]))[1]["slstm"]["r_gates"]
    return (_rel(xs[1].float().numpy(), x1), _rel(x1, x1_32),
            _rel(g_at_port, g_own), _rel(g_own, g_32),
            _rel(g["super.s.slstm.r_gates"][0].float().numpy(), g_at_port))


def test_reference_slstm_gradient_moves_with_the_rounding_of_its_input(
        jref):
    """Why the bf16 gradients are held block by block (seed 1, the bf16
    remat case's): the port's bf16 input to the sLSTM block differs from
    the reference's own by about what bf16 moves it against f32 (0.96 % and
    0.82 % of its largest value), and that alone moves the reference's
    r_gates gradient by 0.236 of its largest value, past 5e-2 plus the
    reference's own bf16-vs-f32 gap there (0.050): a check widened by that
    gap fails the reference fed the port's input. The port's gradient lies
    within 0.0085 of the reference's at the port's input."""
    in_port, in_own, moved, own_gap, port_err = _slstm_sensitivity(jref, 1)
    assert in_port <= 2 * in_own
    assert moved > GRAD_TOL["bfloat16"] + own_gap
    assert port_err <= GRAD_TOL["bfloat16"]


def test_remat_runs_k4_again_for_its_saved_states():
    """With ``remat`` the super-layer's forward (K4's plain version at
    mLSTM's heads on the CPU, states kept for the backward, and the sLSTM
    scan) runs twice: in the forward and again when backward recomputes it;
    without, once. The gradients agree."""
    cfg = get_smoke_config(ARCH).replace(dtype="float32")
    p = api.init(cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
    toks, labels = _batch(cfg, 7)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    calls, scans = [], []
    orig, orig_scan = ssd_scan.ssd_scan_ref, ssm._SLSTMScan.forward

    def spy(*a, **kw):
        calls.append(kw.get("return_states", False))
        return orig(*a, **kw)

    def spy_scan(*a):
        scans.append(1)
        return orig_scan(*a)
    grads = {}
    ssd_scan.ssd_scan_ref = spy
    ssm._SLSTMScan.forward = staticmethod(spy_scan)
    try:
        for remat in (False, True):
            calls.clear()
            scans.clear()
            pr = {k: v.detach().requires_grad_(True) for k, v in p.items()}
            loss, _ = api.lm_loss_fn(cfg, remat=remat)(pr, batch)
            grads[remat] = torch.autograd.grad(loss, list(pr.values()))
            n = 2 if remat else 1
            assert calls == [True] * n and len(scans) == n
    finally:
        ssd_scan.ssd_scan_ref = orig
        ssm._SLSTMScan.forward = staticmethod(orig_scan)
    for a, b in zip(grads[False], grads[True]):
        assert (a - b).abs().max() <= 1e-5 * a.abs().max()


@pytest.mark.parametrize("use_state", [False, True],
                         ids=["state_unused", "state_used"])
def test_unused_final_state_reaches_the_backward_as_none(use_state):
    """Under autograd K4's backward gets no gradient for a final state the
    loss does not use (no zeros of (B, H, dk, dv) are made and read), and
    the gradient where the loss uses it; the input gradients are the plain
    backward's either way."""
    rng = np.random.default_rng(0)
    Bs, Ss, H, dk, dv, Q = 1, 128, 2, 8, 9, 64
    t = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
         .requires_grad_(True)
         for shape in ((Bs, Ss, H, dk), (Bs, Ss, H, dk), (Bs, Ss, H, dv))]
    a = torch.from_numpy(-np.abs(rng.standard_normal((Bs, Ss, H)))
                         .astype(np.float32))
    i = torch.from_numpy(rng.random((Bs, Ss, H)).astype(np.float32))
    seen = []
    orig = ssd_scan.ssd_scan_bwd

    def spy(*args, **kw):
        seen.append(args[6])
        return orig(*args, **kw)
    ssd_scan.ssd_scan_bwd = spy
    try:
        y, h = ssd_scan.ssd_scan(*t, a, i, chunk=Q)
        loss = y.square().sum() + (h.sum() if use_state else 0.0)
        got = torch.autograd.grad(loss, t)
    finally:
        ssd_scan.ssd_scan_bwd = orig
    assert len(seen) == 1 and (seen[0] is not None) == use_state
    dh = torch.ones((Bs, H, dk, dv)) if use_state else None
    want = ssd_scan.ssd_scan_bwd_ref(*(x.detach() for x in t), a, i,
                                     2 * y.detach(), dh, chunk=Q)
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= 1e-5 * w.abs().max()


def test_convert_carries_the_xlstm_adamw_state(jref):
    """xLSTM's worker-stacked AdamW state (m, v over the super-layers'
    stacked leaves, count) goes across and back leaf for leaf, and one more
    step on it matches the reference's."""
    jcfg = jref.smoke(ARCH).replace(dtype="float32")
    jp, _ = jref.api.init(jcfg, jax.random.PRNGKey(2), tp=1)
    jtc = jref.Train(optimizer="adamw", lr=3e-4, grad_clip=1.0)
    tc = TrainConfig(optimizer="adamw", lr=3e-4, grad_clip=1.0)
    rng = np.random.default_rng(0)
    jpw = jax.tree.map(lambda x: jnp.stack([x, x + 0.01]), jp)
    g1, g2 = (jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(
        x.shape), jnp.float32), jpw) for _ in range(2))
    jstate = jax.tree.map(lambda x: jnp.broadcast_to(x, (2,) + x.shape),
                          jref.opt.adamw_init(jp))
    update = jax.jit(lambda p_, g_, s_: jref.opt.adamw_update(p_, g_, s_,
                                                               jtc))
    jp1, jstate1 = update(jpw, g1, jstate)
    jp2, jstate2 = update(jp1, g2, jstate1)

    state = convert.opt_state_from_jax(jax.tree.map(np.asarray, jstate1))
    assert state["m"]["super.m.mlstm.w_up"].shape[:3] == (2, 1, 1)
    assert state["v"]["super.s.slstm.r_gates"].shape[:2] == (2, 1)
    back = convert.opt_state_to_jax(state)
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, jstate1))
    for a, b in zip(_leaves(back), _leaves(jstate1)):
        np.testing.assert_array_equal(a, b)
    p1 = convert.params_from_jax(jax.tree.map(np.asarray, jp1))
    p2, state2 = optimizers.adamw_update(
        p1, convert.params_from_jax(jax.tree.map(np.asarray, g2)), state, tc)
    got = convert.opt_state_to_jax(state2)
    for name, a, b in [("params", convert.params_to_jax(p2), jp2),
                       ("m", got["m"], jstate2["m"]),
                       ("v", got["v"], jstate2["v"])]:
        for x, y in zip(_leaves(a), _leaves(b)):
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-6, err_msg=name)


def test_train_launcher_runs_xlstm_on_the_cpu(capsys):
    """``python -m repro_torch.launch.train --arch xlstm-1.3b --device cpu
    --rounds 2``: its JSON lines, a verified ledger, value conserved;
    ``--async`` runs the arrival scheduler's cohorts."""
    from repro_torch.launch import train
    assert ARCH in train.TRAIN_ARCHS
    for extra in ([], ["--async"]):
        out = train.main(["--arch", ARCH, "--rounds", "2", "--device", "cpu",
                          "--workers", "4", "--batch", "2", *extra])
        proto = out["proto"]
        assert [e["round"] for e in out["log"]] == [1, 2]
        assert all(np.isfinite(e["loss"]) and e["aux"] == 0.0
                   for e in out["log"])
        assert len(proto.history) == 2 and proto.cfg.family == "ssm"
        assert proto.ledger.verify_chain(deep=True)
        assert len(out["payouts"]) == 4
        if extra:
            assert all(r.participation is not None for r in proto.history)
    lines = capsys.readouterr().out.splitlines()
    assert sum(ln.startswith("ledger: 4 blocks, verified=True")
               for ln in lines) == 2


def test_federated_llm_example_runs_xlstm(capsys):
    from repro_torch.examples import federated_llm
    assert ARCH in federated_llm.LLM_ARCHS
    out = federated_llm.main(arch=ARCH, rounds=2, device="cpu")
    assert out["verified"] and out["blocks"] == 4
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("round 1: mean_loss=")
    assert lines[-1] == "ledger verified: True"
