"""The port's RWKV-6 recurrence gradient (K4b's plain version, the autograd
Function ``ops.WKV6`` and the model's ``rwkv6_block``) against the JAX
reference.

The same seeded numpy inputs and cotangents go through ``jax.vjp`` of the
reference's definition (``repro.kernels.ref.wkv6``, outputs and final
state) and the port's plain ``ref.wkv6_bwd``, at rtol 1e-5 and atol 1e-5 x
the largest gradient compared (f32 sums over N and S taken in another
order); ``jax.grad`` of the reference's ``rwkv6_block`` (its checkpointed
chunked scan, padded with decay 1) against ``torch.autograd`` through the
port's, at 1e-4 (the training parity of ``tests/test_torch_train.py``).
The CUDA kernel runs only on the card (``chip_smoke.py`` ``[K4b]``); here
``_k4b_emulation`` transcribes its order of arithmetic into plain PyTorch
(checkpoints every 64 steps and sub-checkpoints every 8, the chunk's states
recomputed, each thread's FMA chains over 8 columns, the column segments'
partials added in order, dv's shuffle tree over a warp's 32 rows and the
row groups in order, the warp sums of v.do and the bonus) and is held to
the plain version at S values that cross segment boundaries and that the
chunk does not divide;
the wrapper's ``prepare`` (paths, copies, padding) is fed to the plain
version, and the wrapper is held to its refusals.
"""

import pytest

torch = pytest.importorskip("torch")

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.registry import get_config as jget_config
from repro.kernels import ref as jref
from repro.models import rwkv as jrwkv
from repro.models.layers import Ctx as JCtx
from repro.models.params import init_params as jinit_params
from repro.parallel.sharding import TRAIN_RULES
from repro_torch.configs.registry import get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels import wkv6_bwd as bwd_module
from repro_torch.kernels.flash_attention import tma_addressable
from repro_torch.kernels.wkv6_bwd import PATHS, prepare, wkv6_bwd
from repro_torch.models import rwkv as trwkv
from repro_torch.models.layers import Ctx
from repro_torch.models.params import params_from_numpy

CPU = torch.device("cpu")
NAMES = ("dr", "dk", "dv", "dw", "du")


def _t(x):
    return params_from_numpy(x, CPU)


def _decays(kind, shape, rng):
    """w in (0, 1): sigmoid of a normal, or the model's exp(-exp(x)) pushed
    near 0 (down to ~1e-30 and below) or near 1 (within ~1e-3 of it), as
    ``tests/test_torch_wkv6.py`` draws them."""
    x = rng.standard_normal(shape)
    if kind == "sigmoid":
        return (1.0 / (1.0 + np.exp(-x))).astype(np.float32)
    return np.exp(-np.exp(x + (2.0 if kind == "near0" else -8.0))).astype(np.float32)


def _case(B, H, S, N, decay, seed, with_dstate=True):
    """r, k, v, u, do, dstate normal (u at 0.5), w by ``decay``: numpy f32."""
    rng = np.random.default_rng(seed)
    r, k, v, do = (rng.standard_normal((B, H, S, N)).astype(np.float32) for _ in range(4))
    w = _decays(decay, (B, H, S, N), rng)
    u = (0.5 * rng.standard_normal((H, N))).astype(np.float32)
    dstate = rng.standard_normal((B, H, N, N)).astype(np.float32) if with_dstate else None
    return r, k, v, w, u, do, dstate


def _close(got, want, names=NAMES, tol=1e-5):
    """Each gradient at rtol ``tol`` and atol ``tol`` x its largest value."""
    for name, g, w in zip(names, got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, name
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol * scale, err_msg=name)


def _jax_vjp(r, k, v, w, u, do, dstate):
    args = tuple(map(jnp.asarray, (r, k, v, w, u)))
    _, pull = jax.vjp(jref.wkv6, *args)
    ds = jnp.zeros((r.shape[0], r.shape[1], r.shape[3], r.shape[3]), jnp.float32) \
        if dstate is None else jnp.asarray(dstate)
    return [np.asarray(g) for g in pull((jnp.asarray(do), ds))]


@pytest.mark.parametrize("decay", ["sigmoid", "near0", "near1"])
@pytest.mark.parametrize("S", [16, 33, 257])
@pytest.mark.parametrize("N", [8, 16, 32, 64])
def test_plain_backward_matches_jax_vjp(N, S, decay):
    """``ref.wkv6_bwd`` against ``jax.vjp`` of the reference's recurrence,
    with cotangents for the outputs and the final state."""
    case = _case(1, 2, S, N, decay, seed=N * 1000 + S)
    got = ref.wkv6_bwd(*map(_t, case))
    _close([g.numpy() for g in got], _jax_vjp(*case))


@pytest.mark.parametrize("with_dstate", [True, False])
@pytest.mark.parametrize("N", [8, 32])
def test_plain_backward_matches_torch_autograd(N, with_dstate):
    """``ref.wkv6_bwd`` against ``torch.autograd`` through ``ref.wkv6``."""
    case = _case(2, 3, 21, N, "sigmoid", seed=N, with_dstate=with_dstate)
    r, k, v, w, u, do, dstate = map(lambda x: None if x is None else _t(x), case)
    leaves = [t.clone().requires_grad_() for t in (r, k, v, w, u)]
    o, state = ref.wkv6(*leaves)
    loss = (o * do).sum() + (0 if dstate is None else (state * dstate).sum())
    want = torch.autograd.grad(loss, leaves)
    got = ref.wkv6_bwd(r, k, v, w, u, do, dstate)
    _close([g.numpy() for g in got], [g.numpy() for g in want])


# ---------------------------------------------------------------------------
# K4b's order of arithmetic
# ---------------------------------------------------------------------------

def _fma(a, b, c):
    """f32 fused multiply-add: the f32 product is exact in float64."""
    return (a.double() * b.double() + c.double()).float()


def _halve(x, dim):
    """Sum over ``dim`` as a shuffle tree does: the lane with bit M adds its
    partner's value, M from half the lanes down to 1."""
    x = x.movedim(dim, -1)
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def _lane_dot(x, y):
    """A warp's sum over N of x y: lane l takes j = l + 32 m by FMAs in m
    from 0, then the shuffle tree over the lanes (lane 0's sum)."""
    x32 = x.reshape(*x.shape[:-1], -1, 32)
    y32 = y.reshape(*y.shape[:-1], -1, 32)
    acc = torch.zeros_like(x32[..., 0, :])
    for m in range(x32.shape[-2]):
        acc = _fma(x32[..., m, :], y32[..., m, :], acc)
    return _halve(acc, dim=-1)


def _segment_dot(a, b, C):
    """Per row, per segment of C columns: an FMA chain over the segment's
    columns in order from 0 -> (..., N rows, N / C segments)."""
    *lead, n_rows, n_cols = a.shape
    a = a.reshape(*lead, n_rows, n_cols // C, C)
    b = b.expand(*lead, n_rows, n_cols).reshape(*lead, n_rows, n_cols // C, C)
    acc = torch.zeros(a.shape[:-1])
    for e in range(C):
        acc = _fma(a[..., e], b[..., e], acc)
    return acc


def _in_order(parts, dim):
    """Partials added one after the other from 0, in index order."""
    total = torch.zeros_like(parts.select(dim, 0))
    for p in range(parts.shape[dim]):
        total = total + parts.select(dim, p)
    return total


def _k4b_emulation(r, k, v, w, u, do, dstate=None, T=8, SEG=64, C=8):
    """A plain-PyTorch transcription of ``csrc/wkv6_bwd.cu``, in its order
    of f32 arithmetic (float32 CPU tensors in, (dr, dk, dv, dw, du) out).

    Two levels of checkpoints: pass 1 re-runs the forward from 0, S_ij =
    fma(w_i, S_ij, k_i v_j), and keeps the state before every segment of SEG
    steps; pass 2 walks the segments in reverse, re-runs each forward from
    its checkpoint keeping the state before every chunk of T steps, and
    walks its chunks in reverse, the chunk's states recomputed from its
    sub-checkpoint (the same FMAs, so the same bits on every level).  The
    per-step sums v.do and sum_i r_i u_i k_i: lane j mod 32 by FMAs, then
    the shuffle tree.  Then backwards over the chunk, per row i and segment
    of C columns, FMA chains for dr (S do), dk (G v) and dw (S G), the
    segments' partials added in order; per column, the products G_ij k_i
    summed over each warp's 32 rows by a shuffle tree and the row groups
    added in order; G_ij = fma(w_i, G_ij, r_i do_j).  dr = fma(u_i k_i,
    v.do, .), dk = fma(u_i r_i, v.do, .), dv = fma(do_j, bonus, .).  du: an
    FMA chain of r_i k_i and v.do over t in reverse per (b, h), then the
    (b, h) partials added over b in order."""
    B, H, S, N = r.shape
    nseg = -(-S // SEG)

    def fwd(state, t):
        return _fma(w[:, :, t, :, None], state, k[:, :, t, :, None] * v[:, :, t, None, :])

    state = torch.zeros((B, H, N, N))
    ckpts = [state]
    for t in range((nseg - 1) * SEG):
        state = fwd(state, t)
        if (t + 1) % SEG == 0:
            ckpts.append(state)

    g = torch.zeros((B, H, N, N)) if dstate is None else dstate.clone()
    grads = [torch.empty((B, H, S, N)) for _ in range(4)]
    dr, dk, dv, dw = grads
    du_acc = torch.zeros((B, H, N))
    for s in reversed(range(nseg)):
        t_seg = s * SEG
        nch = -(-min(SEG, S - t_seg) // T)
        subs = [ckpts[s]]
        for c in range(nch - 1):
            st = subs[-1]
            for t in range(t_seg + c * T, t_seg + c * T + T):
                st = fwd(st, t)
            subs.append(st)
        for c in reversed(range(nch)):
            t0 = t_seg + c * T
            nt = min(T, S - t0)
            hist = [subs[c]]
            for d in range(1, nt):
                hist.append(fwd(hist[-1], t0 + d - 1))
            for d in reversed(range(nt)):
                t = t0 + d
                rt, kt, vt, wt, dot = (x[:, :, t] for x in (r, k, v, w, do))
                vdo = _lane_dot(vt, dot)[..., None]
                bonus = _lane_dot(rt, u * kt)[..., None]
                pr = _in_order(_segment_dot(hist[d], dot[:, :, None, :], C), -1)
                pk = _in_order(_segment_dot(g, vt[:, :, None, :], C), -1)
                pw = _in_order(_segment_dot(hist[d], g, C), -1)
                groups = (g * kt[..., :, None]).reshape(B, H, N // 32, 32, N)
                dr[:, :, t] = _fma(u * kt, vdo, pr)
                dk[:, :, t] = _fma(u * rt, vdo, pk)
                dw[:, :, t] = pw
                dv[:, :, t] = _fma(dot, bonus, _in_order(_halve(groups, 3), 2))
                du_acc = _fma(rt * kt, vdo, du_acc)
                g = _fma(wt[..., :, None], g, rt[..., :, None] * dot[..., None, :])
    return dr, dk, dv, dw, _in_order(du_acc, 0)


@pytest.mark.parametrize("with_dstate", [True, False])
@pytest.mark.parametrize("decay", ["sigmoid", "near0", "near1"])
@pytest.mark.parametrize("S", [33, 65, 130, 257])
@pytest.mark.parametrize("N", [32, 64])
def test_kernel_order_matches_plain_and_jax(N, S, decay, with_dstate):
    """K4b's two-level checkpoints (segments of 64 steps, chunks of 8: S =
    33 leaves a ragged chunk in one segment, 65 and 130 one step or two
    past a segment boundary, 257 a ragged last segment) and fixed-order
    sums hold the plain version and ``jax.vjp`` at rtol 1e-5 and atol 1e-5
    x max |grad|."""
    case = _case(2, 2, S, N, decay, seed=N + S, with_dstate=with_dstate)
    ts = [None if x is None else _t(x) for x in case]
    got = [g.numpy() for g in _k4b_emulation(*ts)]
    _close(got, [g.numpy() for g in ref.wkv6_bwd(*ts)])
    _close(got, _jax_vjp(*case))


def test_kernel_order_at_one_step_without_a_state_gradient():
    """S = 1 and no final-state gradient: G is 0 and S_{-1} is 0, so dw is 0
    exactly and dr is fma(u k, v.do, 0), the f32 product."""
    case = _case(1, 2, 1, 32, "sigmoid", seed=3, with_dstate=False)
    ts = [None if x is None else _t(x) for x in case]
    dr, dk, dv, dw, du = _k4b_emulation(*ts)
    assert not dw.any()
    r, k, v, w, u, do, _ = ts
    vdo = _lane_dot(v[:, :, 0], do[:, :, 0])[..., None]
    assert torch.equal(dr[:, :, 0], (u * k[:, :, 0] * vdo))


# ---------------------------------------------------------------------------
# the autograd Function and the model's mixer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_dstate", [True, False])
def test_function_on_cpu_tensors_gives_the_plain_gradients(with_dstate):
    """Gradients through ``ops.WKV6`` equal ``ref.wkv6_bwd``'s bit for bit;
    a final state whose gradient is ``None`` is a zero one."""
    case = _case(2, 3, 19, 16, "sigmoid", seed=11)
    r, k, v, w, u, do, dstate = map(_t, case)
    leaves = [t.clone().requires_grad_() for t in (r, k, v, w, u)]
    o, state = ops.wkv6(*leaves)
    assert type(o.grad_fn).__name__ == "WKV6Backward"
    loss = (o * do).sum() + ((state * dstate).sum() if with_dstate else 0)
    got = torch.autograd.grad(loss, leaves)
    want = ref.wkv6_bwd(r, k, v, w, u, do,
                        dstate if with_dstate else torch.zeros_like(dstate))
    for g, wnt in zip(got, want):
        assert torch.equal(g, wnt)
    if not with_dstate:
        for g, wnt in zip(got, ref.wkv6_bwd(r, k, v, w, u, do)):
            assert torch.equal(g, wnt)


def test_function_with_only_the_state_used():
    """Only the final state reaches the loss: the outputs' gradient is
    ``None`` and taken as 0."""
    r, k, v, w, u, do, dstate = map(_t, _case(1, 2, 9, 8, "sigmoid", seed=4))
    leaves = [t.clone().requires_grad_() for t in (r, k, v, w, u)]
    _, state = ops.wkv6(*leaves)
    got = torch.autograd.grad((state * dstate).sum(), leaves)
    want = ref.wkv6_bwd(r, k, v, w, u, torch.zeros_like(do), dstate)
    for g, wnt in zip(got, want):
        assert torch.equal(g, wnt)


def test_dispatch_takes_the_function_only_under_grad():
    """``ops.wkv6`` goes through :class:`ops.WKV6` when grad is enabled and
    an input requires it; otherwise it is the serving call."""
    x = torch.rand(1, 2, 5, 8, generator=torch.Generator().manual_seed(0))
    u = torch.zeros(2, 8)
    assert ops.wkv6(x, x, x, x, u)[0].grad_fn is None
    xg = x.clone().requires_grad_()
    with torch.no_grad():
        assert ops.wkv6(xg, x, x, x, u)[0].grad_fn is None
    o, state = ops.wkv6(xg, x, x, x, u)
    assert type(o.grad_fn).__name__ == "WKV6Backward"
    want_o, want_state = ref.wkv6(x, x, x, x, u)
    assert torch.equal(o, want_o) and torch.equal(state, want_state)


def _mixer_pair(S, seed):
    """The reference's and the port's reduced rwkv6 config (f32), the
    reference's parameters with the zero-init anchors and bonus drawn
    (0.3 normal) so the token shift and u carry gradients, and an input."""
    jcfg = dataclasses.replace(jget_config("rwkv6_3b").smoke(), activation_dtype="float32")
    tcfg = dataclasses.replace(get_config("rwkv6_3b").smoke(), activation_dtype="float32")
    jp = jinit_params(jrwkv.rwkv_params(jcfg), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    jp = dict(jp, **{name: jnp.asarray(rng.standard_normal(jp[name].shape) * 0.3, jnp.float32)
                     for name in ("mu_x", "mu", "w0", "u")})
    x = (rng.standard_normal((2, S, jcfg.d_model)) * 0.5).astype(np.float32)
    cot = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, x, cot


@pytest.mark.parametrize("S", [32, 33])
def test_rwkv6_block_parameter_gradients_match_reference(S):
    """``jax.grad`` through the reference's ``rwkv6_block`` (its
    checkpointed chunked scan, S = 33 padded to 64 with decay 1) against
    ``torch.autograd`` through the port's (one K4 call, ``ops.WKV6``): every
    parameter's gradient and the input's at 1e-4."""
    jcfg, tcfg, jp, x, cot = _mixer_pair(S, seed=S)
    jctx = JCtx(rules=TRAIN_RULES, dtype=jnp.float32)

    def loss(p, xx):
        out, _ = jrwkv.rwkv6_block(p, xx, jcfg, jctx)
        return (out * jnp.asarray(cot)).sum()

    jg, jgx = jax.grad(loss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {name: t.requires_grad_() for name, t in
          params_from_numpy(jax.tree.map(np.asarray, jp), CPU).items()}
    tx = _t(x).requires_grad_()
    out, _ = trwkv.rwkv6_block(tp, tx, tcfg, Ctx(dtype=torch.float32))
    names = sorted(tp)
    got = torch.autograd.grad((out * _t(cot)).sum(), [tp[n] for n in names] + [tx])
    for name, g in zip(names + ["x"], got):
        want = np.asarray(jgx if name == "x" else jg[name])
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4, atol=1e-4, err_msg=name)
    assert float(np.abs(np.asarray(jg["u"])).max()) > 0  # the bonus is trained


def test_remat_runs_the_mixer_forward_twice_and_its_backward_once_per_layer(monkeypatch):
    """Under remat (the non-reentrant checkpoint of each unit) a training
    step's loss and backward run ``WKV6``'s forward twice a layer (the
    forward and the recompute) and its backward once: on the card, K4
    twice and K4b once a layer."""
    from repro_torch.launch import steps as tsteps
    from repro_torch.models import transformer as tT
    from repro_torch.models.params import init_params, tree_leaves

    calls = {"forward": 0, "backward": 0}
    fwd, bwd = ops.WKV6.forward, ops.WKV6.backward

    def count_fwd(ctx, *a):
        calls["forward"] += 1
        return fwd(ctx, *a)

    def count_bwd(ctx, *a):
        calls["backward"] += 1
        return bwd(ctx, *a)

    monkeypatch.setattr(ops.WKV6, "forward", staticmethod(count_fwd))
    monkeypatch.setattr(ops.WKV6, "backward", staticmethod(count_bwd))
    cfg = dataclasses.replace(get_config("rwkv6_3b").smoke(), n_layers=3,
                              activation_dtype="float32")
    _, p_specs, _, _ = tsteps.make_train_step(cfg, None)
    params = init_params(p_specs, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 16), generator=g),
             "labels": torch.randint(0, cfg.vocab, (2, 16), generator=g)}
    for remat, want in ((True, (6, 3)), (False, (3, 3))):
        calls.update(forward=0, backward=0)
        ctx = tsteps.make_ctx(cfg, None, "train", tsteps.DistConfig(remat=remat))
        leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
        loss, _ = tT.lm_loss(tsteps._rebuild(params, iter(leaves)), batch, cfg, ctx)
        torch.autograd.grad(loss, leaves)
        assert (calls["forward"], calls["backward"]) == want, remat


# ---------------------------------------------------------------------------
# the wrapper: paths, padding, refusals
# ---------------------------------------------------------------------------

def _bshn(B, H, S, N, seed):
    x = torch.randn(B, S, H, N, generator=torch.Generator().manual_seed(seed))
    return x.transpose(1, 2)


def test_prepare_reads_the_models_views_in_place():
    """The model's (B, S, H, N) views and contiguous tensors take the
    ``direct`` path, unchanged."""
    B, H, S, N = 2, 3, 9, 32
    r, k, v, w, do = (_bshn(B, H, S, N, s) for s in range(5))
    u = torch.zeros(H, N)
    path, got = prepare(r, k, v, w, u, do.contiguous())
    assert path == "direct"
    for a, b in zip(got[:4], (r, k, v, w)):
        assert a is b
    assert got[6] is None


def test_prepare_copies_what_the_loads_cannot_address_bit_for_bit():
    """An n-stride of 2 or a base 4 bytes off the 16-byte granule takes the
    ``copy`` path: only that tensor is copied, into the model's layout,
    with the same values."""
    B, H, S, N = 2, 3, 9, 64
    r, k, v, w = (_bshn(B, H, S, N, s) for s in range(4))
    strided = torch.randn(B, S, H, 2 * N).transpose(1, 2)[..., ::2]
    base = torch.randn(B * H * S * N + 1)
    offset = base[1:].view(B, H, S, N)
    assert not tma_addressable(strided) and not tma_addressable(offset)
    assert offset.data_ptr() % 16 == 4
    u = torch.zeros(H, N)
    for bad in (strided, offset):
        path, got = prepare(r, k, v, w, u, bad)
        assert path == "copy"
        assert got[0] is r and got[3] is w
        assert torch.equal(got[5], bad) and tma_addressable(got[5])
        assert got[5].stride() == r.stride()
    path, got = prepare(r, offset, v, w, u, r)
    assert path == "copy" and torch.equal(got[1], offset) and got[5] is r


@pytest.mark.parametrize("with_dstate", [True, False])
@pytest.mark.parametrize("N", [4, 8, 16])
def test_padded_head_size_gives_the_plain_gradients(N, with_dstate):
    """pad (``prepare``) -> plain -> crop equals the plain version at the
    original N, and ``jax.vjp``, at 1e-5: the padded entries are 0."""
    case = _case(2, 3, 13, N, "sigmoid", seed=N, with_dstate=with_dstate)
    ts = [None if x is None else _t(x) for x in case]
    path, padded = prepare(*ts)
    assert path == "pad" and padded[0].shape[-1] == 32 and padded[4].shape == (3, 32)
    assert not padded[4][:, N:].any() and not padded[5][..., N:].any()
    assert (padded[6] is None) == (not with_dstate)
    got = ref.wkv6_bwd(*padded)
    got = [g[..., :N] for g in got]
    for g in got[:4]:
        assert g.shape == (2, 3, 13, N)
    _close([g.numpy() for g in got], [g.numpy() for g in ref.wkv6_bwd(*ts)])
    _close([g.numpy() for g in got], _jax_vjp(*case))


def test_wrapper_refuses_cpu_tensors_and_what_it_does_not_take():
    """No fallback: CPU tensors raise (``ops`` runs the plain version for
    them instead), as do other dtypes and mismatched shapes."""
    x = torch.ones(1, 2, 4, 32)
    u = torch.ones(2, 32)
    with pytest.raises(ValueError, match="CUDA"):
        wkv6_bwd(x, x, x, x, u, x)
    with pytest.raises(TypeError, match="float32"):
        wkv6_bwd(x.double(), x, x, x, u, x)
    with pytest.raises(TypeError, match="float32"):
        wkv6_bwd(x, x, x, x, u, x, torch.ones(1, 2, 32, 32, dtype=torch.float64))
    with pytest.raises(ValueError, match="one \\(B, H, S, N\\) shape"):
        wkv6_bwd(x, x, x, x, u, x[:, :, :3])
    with pytest.raises(ValueError, match="u of shape"):
        wkv6_bwd(x, x, x, x, torch.ones(2, 16), x)
    with pytest.raises(ValueError, match="dstate of shape"):
        wkv6_bwd(x, x, x, x, u, x, torch.ones(1, 2, 16, 16))
    with pytest.raises(ValueError, match="up to 64"):
        prepare(*[torch.ones(1, 1, 4, 80)] * 4, torch.ones(1, 80), torch.ones(1, 1, 4, 80))


def test_cpu_backward_launches_no_kernel_and_reset_sets_counts_to_zero():
    assert PATHS == ("direct", "copy", "pad")
    n0 = wkv6_bwd.launches
    x = torch.rand(1, 1, 4, 8).requires_grad_()
    o, _ = ops.wkv6(x, x, x, x, torch.zeros(1, 8))
    o.sum().backward()
    assert x.grad is not None and wkv6_bwd.launches == n0
    wkv6_bwd.launches = 3
    wkv6_bwd.launches_by_path["direct"] = 2
    bwd_module.reset_launches()
    assert wkv6_bwd.launches == 0
    assert wkv6_bwd.launches_by_path == {"direct": 0, "copy": 0, "pad": 0}
    assert ops.KERNELS["wkv6_bwd"] is wkv6_bwd
