"""The port's RWKV-6 recurrence (K4's plain version, the device dispatch,
and the model's ``rwkv6_block``) against the JAX reference.

The same seeded numpy inputs go through the reference's definition
(``repro.kernels.ref.wkv6``, which also returns the final state), its Pallas
kernel in interpret mode (as ``tests/test_kernels.py`` runs it) and the
port, at the reference suite's 1e-5.  The CUDA kernel itself runs only on
the card (``chip_smoke.py``); here its ``ring`` path's order of arithmetic
is transcribed in plain PyTorch and held to the same references, its path
choice is checked from layouts alone, and its wrapper is held to its
refusals.
"""

import pytest

torch = pytest.importorskip("torch")

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.registry import get_config as jget_config
from repro.kernels import ref as jref
from repro.kernels.wkv6 import wkv6 as pl_wkv6
from repro.models import rwkv as jrwkv
from repro.models.layers import Ctx as JCtx
from repro.models.params import init_params as jinit_params
from repro.parallel.sharding import TRAIN_RULES
from repro_torch.configs.registry import get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels.wkv6 import wkv6 as cuda_wkv6
from repro_torch.models import rwkv as trwkv
from repro_torch.models.layers import Ctx
from repro_torch.models.params import params_from_numpy

CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(B, H, S, N, seed):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, H, S, N)).astype(np.float32) for _ in range(3))
    w = (1.0 / (1.0 + np.exp(-rng.standard_normal((B, H, S, N))))).astype(np.float32)
    u = np.full((H, N), 0.1, np.float32)
    return r, k, v, w, u


def _t(x):
    return params_from_numpy(x, CPU)


@pytest.mark.parametrize("S", [16, 33])
@pytest.mark.parametrize("N", [8, 16])
def test_wkv6_matches_ref_and_pallas(S, N):
    r, k, v, w, u = _inputs(2, 3, S, N, seed=S * 100 + N)
    jargs = tuple(map(jnp.asarray, (r, k, v, w, u)))
    expect_o, expect_state = jref.wkv6(*jargs)
    expect_pl = pl_wkv6(*jargs, interpret=True)
    for fn in (ref.wkv6, ops.wkv6):
        o, state = fn(*map(_t, (r, k, v, w, u)))
        assert tuple(o.shape) == r.shape and tuple(state.shape) == (2, 3, N, N)
        np.testing.assert_allclose(o.numpy(), np.asarray(expect_o), **TOL)
        np.testing.assert_allclose(o.numpy(), np.asarray(expect_pl), **TOL)
        np.testing.assert_allclose(state.numpy(), np.asarray(expect_state), **TOL)


def test_wkv6_takes_the_models_strided_views():
    """The model hands (B, S, H, N) tensors over as (B, H, S, N) views."""
    r, k, v, w, u = _inputs(2, 3, 9, 8, seed=5)
    views = [_t(np.ascontiguousarray(x.transpose(0, 2, 1, 3))).transpose(1, 2)
             for x in (r, k, v, w)]
    assert not views[0].is_contiguous()
    o, state = ops.wkv6(*views, _t(u))
    expect_o, expect_state = jref.wkv6(*map(jnp.asarray, (r, k, v, w, u)))
    np.testing.assert_allclose(o.numpy(), np.asarray(expect_o), **TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(expect_state), **TOL)


def test_rwkv6_block_matches_reference_on_a_ragged_length():
    """S = 33: the reference pads its chunked scan to 64 with decay 1; one
    K4 call needs no padding.  Output and both cache entries agree."""
    cfg = dataclasses.replace(jget_config("rwkv6_3b").smoke(), activation_dtype="float32")
    specs = jrwkv.rwkv_params(cfg)
    jp = jinit_params(specs, jax.random.PRNGKey(0))
    # the zero-init anchors and bonus would leave the token shift and u idle
    rng = np.random.default_rng(7)
    jp = dict(jp, **{name: jnp.asarray(rng.standard_normal(jp[name].shape) * 0.3,
                                       jnp.float32)
                     for name in ("mu_x", "mu", "w0", "u")})
    x = (rng.standard_normal((2, 33, cfg.d_model)) * 0.5).astype(np.float32)
    out, cache = jrwkv.rwkv6_block(jp, jnp.asarray(x), cfg, JCtx(rules=TRAIN_RULES,
                                                                 dtype=jnp.float32))
    tcfg = dataclasses.replace(get_config("rwkv6_3b").smoke(), activation_dtype="float32")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), CPU)
    got, tcache = trwkv.rwkv6_block(tp, _t(x), tcfg, Ctx(dtype=torch.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(out), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tcache["S"].numpy(), np.asarray(cache["S"]), **TOL)
    np.testing.assert_array_equal(tcache["x_last"].numpy(), np.asarray(cache["x_last"]))


def test_cpu_tensors_take_the_plain_wkv6():
    n0 = cuda_wkv6.launches
    x = torch.ones(1, 1, 4, 16)
    ops.wkv6(x, x, x, x, x[0, 0, :1])
    assert cuda_wkv6.launches == n0


def test_wkv6_kernel_wrapper_refuses_cpu_tensors():
    x = torch.ones(1, 1, 4, 16)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_wkv6(x, x, x, x, x[0, 0, :1])


# ---------------------------------------------------------------------------
# K4's ring path: its order of arithmetic, and the path choice
# ---------------------------------------------------------------------------

def _fma(a, b, c):
    """f32 fused multiply-add: the f32 product is exact in float64."""
    return (a.double() * b.double() + c.double()).float()


def _halve(x, dim):
    """Sum over ``dim`` as the kernel's shuffle rounds do: the lane with bit
    M adds its partner's value, M from half the lanes down to 1."""
    x = x.movedim(dim, -1)
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def _float4_dot(x, y):
    """Per float4 of rows, the kernel's sum x.x y.x, then FMAs in order."""
    x4 = x.reshape(*x.shape[:-1], -1, 4)
    y4 = y.reshape(*y.shape[:-1], -1, 4)
    out = x4[..., 0] * y4[..., 0]
    for e in range(1, 4):
        out = _fma(x4[..., e], y4[..., e], out)
    return out


def _ring_emulation(r, k, v, w, u, TC=16, NC=32, C=4):
    """A plain-PyTorch transcription of ``csrc/wkv6.cu``'s ring path, in its
    order of f32 arithmetic (float32 CPU tensors in, o and the state out).

    Per staged chunk of TC steps, the chunk pass sums the bonus b_t = sum_i
    r_i u_i k_i per float4 of rows (one lane each, u k first) and then over
    the lanes, and likewise c = sum_i r_t+1,i k_t,i for each pair of steps
    (t, t + 1); it also forms the pair's row products r_t+1 w_t, w_t w_t+1
    and k_t w_t+1.  A full chunk then advances two steps at once: each of the
    G = 32 C / NC lanes of a column sums r_t,i S_ij and (r_t+1 w_t)_i S_ij
    over its rows (float4 chunks, in order), the G partial sums are reduced,
    o_t = fma(v_t, b_t, sum) and o_t+1 = fma(v_t+1, b_t+1, fma(v_t, c, sum)),
    and S_ij = fma(w_t w_t+1, S_ij, fma(k_t w_t+1, v_t, k_t+1 v_t+1)).  The
    ragged last chunk goes one step at a time: o_t = fma(v_t, b_t, sum) and
    S_ij = fma(w_i, S_ij, k_i v_j).  Steps past S are never computed."""
    B, H, S, N = r.shape
    G = 32 * C // NC
    # rows[g]: lane group g's rows, in its order
    rows = torch.tensor([[4 * (q * G + g) + e for q in range(N // (4 * G)) for e in range(4)]
                         for g in range(G)])
    state = torch.zeros((B, H, N, N))
    o = torch.zeros((B, H, S, N))

    def row_sums(x):  # sum_i x_i S_ij per lane group, then over the groups
        acc = None
        for i in range(rows.shape[1]):
            xi = x[..., rows[:, i]][..., None]
            si = state[:, :, rows[:, i], :]
            acc = xi * si if acc is None else _fma(xi, si, acc)
        return _halve(acc, dim=2)

    for t0 in range(0, S, TC):
        nt = min(TC, S - t0)
        ch = slice(t0, t0 + nt)
        bonus = _halve(_float4_dot(r[:, :, ch], u[None, :, None] * k[:, :, ch]), dim=-1)
        if nt < TC:
            for dt in range(nt):
                t = t0 + dt
                total = row_sums(r[:, :, t])
                kv = k[:, :, t, :, None] * v[:, :, t, None, :]
                state = _fma(w[:, :, t, :, None], state, kv)
                o[:, :, t] = _fma(v[:, :, t], bonus[:, :, dt, None], total)
            continue
        for dt in range(0, TC, 2):
            t = t0 + dt
            c = _halve(_float4_dot(r[:, :, t + 1], k[:, :, t]), dim=-1)[..., None]
            rw = r[:, :, t + 1] * w[:, :, t]
            ww = (w[:, :, t] * w[:, :, t + 1])[..., None]
            kw = (k[:, :, t] * w[:, :, t + 1])[..., None]
            v0, v1 = v[:, :, t, None, :], v[:, :, t + 1, None, :]
            total0, total1 = row_sums(r[:, :, t]), row_sums(rw)
            state = _fma(ww, state, _fma(kw, v0, k[:, :, t + 1, :, None] * v1))
            o[:, :, t] = _fma(v[:, :, t], bonus[:, :, dt, None], total0)
            o[:, :, t + 1] = _fma(v[:, :, t + 1], bonus[:, :, dt + 1, None],
                                  _fma(v[:, :, t], c, total1))
    return o, state


def _decays(kind, shape, rng):
    """w in (0, 1): the suite's sigmoid, or the model's exp(-exp(x)) pushed
    near 0 (down to ~1e-30) or near 1 (within ~1e-3 of it)."""
    x = rng.standard_normal(shape)
    if kind == "sigmoid":
        return (1.0 / (1.0 + np.exp(-x))).astype(np.float32)
    return np.exp(-np.exp(x + (2.0 if kind == "near0" else -8.0))).astype(np.float32)


@pytest.mark.parametrize("decay", ["sigmoid", "near0", "near1"])
@pytest.mark.parametrize("S", [33, 257])
@pytest.mark.parametrize("N", [32, 64])
def test_ring_path_arithmetic_matches_ref_and_pallas(N, S, decay):
    """The ring kernel's factored bonus, chunked staging and per-lane row
    tiles hold the reference and the Pallas kernel at the suite's 1e-5
    (rtol, and atol 1e-5 x the largest reference value: the sums over N are
    taken in another order, so the absolute error grows with the values, as
    ``chip_smoke.py`` holds the kernel on the card)."""
    rng = np.random.default_rng(N * 1000 + S)
    B, H = 1, 2
    r, k, v = (rng.standard_normal((B, H, S, N)).astype(np.float32) for _ in range(3))
    w = _decays(decay, (B, H, S, N), rng)
    u = (0.5 * rng.standard_normal((H, N))).astype(np.float32)
    got_o, got_state = (x.numpy() for x in _ring_emulation(*map(_t, (r, k, v, w, u))))
    jargs = tuple(map(jnp.asarray, (r, k, v, w, u)))
    want_o, want_state = map(np.asarray, jref.wkv6(*jargs))
    for got, want in ((got_o, want_o), (got_o, np.asarray(pl_wkv6(*jargs, interpret=True))),
                      (got_state, want_state)):
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("N", [32, 64])
def test_choose_path_picks_ring_for_the_models_views(N):
    """rwkv6_block's (B, S, H, N) tensors as (B, H, S, N) views, and
    contiguous (B, H, S, N) tensors, take the ring path with their strides."""
    from repro_torch.kernels.wkv6 import choose_path

    B, H, S = 2, 3, 9
    for x in (torch.zeros(B, S, H, N).transpose(1, 2), torch.zeros(B, H, S, N)):
        ptrs = (x.data_ptr(),) * 4
        assert choose_path(tuple(x.shape), x.stride(), ptrs) == ("ring", x.stride())


@pytest.mark.parametrize("N", [32, 64])
def test_choose_path_copies_where_tma_cannot(N):
    """An n-stride of 2 or a base off the 16-byte granule takes the copy
    path; the copy is the model's layout, which the ring path takes, with the
    values unchanged."""
    from repro_torch.kernels.layout import copy_bshd
    from repro_torch.kernels.wkv6 import choose_path

    B, H, S = 2, 3, 9
    strided = torch.zeros(B, S, H, 2 * N).transpose(1, 2)[..., ::2]  # n-stride 2
    assert strided.stride()[-1] == 2
    base = torch.zeros(B * H * S * N + 1)
    offset = base[1:].view(B, H, S, N)  # base 4 bytes past a 16-byte boundary
    assert offset.data_ptr() % 16 == 4
    for x in (strided, offset):
        got = choose_path(tuple(x.shape), x.stride(), (x.data_ptr(),) * 4)
        assert got == ("copy", x.stride())
        x.copy_(torch.randn(x.shape, generator=torch.Generator().manual_seed(N)))
        y = copy_bshd(x)
        assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()
        bshn = torch.zeros(B, S, H, N).transpose(1, 2)
        assert y.stride() == bshn.stride()
        assert choose_path(tuple(y.shape), y.stride(), (y.data_ptr(),) * 4) == ("ring", y.stride())
    # one misaligned base among the four is enough
    good = torch.zeros(B, H, S, N)
    assert choose_path(tuple(good.shape), good.stride(),
                       (good.data_ptr(),) * 3 + (offset.data_ptr(),))[0] == "copy"


def test_choose_path_replaces_unused_strides_of_size_one_dims():
    """A size-1 dimension's stride is never used; TMA still needs it to be
    a 16-byte multiple, so the ring path gets one past the tensor's span."""
    from repro_torch.kernels.wkv6 import choose_path

    path, st = choose_path((1, 1, 9, 64), (7, 3, 64, 1), (0,) * 4)
    assert path == "ring" and st == (9 * 64, 9 * 64, 64, 1)


def test_wkv6_wrapper_refusals_and_head_sizes_unchanged():
    from repro_torch.kernels import wkv6 as wkv6_module

    assert wkv6_module.HEAD_SIZES == (32, 64)  # built; smaller N are padded
    assert wkv6_module.PATHS == ("ring", "copy", "pad")
    with pytest.raises(ValueError, match="up to 64"):
        wkv6_module.built_head_size(80)
    x = torch.ones(1, 2, 4, 32)
    u = torch.ones(2, 32)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_wkv6(x, x, x, x, u)
    with pytest.raises(TypeError, match="float32"):
        cuda_wkv6(x.double(), x, x, x, u)
    with pytest.raises(TypeError, match="float32"):
        cuda_wkv6(x, x, x, x, u.double())
    for bad_u in (torch.ones(2, 16), torch.ones(1, 32), torch.ones(64)):
        with pytest.raises(ValueError, match="u of shape"):
            cuda_wkv6(x, x, x, x, bad_u)
    with pytest.raises(ValueError, match="one \\(B, H, S, N\\) shape"):
        cuda_wkv6(x, x, x, x[:, :, :3], u)


def test_reset_launches_sets_every_count_to_zero():
    from repro_torch.kernels import wkv6 as wkv6_module

    cuda_wkv6.launches = 3
    cuda_wkv6.launches_by_path["ring"] = 2
    wkv6_module.reset_launches()
    assert cuda_wkv6.launches == 0
    assert cuda_wkv6.launches_by_path == {"ring": 0, "copy": 0, "pad": 0}


@pytest.mark.parametrize("N", [4, 8, 16])
def test_padded_head_size_equals_plain_and_reference(N):
    """pad (the wrapper's ``prepare``) -> plain -> crop equals the plain
    version on the original N, and the reference, at 1e-5: the padded k and
    v entries are 0, so the state's extra rows and columns stay 0."""
    from repro_torch.kernels.wkv6 import built_head_size, prepare

    r, k, v, w, u = _inputs(2, 3, 19, N, seed=N)
    ts = tuple(map(_t, (r, k, v, w, u)))
    path, padded = prepare(*ts)
    assert path == "pad" and padded[0].shape[-1] == built_head_size(N) == 32
    assert padded[4].shape == (3, 32) and not padded[4][:, N:].any()
    o, state = ref.wkv6(*padded)
    o, state = o[..., :N], state[:, :, :N, :N]
    plain_o, plain_state = ref.wkv6(*ts)
    torch.testing.assert_close(o, plain_o, **TOL)
    torch.testing.assert_close(state, plain_state, **TOL)
    expect_o, expect_state = jref.wkv6(*map(jnp.asarray, (r, k, v, w, u)))
    np.testing.assert_allclose(o.numpy(), np.asarray(expect_o), **TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(expect_state), **TOL)


def test_unequal_strides_take_the_copy_path():
    """r, k, v and w whose strides differ are no longer refused: ``prepare``
    copies all four into the model's layout, where one set of strides reads
    them all, with the same values and the same plain result."""
    from repro_torch.kernels.wkv6 import choose_path, prepare

    B, H, S, N = 2, 3, 9, 32
    r, k, v, w, u = map(_t, _inputs(B, H, S, N, seed=5))
    k_bshn = k.transpose(1, 2).contiguous().transpose(1, 2)  # same values, other strides
    assert k_bshn.stride() != r.stride()
    path, got = prepare(r, k_bshn, v, w, u)
    assert path == "copy"
    assert len({t.stride() for t in got[:4]}) == 1
    assert choose_path((B, H, S, N), got[0].stride(),
                       tuple(t.data_ptr() for t in got[:4]))[0] == "ring"
    for a, b in zip(got, (r, k, v, w, u)):
        assert torch.equal(a, b)
    for a, b in zip(ref.wkv6(*got), ref.wkv6(r, k, v, w, u)):
        torch.testing.assert_close(a, b, **TOL)
