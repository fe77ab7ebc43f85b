"""The port's attention gradient (K3's log-sum-exp rows, K3b's plain version,
the autograd Function and the model's ``layers.attention``) against the JAX
reference's FlashAttention-2 regions.

The same seeded numpy inputs go through the reference's
``fusedkernel_flash_fwd`` / ``fusedkernel_flash_bwd`` (the regions its
``custom_vjp`` runs) and the port's plain ``ref.flash_attention_fwd`` /
``ref.flash_attention_bwd``; then ``jax.grad`` of the reference's
``L.attention`` (with ``q_chunk = kv_chunk = 16``, so the ``custom_vjp`` path
runs, and at 4096, its dense einsum path) against ``torch.autograd`` through
the port's ``L.attention``.  Tolerance: the reference suite's rtol = atol =
1e-4 (``tests/test_models.py::test_flash_equals_dense_attention_with_grads``).
The CUDA kernels run only on the card (``chip_smoke.py`` ``[K3-lse]``,
``[K3b]``); here K3b's wrapper is held to refusing CPU tensors, and what it
hands the kernel (``prepare``: the path, the copies of layouts TMA cannot
address and the zero-padding of head dims that are not built) is fed to the
plain version with the kernel's scale.  ``_tiled_bwd`` transcribes the bf16
kernels' tiling into plain PyTorch (their blocks and tiles, which tiles are
masked, P in base 2 from padded row statistics, where P and dS are rounded,
the order of every sum); it is held to the reference's
``fusedkernel_flash_bwd`` and ``jax.grad`` in f32 at 1e-4 and to the plain
``ref.flash_attention_bwd`` in bf16 at 1e-2 x max |grad|.

With a logit cap (5, on inputs scaled so the logits reach ~15) the
reference's ``fusedkernel_flash_bwd`` is wrong (ROADMAP section 3, fault 7:
no ``1 - tanh^2`` in dS; a test below records it), so the capped plain
backward, the capped transcription and ``torch.autograd`` through
``L.attention`` are held to autodiff of the reference's capped forward:
``jax.vjp`` of ``_flash_fwd_inner`` and ``jax.grad`` of its dense branch, at
1e-4.
"""

import pytest

torch = pytest.importorskip("torch")

import math

import jax
import jax.numpy as jnp
import numpy as np

from repro.models import layers as jL
from repro.parallel.sharding import TRAIN_RULES
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import tma_addressable
from repro_torch.kernels.flash_attention_bwd import PATHS, flash_attention_bwd, prepare
from repro_torch.models import layers as tL

TOL = dict(rtol=1e-4, atol=1e-4)
# B, Sq, Sk, K (KV heads), G (query heads per KV head), hd, causal
CASES = [
    (2, 32, 32, 2, 2, 16, True),
    (2, 32, 32, 2, 2, 16, False),
    (1, 48, 32, 1, 4, 32, True),    # GQA, Sq > Sk
    (2, 32, 48, 2, 1, 32, False),   # Sq < Sk
    (1, 32, 48, 2, 2, 96, True),    # hd 96 (minicpm3's MLA), Sq < Sk, causal
]


def _inputs(B, Sq, Sk, K, G, hd, seed=0):
    """q (B, Sq, K, G, hd), k, v (B, Sk, K, hd), dout like q: the
    reference's grouped layout, f32 normal."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, K, G, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sk, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sk, K, hd)).astype(np.float32)
    do = rng.standard_normal((B, Sq, K, G, hd)).astype(np.float32)
    return q, k, v, do


def _bhsd(a):
    """A reference (B, S, [K, G,] hd) array as the port's (B, H, S, hd) view."""
    a = np.array(a)
    B, S = a.shape[:2]
    return torch.from_numpy(a.reshape(B, S, -1, a.shape[-1])).transpose(1, 2)


def _ref_regions(q, k, v, do, causal, kv_len=None):
    hd = q.shape[-1]
    kw = dict(causal=causal, scale=1 / math.sqrt(hd), Cq=16, Ck=16, logit_cap=0.0,
              kv_len=kv_len)
    o, lse = jL.fusedkernel_flash_fwd(q, k, v, 0, **kw)
    grads = jL.fusedkernel_flash_bwd(q, k, v, o, lse, do, 0, **kw)
    return o, lse, grads


@pytest.mark.parametrize("case", CASES)
def test_plain_forward_and_lse_match_fusedkernel_flash_fwd(case):
    B, Sq, Sk, K, G, hd, causal = case
    q, k, v, do = _inputs(*case[:-1])
    o, lse, _ = _ref_regions(q, k, v, do, causal)
    to, tlse = ref.flash_attention_fwd(_bhsd(q), _bhsd(k), _bhsd(v), causal=causal)
    np.testing.assert_allclose(to.transpose(1, 2).numpy().reshape(o.shape), np.asarray(o),
                               **TOL)
    np.testing.assert_allclose(tlse.numpy().reshape(lse.shape), np.asarray(lse), **TOL)


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_fusedkernel_flash_bwd_on_its_lse(case):
    """Both backward passes fed the reference's own output and LSE."""
    B, Sq, Sk, K, G, hd, causal = case
    q, k, v, do = _inputs(*case[:-1])
    o, lse, (dq, dk, dv) = _ref_regions(q, k, v, do, causal)
    tlse = torch.from_numpy(np.array(lse).reshape(B, K * G, Sq))
    got = ref.flash_attention_bwd(_bhsd(q), _bhsd(k), _bhsd(v), _bhsd(o), tlse, _bhsd(do),
                                  causal=causal)
    for g, want in zip(got, (dq, dk, dv)):
        np.testing.assert_allclose(g.transpose(1, 2).numpy().reshape(want.shape),
                                   np.asarray(want), **TOL)


def test_plain_backward_rounds_p_and_ds_like_the_reference_in_bf16():
    """bf16 inputs: P and dS rounded to bf16 before their products, as the
    reference's ``.astype`` calls round them (reference's tolerance in bf16,
    2e-2)."""
    B, Sq, Sk, K, G, hd = 2, 32, 32, 2, 2, 32
    q, k, v, do = (jnp.asarray(a, jnp.bfloat16) for a in _inputs(B, Sq, Sk, K, G, hd, seed=3))
    o, lse, want = _ref_regions(q, k, v, do, True)

    def t(a):
        return _bhsd(np.asarray(a, np.float32)).to(torch.bfloat16)

    tlse = torch.from_numpy(np.array(lse).reshape(B, K * G, Sq))
    got = ref.flash_attention_bwd(t(q), t(k), t(v), t(o), tlse, t(do), causal=True)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().transpose(1, 2).numpy().reshape(w.shape),
                                   np.asarray(w, np.float32), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("chunk", [16, 4096], ids=["custom_vjp", "dense"])
@pytest.mark.parametrize("case", CASES)
def test_attention_grads_match_reference(case, chunk):
    """``torch.autograd`` through the port's ``L.attention`` (the
    :class:`ops.FlashAttention` Function, on the CPU its plain versions)
    against ``jax.grad`` of the reference's, loss = sum(o * dout)."""
    B, Sq, Sk, K, G, hd, causal = case
    q, k, v, do = _inputs(*case[:-1])
    H = K * G
    q4 = q.reshape(B, Sq, H, hd)
    ctx = jL.Ctx(rules=TRAIN_RULES, dtype=jnp.float32, q_chunk=chunk, kv_chunk=chunk)
    do4 = jnp.asarray(do.reshape(B, Sq, H, hd))

    def loss(q, k, v):
        return (jL.attention(q, k, v, causal=causal, ctx=ctx) * do4).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q4), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(np.array(a)).requires_grad_() for a in (q4, k, v))
    out = tL.attention(tq, tk, tv, causal=causal)
    got = torch.autograd.grad((out * torch.from_numpy(np.array(do4))).sum(), (tq, tk, tv))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_dispatch_takes_the_function_only_under_grad():
    """``ops.flash_attention`` goes through :class:`ops.FlashAttention` when
    grad is enabled and an input requires it; otherwise it is the serving
    call, which keeps no graph."""
    q = torch.randn(1, 2, 8, 16, generator=torch.Generator().manual_seed(0))
    assert ops.flash_attention(q, q, q).grad_fn is None
    qg = q.clone().requires_grad_()
    with torch.no_grad():
        assert ops.flash_attention(qg, q, q).grad_fn is None
    out = ops.flash_attention(qg, q, q)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    torch.testing.assert_close(out, ref.flash_attention(q, q, q), rtol=0, atol=0)


def test_bwd_wrapper_refuses_cpu_tensors():
    """No fallback: the CUDA wrapper raises on CPU tensors (on the CPU,
    ``ops`` runs the plain version instead)."""
    q = torch.zeros(1, 2, 8, 32)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd(q, q, q, q, lse, q)


@pytest.mark.parametrize("hd", [4, 16, 32, 48, 96])
def test_prepare_pads_head_dims_exactly(hd):
    """What the wrapper hands the kernel, fed to the plain version with the
    kernel's scale (``1/sqrt`` of the caller's head dim): the padded
    gradients' first ``hd`` columns equal the unpadded ones and the rest are
    0."""
    gen = torch.Generator().manual_seed(hd)
    B, H, K, Sq, Sk = 2, 4, 2, 24, 40
    q, o, dout = (torch.randn(B, Sq, H, hd, generator=gen).transpose(1, 2) for _ in range(3))
    k, v = (torch.randn(B, Sk, K, hd, generator=gen).transpose(1, 2) for _ in range(2))
    _, lse = ref.flash_attention_fwd(q, k, v, causal=True)
    path, prepared = prepare(q, k, v, o, dout)
    assert path in PATHS and path == ("fp32" if hd in (32, 64, 128) else "pad")
    want = ref.flash_attention_bwd(q, k, v, o, lse, dout, causal=True)
    got = ref.flash_attention_bwd(*prepared[:4], lse, prepared[4], causal=True,
                                  scale=1 / math.sqrt(hd))
    for g, w in zip(got, want):
        torch.testing.assert_close(g[..., :hd], w, rtol=1e-5, atol=1e-5)
        assert not g[..., hd:].any()


def test_prepare_picks_each_path_from_dtype_head_dim_and_layout():
    """K3's paths: f32 in place through any strides (``fp32``), bf16 in place
    where TMA addresses q, k, v and dout (``tma``; o is read through its
    strides), head dims that are not built padded (``pad``)."""
    assert PATHS == ("tma", "fp32", "copy", "pad")
    x = torch.zeros(1, 2, 8, 64)
    assert prepare(*[x] * 5)[0] == "fp32"
    assert prepare(*[x[..., ::2]] * 5)[0] == "fp32"  # any strides
    y = x.to(torch.bfloat16)
    path, got = prepare(y, y, y, y[..., ::2].repeat_interleave(2, -1)[..., ::2], y)
    assert path == "tma" and all(a is b for a, b in zip(got[:3], (y, y, y))) and got[4] is y
    for hd, built in ((16, 32), (96, 128)):
        z = torch.ones(1, 2, 8, hd, dtype=torch.bfloat16)
        path, got = prepare(*[z] * 5)
        assert path == "pad" and all(t.shape[-1] == built for t in got)


def test_prepare_copies_what_tma_cannot_address_bit_for_bit():
    """The ``copy`` path: a bf16 dout whose last dimension has stride 2 and a
    q whose base is 4 bytes off the 16-byte granule are copied into the
    model's (B, S, heads, hd) layout with the same bits; the tensors TMA can
    address, and o (read through its strides), are passed on untouched."""
    gen = torch.Generator().manual_seed(7)
    B, H, K, S, hd = 2, 4, 2, 24, 64
    q, o = (torch.randn(B, S, H, hd, generator=gen).to(torch.bfloat16).transpose(1, 2)
            for _ in range(2))
    k, v = (torch.randn(B, S, K, hd, generator=gen).to(torch.bfloat16).transpose(1, 2)
            for _ in range(2))
    strided = torch.randn(B, S, H, 2 * hd, generator=gen).to(torch.bfloat16)[..., ::2]
    strided = strided.transpose(1, 2)
    flat = torch.randn(B * S * H * hd + 2, generator=gen).to(torch.bfloat16)
    offset = flat[2:].view(B, S, H, hd).transpose(1, 2)
    assert all(tma_addressable(t) for t in (q, k, v, o))
    assert not tma_addressable(strided) and not tma_addressable(offset)
    for qq, dout in ((q, strided), (offset, q)):
        path, got = prepare(qq, k, v, o, dout)
        assert path == "copy"
        for t, given in zip(got, (qq, k, v, o, dout)):
            assert torch.equal(t, given)
            if tma_addressable(given) or t is o:
                assert t is given
            else:
                assert tma_addressable(t) and t.transpose(1, 2).is_contiguous()


# ---------------------------------------------------------------------------
# the bf16 kernels' tiling, transcribed
# ---------------------------------------------------------------------------

LOG2E = 1.4426950408889634
BQ = BKV = 128  # query rows a dq block owns; keys a dk/dv block owns


def _tile_sizes(hd: int) -> tuple[int, int]:
    """(keys per tile of the dq kernel, query rows per tile of the dk/dv
    kernel) at a built head dim: fewer at 128, for registers."""
    return (64, 32) if hd > 64 else (128, 64)


def _rows(t, r0, n):
    """Rows [r0, r0 + n) of ``t`` (..., S, hd) in f32, zeros past S (TMA's
    zero fill)."""
    out = torch.zeros((*t.shape[:-2], n, t.shape[-1]))
    stop = min(r0 + n, t.shape[-2])
    if stop > r0:
        out[..., :stop - r0, :] = t[..., r0:stop, :].float()
    return out


def _tiled_bwd(q, k, v, o, lse, dout, *, causal, kv_len=None, scale=None, cap=0.0):
    """K3b's bf16 kernels in plain PyTorch: (dq, dk, dv) as they compute them,
    for any dtype (P and dS are rounded to it).

    Row statistics: ``lse2 = lse log2(e)`` and ``delta = rowsum(dO O)`` in
    rows padded to a multiple of 128, the padding's ``lse2`` +inf, so a row
    past Sq gets P = 0 unmasked.  dq: a block owns 128 query rows, each half
    of 64 (a consumer warpgroup) sums its key tiles in order; the tiles
    wholly below kv_len and the half's diagonal are unmasked, the rest
    masked; blocks past the diagonal or kv_len are skipped when kv_len > 0.
    dk/dv: a block owns 128 keys of a KV head, each half of 64 sums over the
    G query heads, then the query tiles from the first that sees the block's
    keys; the first tiles of each head, up to the half's diagonal (all of
    them where its keys cross kv_len), masked.  P = exp2(s scale log2(e) -
    lse2), a masked logit -1e30 log2(e).  With a cap, t = tanh(s scale / cap)
    takes the dot's place and cap log2(e) the scale's, and dS carries
    1 - t^2."""
    B, H, Sq, hd = q.shape
    Kh, Sk = k.shape[1], k.shape[2]
    G = H // Kh
    sc = 1.0 / math.sqrt(hd) if scale is None else scale
    kv = Sk if kv_len is None else max(0, min(int(kv_len), Sk))
    BK, BQT = _tile_sizes(hd)
    f32 = torch.float32
    sl = torch.tensor(cap if cap > 0 else sc, dtype=f32) * torch.tensor(LOG2E, dtype=f32)
    tanh_scale = torch.tensor(sc, dtype=f32) / torch.tensor(cap, dtype=f32) if cap > 0 else None

    def logits(s):
        """-> (s or t in base 2 before the LSE, the factor dS carries)."""
        if cap > 0:
            t = torch.tanh(s * tanh_scale)
            return t * sl, 1 - t * t
        return s * sl, 1.0
    neg2 = torch.tensor(-1e30, dtype=f32) * torch.tensor(LOG2E, dtype=f32)

    def rnd(x):
        return x.to(q.dtype).float()

    sq_pad = -(-Sq // BQ) * BQ
    lse2 = torch.full((B, H, sq_pad), math.inf)
    lse2[..., :Sq] = lse.float() * torch.tensor(LOG2E, dtype=f32)
    delta = torch.zeros((B, H, sq_pad))
    delta[..., :Sq] = (dout.float() * o.float()).sum(-1)
    any_valid = kv > 0

    def masked(x, l2, rows, keys):
        ok = keys < kv
        if causal:
            ok = ok & (keys <= rows)
        return torch.where(ok, x, neg2 - l2)

    # dq
    dq = torch.zeros((B, H, sq_pad, hd))
    ke, ve = (t.repeat_interleave(G, dim=1) for t in (k, v))
    for q0 in range(0, sq_pad, BQ):
        k_end = kv if any_valid else Sk
        if causal and any_valid:
            k_end = min(k_end, q0 + BQ)
        n_tiles = -(-k_end // BK)
        for w in range(2):
            first_row = q0 + 64 * w
            rows = torch.arange(first_row, first_row + 64)
            n_plain = 0
            if any_valid:
                n_plain = min(n_tiles, (min(kv, first_row + 1) if causal else kv) // BK)
            qt, dot = _rows(q, first_row, 64), _rows(dout, first_row, 64)
            l2, dl = lse2[..., rows, None], delta[..., rows, None]
            acc = torch.zeros((B, H, 64, hd))
            for i in range(n_tiles):
                kt, vt = _rows(ke, i * BK, BK), _rows(ve, i * BK, BK)
                x, dt = logits(qt @ kt.transpose(-1, -2))
                x = x - l2
                if i >= n_plain:
                    x = masked(x, l2, rows[:, None], torch.arange(i * BK, (i + 1) * BK))
                ds = torch.exp2(x) * (dot @ vt.transpose(-1, -2) - dl) * dt * sc
                acc = acc + rnd(ds) @ kt
            dq[..., rows, :] = acc
    # dk and dv
    sk_pad = -(-Sk // BKV) * BKV
    dk = torch.zeros((B, Kh, sk_pad, hd))
    dv = torch.zeros((B, Kh, sk_pad, hd))
    for k0 in range(0, sk_pad, BKV):
        first = k0 // BQT if causal and any_valid else 0
        n_per = 0 if any_valid and k0 >= kv else max(0, -(-Sq // BQT) - first)
        for w in range(2):
            kw = k0 + 64 * w
            keys = torch.arange(kw, kw + 64)
            n_mask = n_per
            if any_valid and kw + 64 <= kv:
                n_mask = min(n_per, max(0, -(-(kw + 63) // BQT) - first)) if causal else 0
            kt, vt = _rows(k, kw, 64), _rows(v, kw, 64)
            dk_acc = torch.zeros((B, Kh, 64, hd))
            dv_acc = torch.zeros((B, Kh, 64, hd))
            for g in range(G):
                heads = torch.arange(Kh) * G + g
                for jj in range(n_per):
                    r0 = (first + jj) * BQT
                    rows = torch.arange(r0, r0 + BQT)
                    qt, dot = _rows(q[:, heads], r0, BQT), _rows(dout[:, heads], r0, BQT)
                    l2, dl = lse2[:, heads][..., None, rows], delta[:, heads][..., None, rows]
                    x, dt = logits(kt @ qt.transpose(-1, -2))
                    x = x - l2
                    if jj < n_mask:
                        x = masked(x, l2, rows[None, :], keys[:, None])
                    p = torch.exp2(x)
                    ds = p * (vt @ dot.transpose(-1, -2) - dl) * dt * sc
                    dv_acc = dv_acc + rnd(p) @ dot
                    dk_acc = dk_acc + rnd(ds) @ qt
            dk[..., keys, :] = dk_acc
            dv[..., keys, :] = dv_acc
    return (dq[..., :Sq, :].to(q.dtype), dk[..., :Sk, :].to(k.dtype),
            dv[..., :Sk, :].to(v.dtype))


def _tiled_as_kernel(q, k, v, o, lse, dout, *, causal, kv_len=None, cap=0.0):
    """The transcription on what the wrapper hands the kernel (``prepare``:
    head dims padded with the caller's scale), cropped back."""
    hd = q.shape[-1]
    _, (pq, pk, pv, po, pdo) = prepare(q, k, v, o, dout)
    got = _tiled_bwd(pq, pk, pv, po, lse, pdo, causal=causal, kv_len=kv_len,
                     scale=1 / math.sqrt(hd), cap=cap)
    return tuple(g[..., :hd] for g in got)


# CASES, a ragged Sq != Sk over several tiles of each kernel, and every key
# masked (kv_len 0); B, Sq, Sk, K, G, hd, causal, kv_len
TILED_CASES = [(*c, None) for c in CASES] + [
    (1, 208, 336, 2, 2, 64, True, None),
    (1, 336, 208, 1, 3, 32, True, 200),
    (1, 176, 144, 2, 2, 128, False, 100),
    (1, 48, 80, 2, 2, 32, True, 0),
]


@pytest.mark.parametrize("case", TILED_CASES)
def test_tiled_transcription_matches_fusedkernel_flash_bwd_in_f32(case):
    """f32, the reference's own output and LSE in: the tiling (which tiles
    run, which are masked, the padded statistics, the order of the sums)
    gives the reference's gradients at 1e-4, and ``jax.grad`` of its dense
    attention where no kv_len is set."""
    B, Sq, Sk, K, G, hd, causal, kv_len = case
    q, k, v, do = _inputs(B, Sq, Sk, K, G, hd)
    o, lse, want = _ref_regions(q, k, v, do, causal, kv_len)
    tlse = torch.from_numpy(np.array(lse).reshape(B, K * G, Sq))
    got = _tiled_as_kernel(_bhsd(q), _bhsd(k), _bhsd(v), _bhsd(o), tlse, _bhsd(do),
                           causal=causal, kv_len=kv_len)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.transpose(1, 2).numpy().reshape(w.shape), np.asarray(w),
                                   **TOL)
    if kv_len is None:
        H = K * G
        ctx = jL.Ctx(rules=TRAIN_RULES, dtype=jnp.float32, q_chunk=4096, kv_chunk=4096)
        do4 = jnp.asarray(do.reshape(B, Sq, H, hd))

        def loss(q4, k, v):
            return (jL.attention(q4, k, v, causal=causal, ctx=ctx) * do4).sum()

        dense = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q.reshape(B, Sq, H, hd)),
                                                  jnp.asarray(k), jnp.asarray(v))
        for g, w in zip(got, dense):
            np.testing.assert_allclose(g.transpose(1, 2).numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("case", TILED_CASES)
def test_tiled_transcription_matches_plain_in_bf16(case):
    """bf16: the transcription against the plain ``ref.flash_attention_bwd``,
    both fed the plain forward's output and LSE, at ``chip_smoke.py``'s
    bf16 tolerance for K3b: max |got - plain| <= 1e-2 x max |plain| on each
    gradient (P and dS rounded to bf16 at the same places; sums in another
    order can round an element one bf16 step the other way)."""
    B, Sq, Sk, K, G, hd, causal, kv_len = case
    q, k, v, do = (_bhsd(a).to(torch.bfloat16) for a in _inputs(B, Sq, Sk, K, G, hd, seed=5))
    o, lse = ref.flash_attention_fwd(q, k, v, causal=causal, kv_len=kv_len)
    got = _tiled_as_kernel(q, k, v, o, lse, do, causal=causal, kv_len=kv_len)
    want = ref.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, kv_len=kv_len)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.bfloat16 and g.shape == w.shape
        scale = w.float().abs().max().item()
        err = (g.float() - w.float()).abs().max().item()
        assert err <= 1e-2 * scale, (err, scale)


# ---------------------------------------------------------------------------
# the logit cap
# ---------------------------------------------------------------------------

CAP = 5.0


def _capped_inputs(B, Sq, Sk, K, G, hd, seed=0):
    """:func:`_inputs` with q and k times 3: the scaled logits reach ~15,
    three times the cap, so the tanh saturates and ``1 - t^2`` matters."""
    q, k, v, do = _inputs(B, Sq, Sk, K, G, hd, seed)
    return 3 * q, 3 * k, v, do


def _vjp_capped(q, k, v, do, causal, kv_len=None):
    """Autodiff of the reference's capped blockwise forward: ``jax.vjp`` of
    ``_flash_fwd_inner`` (plain JAX, not the ``custom_vjp``), the output's
    cotangent ``do`` and the LSE's 0.  -> (o, lse, (dq, dk, dv))."""
    hd = q.shape[-1]

    def fwd(q, k, v):
        return jL._flash_fwd_inner(q, k, v, causal=causal, q_offset=0, scale=1 / math.sqrt(hd),
                                   Cq=16, Ck=16, logit_cap=CAP, kv_len=kv_len)

    (o, lse), pull = jax.vjp(fwd, *map(jnp.asarray, (q, k, v)))
    return o, lse, pull((jnp.asarray(do), jnp.zeros_like(lse)))


def _assert_grads(got, want, **tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().transpose(1, 2).numpy().reshape(w.shape),
                                   np.asarray(w, np.float32), **tol)


# TILED_CASES but the one whose keys are all masked (kv_len 0): there
# autodiff gives no dq and dk (the mask's where), while every FlashAttention-2
# backward, the reference's regions and the port's alike, forms dS from
# P = 1 / Sk on every key
VJP_CASES = [c for c in TILED_CASES if c[-1] != 0]


@pytest.mark.parametrize("case", VJP_CASES)
def test_capped_plain_backward_matches_autodiff_of_the_reference_forward(case):
    """The plain capped forward and LSE against the reference's, and the
    plain backward, fed the reference's output and LSE, against
    ``jax.vjp`` of the reference's capped forward at 1e-4."""
    B, Sq, Sk, K, G, hd, causal, kv_len = case
    q, k, v, do = _capped_inputs(B, Sq, Sk, K, G, hd)
    o, lse, want = _vjp_capped(q, k, v, do, causal, kv_len)
    tq, tk, tv, tdo = map(_bhsd, (q, k, v, do))
    to, tlse = ref.flash_attention_fwd(tq, tk, tv, causal=causal, kv_len=kv_len, cap=CAP)
    _assert_grads([to], [o], **TOL)
    np.testing.assert_allclose(tlse.numpy().reshape(lse.shape), np.asarray(lse), **TOL)
    tlse = torch.from_numpy(np.array(lse).reshape(B, K * G, Sq))
    got = ref.flash_attention_bwd(tq, tk, tv, _bhsd(o), tlse, tdo, causal=causal,
                                  kv_len=kv_len, cap=CAP)
    _assert_grads(got, want, **TOL)


@pytest.mark.parametrize("case", TILED_CASES)
def test_capped_tiled_transcription_matches_plain_and_autodiff_in_f32(case):
    """f32: the bf16 kernels' tiling with the cap (t in place of the dot,
    ``1 - t^2`` in dS) against the plain capped backward at 1e-4, and
    against ``jax.vjp`` of the reference's capped forward where a row has a
    valid key."""
    B, Sq, Sk, K, G, hd, causal, kv_len = case
    q, k, v, do = _capped_inputs(B, Sq, Sk, K, G, hd)
    tq, tk, tv, tdo = map(_bhsd, (q, k, v, do))
    o, lse = ref.flash_attention_fwd(tq, tk, tv, causal=causal, kv_len=kv_len, cap=CAP)
    got = _tiled_as_kernel(tq, tk, tv, o, lse, tdo, causal=causal, kv_len=kv_len, cap=CAP)
    plain = ref.flash_attention_bwd(tq, tk, tv, o, lse, tdo, causal=causal, kv_len=kv_len,
                                    cap=CAP)
    for g, w in zip(got, plain):
        torch.testing.assert_close(g, w, **TOL)
    if kv_len != 0:
        _assert_grads(got, _vjp_capped(q, k, v, do, causal, kv_len)[2], **TOL)


@pytest.mark.parametrize("case", TILED_CASES)
def test_capped_tiled_transcription_matches_plain_in_bf16(case):
    """bf16 and capped: the transcription against the plain capped backward,
    both fed the plain forward's output and LSE, at ``chip_smoke.py``'s bf16
    tolerance for K3b (max |got - plain| <= 1e-2 x max |plain|)."""
    B, Sq, Sk, K, G, hd, causal, kv_len = case
    q, k, v, do = (_bhsd(a).to(torch.bfloat16)
                   for a in _capped_inputs(B, Sq, Sk, K, G, hd, seed=5))
    o, lse = ref.flash_attention_fwd(q, k, v, causal=causal, kv_len=kv_len, cap=CAP)
    got = _tiled_as_kernel(q, k, v, o, lse, do, causal=causal, kv_len=kv_len, cap=CAP)
    want = ref.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, kv_len=kv_len, cap=CAP)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.bfloat16 and g.shape == w.shape
        scale = w.float().abs().max().item()
        err = (g.float() - w.float()).abs().max().item()
        assert err <= 1e-2 * scale, (err, scale)


@pytest.mark.parametrize("case", CASES)
def test_capped_attention_grads_match_the_reference_dense_branch(case):
    """``torch.autograd`` through the port's ``L.attention`` with
    ``logit_cap`` (:class:`ops.FlashAttention`, on the CPU its plain
    versions) against ``jax.grad`` of the reference's at chunks of 4096,
    its dense branch, whose autodiff gradient is right (its flash branch's
    is not: fault 7 below), loss = sum(o * dout)."""
    B, Sq, Sk, K, G, hd, causal = case
    q, k, v, do = _capped_inputs(B, Sq, Sk, K, G, hd)
    H = K * G
    q4, do4 = q.reshape(B, Sq, H, hd), jnp.asarray(do.reshape(B, Sq, H, hd))
    ctx = jL.Ctx(rules=TRAIN_RULES, dtype=jnp.float32, q_chunk=4096, kv_chunk=4096)

    def loss(q, k, v):
        return (jL.attention(q, k, v, causal=causal, ctx=ctx, logit_cap=CAP) * do4).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q4, k, v)))
    tq, tk, tv = (torch.from_numpy(np.array(a)).requires_grad_() for a in (q4, k, v))
    out = tL.attention(tq, tk, tv, causal=causal, logit_cap=CAP)
    got = torch.autograd.grad((out * torch.from_numpy(np.array(do4))).sum(), (tq, tk, tv))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_reference_flash_bwd_omits_the_caps_derivative():
    """ROADMAP section 3, fault 7: the reference's ``fusedkernel_flash_bwd``
    recomputes capped logits but forms ``dS = P (dP - delta) scale`` without
    ``1 - t^2``.  Its dv (which does not go through dS) equals autodiff's
    (``jax.vjp`` of ``_flash_fwd_inner``), while its dq and dk are off by
    more than 10% of their largest entry.  The port's backward is held to
    autodiff instead (the tests above)."""
    B, S, K, G, hd = 1, 64, 2, 2, 16
    q, k, v, do = _capped_inputs(B, S, S, K, G, hd)
    o, lse, want = _vjp_capped(q, k, v, do, causal=True)
    got = jL.fusedkernel_flash_bwd(q, k, v, o, lse, do, 0, causal=True, scale=1 / math.sqrt(hd),
                                   Cq=16, Ck=16, logit_cap=CAP)
    np.testing.assert_allclose(np.asarray(got[2]), np.asarray(want[2]), **TOL)
    for g, w in zip(got[:2], want[:2]):
        g, w = np.asarray(g), np.asarray(w)
        assert np.abs(g - w).max() > 0.1 * np.abs(w).max()
