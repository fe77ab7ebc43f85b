"""The port's attention (K3's plain version, the device dispatch, and the
model's ``layers.attention``) against the JAX reference.

The same seeded numpy inputs go through the reference's mathematical
definition (``repro.kernels.ref.flash_attention``), its Pallas kernel in
interpret mode (as ``tests/test_kernels.py`` runs it) and the port.
Tolerances are the reference suite's: 2e-5 in f32 (2e-4 on the small-head
sweeps), 2e-2 in bf16.  The CUDA kernel itself runs only on the card
(``chip_smoke.py`` holds it against the plain version there); here its
wrapper is held to refusing CPU tensors, and what the wrapper hands the
kernel (``prepare``: the path, the copies and the zero-padding of head dims
that are not built) is run on the CPU and fed to the plain version with the
kernel's scale argument.  With a logit cap (5, on inputs scaled so the
logits reach ~15) the plain forward and LSE are held to the reference's
``fusedkernel_flash_fwd``, the model's attention to both branches of the
reference's, and the decode attention to its ``decode_attn_dense``.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pl_flash
from repro.models import layers as jL
from repro.parallel.sharding import TRAIN_RULES
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import (HEAD_DIMS, PATHS, built_head_dim, prepare,
                                                 tma_addressable)
from repro_torch.kernels.flash_attention import flash_attention as cuda_flash
from repro_torch.models import layers as tL
from repro_torch.models.params import params_from_numpy

CPU = torch.device("cpu")
F32 = dict(rtol=2e-5, atol=2e-5)


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=2e-4, atol=2e-4)


def _np(shape, dtype, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return x.astype(jnp.bfloat16) if dtype == "bfloat16" else x


def _t(x):
    return params_from_numpy(x, CPU)


def _f32(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x, np.float32)


def _qkv(B, H, K, Sq, Sk, hd, dtype, seed):
    return (_np((B, H, Sq, hd), dtype, seed), _np((B, K, Sk, hd), dtype, seed + 1),
            _np((B, K, Sk, hd), dtype, seed + 2))


@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("seq", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_ref_and_pallas(causal, seq, dtype, hd):
    q, k, v = _qkv(2, 3, 3, seq, seq, hd, dtype, 0)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    expect_ref = jref.flash_attention(jq, jk, jv, causal=causal)
    expect_pl = pl_flash(jq, jk, jv, causal=causal, bq=32, bk=32, interpret=True)
    for got in (ref.flash_attention(_t(q), _t(k), _t(v), causal=causal),
                ops.flash_attention(_t(q), _t(k), _t(v), causal=causal)):
        assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == q.shape
        np.testing.assert_allclose(_f32(got), _f32(expect_ref), **_tol(dtype))
        np.testing.assert_allclose(_f32(got), _f32(expect_pl), **_tol(dtype))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kv_len_mask(causal):
    q, k, v = _qkv(1, 2, 2, 64, 64, 16, "float32", 3)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal, kv_len=40)
    np.testing.assert_allclose(
        _f32(got), _f32(jref.flash_attention(jq, jk, jv, causal=causal, kv_len=40)), **F32)
    pl = pl_flash(jq, jk, jv, causal=causal, bq=32, bk=32, kv_len=40, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(pl), **F32)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kv_len_zero_gives_the_mean_of_v(causal):
    """Every logit is -1e30, so exp(s - m) is 1 for every key: the reference
    averages V over all Sk (not 0, not NaN)."""
    q, k, v = _qkv(1, 2, 2, 32, 48, 16, "float32", 6)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal, kv_len=0)
    mean = np.broadcast_to(v.mean(axis=2, keepdims=True), q.shape)
    np.testing.assert_allclose(_f32(got), mean, **F32)
    np.testing.assert_allclose(
        _f32(got), _f32(jref.flash_attention(jq, jk, jv, causal=causal, kv_len=0)), **F32)
    if not causal:  # the Pallas kernel skips causal blocks, so only one block agrees
        pl = pl_flash(jq, jk, jv, causal=False, bq=32, bk=16, kv_len=0, interpret=True)
        np.testing.assert_allclose(_f32(got), _f32(pl), **F32)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_cross_shapes(causal):
    """Sq != Sk, with the causal mask top-left aligned (qpos >= kpos)."""
    q, k, v = _qkv(2, 2, 2, 32, 96, 16, "float32", 9)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(
        _f32(got), _f32(jref.flash_attention(jq, jk, jv, causal=causal)), **F32)
    pl = pl_flash(jq, jk, jv, causal=causal, bq=32, bk=32, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(pl), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_gqa_reads_kv_head_h_over_g(dtype):
    """4 query heads over 2 KV heads equal the MHA call with K/V repeated
    as ``jnp.repeat(k, G, axis=1)`` (tests/test_kernels.py's order)."""
    q, k, v = _qkv(2, 4, 2, 64, 64, 16, dtype, 12)
    jq = jnp.asarray(q)
    jk, jv = (jnp.repeat(jnp.asarray(x), 2, axis=1) for x in (k, v))
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=True)
    np.testing.assert_allclose(
        _f32(got), _f32(jref.flash_attention(jq, jk, jv, causal=True)), **_tol(dtype))
    pl = pl_flash(jq, jk, jv, causal=True, bq=32, bk=32, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(pl), **_tol(dtype))


@pytest.mark.parametrize("chunk", [512, 16], ids=["einsum-branch", "flash-branch"])
@pytest.mark.parametrize("seq", [48, 33])
def test_layers_attention_matches_reference_branches(chunk, seq):
    """The model's (B, S, H, hd) attention: the reference's small einsum
    branch and its blockwise flash branch (forced with 16-wide chunks, which
    pads a ragged S) against the port's one K3 call on strided views."""
    B, H, K, hd = 2, 4, 2, 16
    q = _np((B, seq, H, hd), "float32", 20)
    k = _np((B, seq, K, hd), "float32", 21)
    v = _np((B, seq, K, hd), "float32", 22)
    jctx = jL.Ctx(rules=TRAIN_RULES, dtype=jnp.float32, q_chunk=chunk, kv_chunk=chunk)
    expect = jL.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                          ctx=jctx)
    got = tL.attention(_t(q), _t(k), _t(v), causal=True)
    assert tuple(got.shape) == (B, seq, H, hd)
    np.testing.assert_allclose(_f32(got), _f32(expect), **F32)


def test_cpu_tensors_take_the_plain_flash_attention():
    n0 = cuda_flash.launches
    x = torch.ones(1, 2, 8, 16)
    ops.flash_attention(x, x, x)
    assert cuda_flash.launches == n0


def test_flash_kernel_wrapper_refuses_cpu_tensors():
    x = torch.ones(1, 2, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_flash(x, x, x)


def test_flash_kernel_takes_head_dims_32_64_and_128():
    """The served head dims: granite-3-2b's 64, minitron-4b's 128 and
    minicpm3-4b's MLA 96, built since it stopped being padded."""
    assert HEAD_DIMS == (32, 64, 96, 128)


def test_bf16_layout_check_takes_the_models_views_and_refuses_strided_rows():
    """The layout check, ``tma_addressable``, takes what TMA can address: a
    contiguous last dimension, 16-byte-aligned other strides and base.  It
    takes the model's (B, S, H, hd) activations seen as (B, H, S, hd), which
    are read in place (``tma``), and refuses a strided last dimension or a
    misaligned row.  The wrapper does not raise on what it refuses: it
    copies it into the model's layout first (``copy``), with the same
    values."""
    for hd in HEAD_DIMS:
        x = torch.zeros(2, 9, 4, hd, dtype=torch.bfloat16)
        q, kv = x.transpose(1, 2), x[:, :, :2].transpose(1, 2)
        assert tma_addressable(q) and tma_addressable(kv)
        path, *got = prepare(q, kv, kv)
        assert path == "tma" and all(a is b for a, b in zip(got, (q, kv, kv)))
    x = torch.randn(1, 8, 2, 256).to(torch.bfloat16)
    strided = x[..., ::2].transpose(1, 2)
    misaligned = x.view(1, 8, -1)[..., 4:4 + 2 * 128].view(1, 8, 2, 128).transpose(1, 2)
    for bad in (strided, misaligned):
        assert not tma_addressable(bad)
        path, *got = prepare(bad, bad, bad)
        assert path == "copy"
        for t in got:
            assert tma_addressable(t) and t.transpose(1, 2).is_contiguous()
            assert torch.equal(t, bad)


def test_prepare_picks_each_path_from_dtype_head_dim_and_layout():
    assert PATHS[0] == "tma"  # the served (bf16) path first
    x = torch.zeros(1, 2, 8, 64)
    assert prepare(x, x, x)[0] == "fp32"
    assert prepare(x[..., ::2], x[..., ::2], x[..., ::2])[0] == "fp32"  # any strides
    assert prepare(*[x.to(torch.bfloat16)] * 3)[0] == "tma"
    for hd, built in ((4, 32), (16, 32), (33, 64), (80, 96), (100, 128)):
        for dt in (torch.float32, torch.bfloat16):
            y = torch.ones(1, 2, 8, hd, dtype=dt)
            path, q, k, v = prepare(y, y, y)
            assert path == "pad" and q.shape[-1] == built == built_head_dim(hd)
            assert torch.equal(q[..., :hd], y) and not q[..., hd:].any()
    for dt, want in ((torch.float32, "fp32"), (torch.bfloat16, "tma")):  # 96 is built
        y = torch.ones(1, 2, 8, 96, dtype=dt)
        assert prepare(y, y, y)[0] == want and built_head_dim(96) == 96
    with pytest.raises(ValueError, match="up to 128"):
        built_head_dim(160)


@pytest.mark.parametrize("hd", [4, 16, 96, 80])
@pytest.mark.parametrize("causal", [True, False])
def test_padded_head_dim_with_its_scale_equals_plain_and_reference(hd, causal):
    """pad (the wrapper's ``prepare``) -> plain at scale 1/sqrt(hd) -> crop
    equals the plain version on the original head dim, and the reference:
    the zero columns add nothing to Q K^T, and the scale is the caller's.
    A built head dim (96, minicpm3-4b's MLA) passes through unpadded."""
    q, k, v = _qkv(2, 4, 2, 40, 40, hd, "float32", seed=hd)
    tq, tk, tv = map(_t, (q, k, v))
    path, pq, pk, pv = prepare(tq, tk, tv)
    assert path == ("fp32" if hd in HEAD_DIMS else "pad") and pq.shape[-1] == built_head_dim(hd)
    got = ref.flash_attention(pq, pk, pv, causal=causal, kv_len=33,
                              scale=1.0 / np.sqrt(hd))[..., :hd]
    plain = ref.flash_attention(tq, tk, tv, causal=causal, kv_len=33)
    torch.testing.assert_close(got, plain, rtol=1e-6, atol=1e-6)
    expect = jref.flash_attention(*map(jnp.asarray, (q, np.repeat(k, 2, 1), np.repeat(v, 2, 1))),
                                  causal=causal, kv_len=33)
    np.testing.assert_allclose(_f32(got), _f32(expect), **F32)


# ---------------------------------------------------------------------------
# the logit cap
# ---------------------------------------------------------------------------

CAP = 5.0
# inputs x 3: the scaled logits reach ~15, three times the cap, so the tanh
# saturates.  B, Sq, Sk, K (KV heads), G (query heads a KV head), hd, causal,
# kv_len
CAPPED = [
    (2, 32, 32, 2, 2, 16, True, None),
    (1, 48, 32, 1, 4, 32, True, None),    # GQA, Sq > Sk
    (2, 32, 48, 2, 1, 32, False, 40),     # Sq < Sk, kv_len < Sk
    (1, 32, 48, 2, 2, 96, True, None),    # hd 96: built (fp32 here)
    (1, 32, 48, 2, 2, 80, False, 40),     # hd 80: the pad path, up to 96
    (1, 16, 32, 2, 2, 16, False, 0),      # every key masked: the mean of V
]


def _capped_inputs(B, Sq, Sk, K, G, hd, seed):
    """q (B, Sq, K, G, hd), k, v (B, Sk, K, hd) in the reference's grouped
    layout, f32, q and k times 3."""
    rng = np.random.default_rng(seed)
    q = 3 * rng.standard_normal((B, Sq, K, G, hd)).astype(np.float32)
    k = 3 * rng.standard_normal((B, Sk, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sk, K, hd)).astype(np.float32)
    return q, k, v


def _bhsd(a):
    """A reference (B, S, [K, G,] hd) array as the port's (B, H, S, hd) view."""
    B, S = a.shape[:2]
    return torch.from_numpy(np.array(a).reshape(B, S, -1, a.shape[-1])).transpose(1, 2)


@pytest.mark.parametrize("case", CAPPED)
def test_capped_forward_and_lse_match_fusedkernel_flash_fwd(case):
    """The plain capped forward and LSE against the reference's blockwise
    forward with ``logit_cap``, on the inputs as given and on what the
    wrapper hands the kernel (``prepare``: hd 16 and 80 zero-padded to 32 and
    96 with the caller's scale), at the suite's f32 tolerance."""
    B, Sq, Sk, K, G, hd, causal, kv_len = case
    q, k, v = _capped_inputs(B, Sq, Sk, K, G, hd, seed=hd + Sq)
    o, lse = jL.fusedkernel_flash_fwd(q, k, v, 0, causal=causal, scale=1 / np.sqrt(hd), Cq=16,
                                      Ck=16, logit_cap=CAP, kv_len=kv_len)
    o = np.asarray(o).reshape(B, Sq, K * G, hd)
    lse = np.asarray(lse).reshape(B, K * G, Sq)
    tq, tk, tv = map(_bhsd, (q, k, v))
    path, pq, pk, pv = prepare(tq, tk, tv)
    assert path == ("fp32" if hd in HEAD_DIMS else "pad")
    for got_o, got_lse in (ref.flash_attention_fwd(tq, tk, tv, causal=causal, kv_len=kv_len,
                                                   cap=CAP),
                           ref.flash_attention_fwd(pq, pk, pv, causal=causal, kv_len=kv_len,
                                                   scale=1 / np.sqrt(hd), cap=CAP)):
        np.testing.assert_allclose(got_o[..., :hd].transpose(1, 2).numpy(), o, **F32)
        np.testing.assert_allclose(got_lse.numpy(), lse, **F32)
    np.testing.assert_allclose(
        _f32(ops.flash_attention(tq, tk, tv, causal=causal, kv_len=kv_len, cap=CAP)
             .transpose(1, 2)), o, **F32)


@pytest.mark.parametrize("chunk", [16, 4096], ids=["flash-branch", "einsum-branch"])
@pytest.mark.parametrize("seq", [48, 33])
def test_capped_layers_attention_matches_reference_branches(chunk, seq):
    """``L.attention`` with ``logit_cap`` against the reference's in both of
    its branches (the blockwise flash forward with 16-wide chunks, which
    pads a ragged S, and the dense einsum); capped logits differ from the
    uncapped ones far past the tolerance."""
    B, K, G, hd = 2, 2, 2, 16
    q, k, v = _capped_inputs(B, seq, seq, K, G, hd, seed=seq)
    q = q.reshape(B, seq, K * G, hd)
    jctx = jL.Ctx(rules=TRAIN_RULES, dtype=jnp.float32, q_chunk=chunk, kv_chunk=chunk)
    expect = jL.attention(*map(jnp.asarray, (q, k, v)), causal=True, ctx=jctx, logit_cap=CAP)
    got = tL.attention(_t(q), _t(k), _t(v), causal=True, logit_cap=CAP)
    np.testing.assert_allclose(_f32(got), _f32(expect), **F32)
    uncapped = tL.attention(_t(q), _t(k), _t(v), causal=True)
    assert np.abs(_f32(uncapped) - _f32(expect)).max() > 100 * F32["atol"]


@pytest.mark.parametrize("cap", [0.0, 0.5, CAP])
@pytest.mark.parametrize("G", [1, 4])
def test_decode_attn_dense_matches_the_reference(cap, G):
    """One query against a cache written at ``pos``, the logits capped (0:
    not) before the mask, as the reference's ``decode_attn_dense``; the
    caches come back written in place."""
    B, S, K, hd, pos = 2, 24, 2, 16, 13
    rng = np.random.default_rng(G)
    q = 3 * rng.standard_normal((B, K * G, hd)).astype(np.float32)
    ck = 3 * rng.standard_normal((B, S, K, hd)).astype(np.float32)
    cv = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    kn = 3 * rng.standard_normal((B, K, hd)).astype(np.float32)
    vn = rng.standard_normal((B, K, hd)).astype(np.float32)
    want, (wk, wv) = jL.decode_attn_dense(*map(jnp.asarray, (q, ck, cv, kn, vn)),
                                          jnp.int32(pos), logit_cap=cap)
    tk, tv = _t(ck), _t(cv)
    got, (gk, gv) = tL.decode_attn_dense(_t(q), tk, tv, _t(kn), _t(vn), torch.tensor([pos]),
                                         logit_cap=cap)
    assert gk is tk and gv is tv
    np.testing.assert_allclose(_f32(got), _f32(want), **F32)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
