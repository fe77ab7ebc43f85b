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
hands the kernel (``prepare``: the zero-padding of head dims that are not
built) is fed to the plain version with the kernel's scale.
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


def _ref_regions(q, k, v, do, causal):
    hd = q.shape[-1]
    kw = dict(causal=causal, scale=1 / math.sqrt(hd), Cq=16, Ck=16, logit_cap=0.0)
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
    assert path in PATHS and path == ("direct" if hd in (32, 64, 128) else "pad")
    want = ref.flash_attention_bwd(q, k, v, o, lse, dout, causal=True)
    got = ref.flash_attention_bwd(*prepared[:4], lse, prepared[4], causal=True,
                                  scale=1 / math.sqrt(hd))
    for g, w in zip(got, want):
        torch.testing.assert_close(g[..., :hd], w, rtol=1e-5, atol=1e-5)
        assert not g[..., hd:].any()
