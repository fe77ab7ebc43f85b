"""3xTF32, the precision scheme of K3's and K3b's f32 kernels
(``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``), emulated in
plain PyTorch on the CPU and held to the JAX reference.

The kernels run every product of the attention on the tensor cores, which
read an f32 operand only as TF32: its top 19 bits (sign, exponent, 10
mantissa bits).  Each operand x is split into hi = x with its low 13
mantissa bits cleared and lo = the TF32 part of x - hi, and a product is
lo.hi + hi.lo + hi.hi: each term is exact in f32 (two 11-bit significands),
the sums are f32, and the dropped lo.lo is below 2^-20 of the product.  The
emulation splits with the bit mask of the matmul kernel's test
(``tests/test_torch_kernels.py::_tf32``), P like any other operand.

* The forward, S = Q K^T, P = exp(S scale - m), O = P V / l, at head dims
  64 and 128, causal and full, is held to the reference's Pallas kernel in
  interpret mode and to ``repro.kernels.ref.flash_attention`` at the suite's
  f32 tolerance, 2e-5; one pass, hi.hi alone, misses it.
* The backward's five products, S, dP = dO V^T, dq = dS K, dk = dS^T Q and
  dv = P^T dO, from the emulated forward's output and log-sum-exp rows, are
  held to the reference's ``fusedkernel_flash_bwd`` and to ``jax.vjp`` of
  its attention at K3b's f32 tolerance, 1e-4 x max |grad|; one pass misses
  that too.
"""

import pytest

torch = pytest.importorskip("torch")

import math

import jax
import jax.numpy as jnp
import numpy as np

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pl_flash
from repro.models import layers as jL

F32 = dict(rtol=2e-5, atol=2e-5)
NEG_INF = -1e30  # the reference's mask value


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """The top 19 bits of each f32: what the tensor cores read of it."""
    return (x.view(torch.int32) & -8192).view(torch.float32)  # 0xFFFFE000


def _mm(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """``a @ b`` as the kernels' tensor cores compute it: three passes (the
    cross terms, then hi.hi) or one (hi.hi alone)."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    out = a_hi @ b_hi
    if passes == 3:
        out = (_tf32(a - a_hi) @ b_hi + a_hi @ _tf32(b - b_hi)) + out
    return out


def _scores(q, k, causal, passes):
    """The scaled logits (B, H, Sq, Sk), masked ones -1e30; K and V are
    expanded to the query heads."""
    s = _mm(q, k.transpose(-1, -2), passes) * (1.0 / math.sqrt(q.shape[-1]))
    if causal:
        Sq, Sk = s.shape[-2:]
        keep = torch.ones(Sq, Sk, dtype=torch.bool).tril()
        s = s.masked_fill(~keep, NEG_INF)
    return s


def _forward(q, k, v, causal, passes):
    """-> (o, lse) of the emulated kernel."""
    s = _scores(q, k, causal, passes)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l_sum = p.sum(dim=-1, keepdim=True)
    return _mm(p, v, passes) / l_sum, (m + torch.log(l_sum)).squeeze(-1)


def _backward(q, k, v, o, lse, do, causal, passes):
    """-> (dq, dk, dv) of the emulated kernel's five products."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    delta = (do * o).sum(dim=-1, keepdim=True)
    p = torch.exp(_scores(q, k, causal, passes) - lse[..., None])
    dp = _mm(do, v.transpose(-1, -2), passes)
    ds = p * (dp - delta) * scale
    return (_mm(ds, k, passes), _mm(ds.transpose(-1, -2), q, passes),
            _mm(p.transpose(-1, -2), do, passes))


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _misses(got, want, rtol, atol) -> bool:
    return not np.allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("passes", [3, 1])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [64, 128])
def test_3xtf32_forward_meets_the_f32_tolerance_and_1xtf32_does_not(hd, causal, passes):
    q, k, v = (_np((2, 3, 128, hd), seed) for seed in (1, 2, 3))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = np.asarray(jref.flash_attention(jq, jk, jv, causal=causal))
    want_pl = np.asarray(pl_flash(jq, jk, jv, causal=causal, bq=32, bk=32, interpret=True))
    got = _forward(*map(torch.from_numpy, (q, k, v)), causal, passes)[0].numpy()
    if passes == 3:
        np.testing.assert_allclose(got, want, **F32)
        np.testing.assert_allclose(got, want_pl, **F32)
    else:
        assert _misses(got, want, **F32) and _misses(got, want_pl, **F32)


def _grouped_to_bhsd(a):
    """A reference (B, S, K, G, hd) array as the port's (B, H, S, hd) tensor."""
    B, S = a.shape[:2]
    return torch.from_numpy(np.ascontiguousarray(a.reshape(B, S, -1, a.shape[-1])
                                                 .transpose(0, 2, 1, 3)))


@pytest.mark.parametrize("passes", [3, 1])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [64, 128])
def test_3xtf32_backward_meets_the_f32_tolerance_and_1xtf32_does_not(hd, causal, passes):
    """GQA as lm-100m has it, 3 query heads a KV head; the emulation takes
    K and V expanded to the query heads and sums dk, dv over the group."""
    B, S, K, G = 2, 64, 1, 3
    q, do = _np((B, S, K, G, hd), 4), _np((B, S, K, G, hd), 5)
    k, v = _np((B, S, K, hd), 6), _np((B, S, K, hd), 7)
    kw = dict(causal=causal, scale=1 / math.sqrt(hd), Cq=16, Ck=16, logit_cap=0.0, kv_len=None)
    o_ref, lse_ref = jL.fusedkernel_flash_fwd(q, k, v, 0, **kw)
    want_fused = jL.fusedkernel_flash_bwd(q, k, v, o_ref, lse_ref, do, 0, **kw)

    def attend(q_, k_, v_):  # the reference's plain attention, (B, H, S, hd), K and V expanded
        return jref.flash_attention(q_, jnp.repeat(k_, G, axis=1), jnp.repeat(v_, G, axis=1),
                                    causal=causal)

    tq, tdo = _grouped_to_bhsd(q), _grouped_to_bhsd(do)
    tk, tv = (torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1, 3))) for x in (k, v))
    _, vjp = jax.vjp(attend, *(jnp.asarray(t.numpy()) for t in (tq, tk, tv)))
    want_vjp = [np.asarray(g) for g in vjp(jnp.asarray(tdo.numpy()))]

    ke, ve = (t.repeat_interleave(G, dim=1) for t in (tk, tv))
    o, lse = _forward(tq, ke, ve, causal, passes)
    dq, dk, dv = _backward(tq, ke, ve, o, lse, tdo, causal, passes)
    dk, dv = (t.view(B, K, G, S, hd).sum(dim=2) for t in (dk, dv))
    got = [dq.numpy(), dk.numpy(), dv.numpy()]
    fused = [_grouped_to_bhsd(np.asarray(want_fused[0])).numpy()] + [
        np.ascontiguousarray(np.asarray(g).transpose(0, 2, 1, 3)) for g in want_fused[1:]]
    within = []
    for g, w_fused, w_vjp in zip(got, fused, want_vjp):
        for w in (w_fused, w_vjp):
            within.append(np.abs(g - w).max() <= 1e-4 * np.abs(w).max())
    assert all(within) if passes == 3 else not any(within)
