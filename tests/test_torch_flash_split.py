"""K3's ``split`` path (bf16 at a few query rows: the keys of each (batch,
KV head) spread over blocks, then a merge) and its choice by ``prepare``,
against the JAX reference.

The CUDA kernels run only on the card (``chip_smoke.py`` ``[K3]`` and
``[K3-lse]`` hold them to the plain version there, a second launch
bit-equal).  Here ``prepare``'s choice is held at each edge of
``SPLIT_MAX_SQ`` (Sq below, at and above it; head dims 64 and 96, the latter
now built; bf16 and f32), ``split_count``'s rule is held to what the kernel
needs (whole tiles, no empty split, partials small beside the keys), K3b is
held to padding 96 as before, and ``_split_forward`` transcribes the two
kernels into plain PyTorch (the wrapper's split count, each split's tiles of
64 keys with the prefill kernel's masks and -1e30, the online softmax in
base 2, P rounded to the inputs' dtype, the splits past the last key any
row sees neither run nor merged, then the merge in split order): it is held to
``repro.kernels.ref.flash_attention`` (GQA through repeated KV heads) at
K3's tolerances, 2e-5 in f32 and 2e-2 in bf16, and where capped to the
reference's ``fusedkernel_flash_fwd(logit_cap=...)``, output and LSE.
"""

import pytest

torch = pytest.importorskip("torch")

import math

import jax.numpy as jnp
import numpy as np

from repro.kernels import ref as jref
from repro.models import layers as jL
from repro_torch.kernels import ref
from repro_torch.kernels import flash_attention as k3
from repro_torch.kernels import flash_attention_bwd as k3b

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
LOG2E = 1.4426950408889634
NEG_INF = -1e30


def _views(B, H, K, Sq, Sk, hd, dtype, seed, gain=1.0):
    """q (B, H, Sq, hd), k, v (B, K, Sk, hd) as the model's (B, S, heads,
    hd) views, numpy draws cast to ``dtype``; q and k times ``gain``."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, S, n, hd)).astype(np.float32)
               for S, n in ((Sq, H), (Sk, K), (Sk, K)))
    q, k = q * gain, k * gain
    return tuple(torch.from_numpy(a).to(dtype).transpose(1, 2) for a in (q, k, v))


def _split_forward(q, k, v, *, causal, kv_len=None, scale=None, cap=0.0):
    """The split kernel and its merge in plain PyTorch: -> (o, lse).

    Split s of ``split_count`` takes keys [s chunk, (s + 1) chunk) up to the
    last key any row sees (kv_len > 0: kv_len, and Sq where causal; the
    splits past it are neither run nor merged) in tiles
    of ``SPLIT_TILE``; a tile's logits are its dots (capped to tanh(s scale /
    cap) and scaled by cap log2 e, else by scale log2 e), -1e30 where the
    mask drops a key, -inf past the split's last key; m and l run over the
    tiles in base 2, l summing the unrounded p, O the p rounded to the
    inputs' dtype times V.  The merge takes M = max m over the splits and
    sums l and O in split order, each times 2^(m - M)."""
    B, H, Sq, hd = q.shape
    Kh, Sk = k.shape[1], k.shape[2]
    G = H // Kh
    sc = 1.0 / math.sqrt(hd) if scale is None else scale
    kv = Sk if kv_len is None else max(0, min(int(kv_len), Sk))
    n_split, chunk = k3.split_count(G, Sq, Sk)
    k_stop = kv if kv > 0 else Sk
    if causal and kv > 0:
        k_stop = min(k_stop, Sq)
    n_active = -(-k_stop // chunk)
    assert n_active <= n_split
    f32 = torch.float32
    scale_log2 = (cap if cap > 0 else sc) * LOG2E
    ke, ve = (t.repeat_interleave(G, dim=1).float() for t in (k, v))
    qf = q.float()
    qpos = torch.arange(Sq)[:, None]
    parts = []
    for s in range(n_active):
        m = torch.full((B, H, Sq), NEG_INF, dtype=f32)
        l_sum = torch.zeros((B, H, Sq), dtype=f32)
        acc = torch.zeros((B, H, Sq, hd), dtype=f32)
        end = min((s + 1) * chunk, k_stop)
        for k0 in range(s * chunk, end, k3.SPLIT_TILE):
            keys = torch.arange(k0, min(k0 + k3.SPLIT_TILE, end))
            x = torch.einsum("bhqd,bhkd->bhqk", qf, ke[:, :, keys])
            if cap > 0:
                x = torch.tanh(x * (sc / cap))
            valid = keys[None, :] < kv
            if causal:
                valid = valid & (keys[None, :] <= qpos)
            x = torch.where(valid, x * scale_log2, torch.tensor(NEG_INF, dtype=f32))
            m_new = torch.maximum(m, x.amax(-1))
            p = torch.exp2(x - m_new[..., None])
            corr = torch.exp2(m - m_new)
            l_sum = l_sum * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p.to(q.dtype).float(), ve[:, :, keys])
            m = m_new
        parts.append((m, l_sum, acc))
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    L = torch.zeros_like(M)
    O = torch.zeros((B, H, Sq, hd), dtype=f32)
    for m, l_sum, acc in parts:
        w = torch.exp2(m - M)
        L = L + w * l_sum
        O = O + w[..., None] * acc
    o = (O / L.clamp_min(1e-30)[..., None]).to(q.dtype)
    lse = torch.where(M == NEG_INF, M + torch.log(L.clamp_min(1e-30)),
                      (M + torch.log2(L.clamp_min(1e-30))) / LOG2E)
    return o, lse


# -- prepare's choice ---------------------------------------------------------------

@pytest.mark.parametrize("hd", [64, 96])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("sq", [1, k3.SPLIT_MAX_SQ - 1, k3.SPLIT_MAX_SQ, k3.SPLIT_MAX_SQ + 1],
                         ids=["one", "below", "at", "above"])
def test_prepare_takes_split_at_and_below_the_threshold_in_bf16(sq, dtype, hd):
    """bf16 on the model's views takes ``split`` at Sq <= SPLIT_MAX_SQ and
    ``tma`` above it, f32 ``fp32`` either way; head dim 96 is built like 64
    (no copies), and what the kernel reads is the tensors given."""
    x = torch.zeros(2, sq, 8, hd, dtype=dtype)
    q, kv = x.transpose(1, 2), torch.zeros(2, 50, 2, hd, dtype=dtype).transpose(1, 2)
    path, *got = k3.prepare(q, kv, kv)
    want = ("fp32" if dtype == torch.float32
            else "split" if sq <= k3.SPLIT_MAX_SQ else "tma")
    assert path == want and path in k3.PATHS
    assert all(a is b for a, b in zip(got, (q, kv, kv)))


def test_prepare_keeps_copy_and_pad_before_split():
    """A bf16 view TMA cannot address, or a head dim that is not built, at
    one query row takes the path it takes at any Sq (``copy``, ``pad``)."""
    x = torch.randn(1, 1, 2, 256).to(torch.bfloat16)
    strided = x[..., ::2].transpose(1, 2)
    assert k3.prepare(strided, strided, strided)[0] == "copy"
    y = torch.ones(1, 2, 1, 16, dtype=torch.bfloat16)
    path, pq, _, _ = k3.prepare(y, y, y)
    assert path == "pad" and pq.shape[-1] == 32
    z = torch.ones(1, 2, 1, 80, dtype=torch.bfloat16)  # padded up to the built 96
    path, pq, _, _ = k3.prepare(z, z, z)
    assert path == "pad" and pq.shape[-1] == 96 and not pq[..., 80:].any()


def test_k3b_still_pads_head_dim_96():
    """K3b keeps its own built head dims (32, 64, 128): at 96 it pads to 128
    as before, while K3's forward runs 96 as built."""
    assert k3b.HEAD_DIMS == (32, 64, 128) and 96 in k3.HEAD_DIMS
    for dt in (torch.float32, torch.bfloat16):
        t = torch.ones(1, 2, 8, 96, dtype=dt)
        path, got = k3b.prepare(t, t, t, t, t)
        assert path == "pad" and all(g.shape[-1] == 128 for g in got)
        assert k3.prepare(t, t, t)[0] == ("fp32" if dt == torch.float32 else "tma")
    assert k3.built_head_dim(96) == 96 and k3.built_head_dim(96, k3b.HEAD_DIMS) == 128


# -- the split count ----------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 1, 1500), (1, 1, 5), (4, 4, 32768), (4, 3, 777),
                                   (64, 4, 64), (8, 2, 1)],
                         ids=["whisper", "one-head", "long", "ragged", "one-tile", "one-key"])
def test_split_count_takes_whole_tiles_and_no_empty_split(shape):
    """(G, Sq, Sk) -> (n_split, chunk): every key in a split, no split empty,
    a split ceil(rows / 4) whole tiles for an item's rows = min(G Sq,
    SPLIT_ROWS), so its partials (rows x (hd + 2) f32, written and read)
    stay near 1/16 of its K and V bytes at hd 64.
    whisper-large-v3's decode cross-attention (one query over 1500 frames)
    takes 12 splits of one tile."""
    G, Sq, Sk = shape
    n_split, chunk = k3.split_count(G, Sq, Sk)
    rows = min(G * Sq, k3.SPLIT_ROWS)
    assert chunk == k3.SPLIT_TILE * -(-rows // 4) and n_split >= 1
    assert n_split * chunk >= Sk and (n_split - 1) * chunk < Sk
    hd = 64
    assert rows * (hd + 2) * 4 * 2 <= chunk * hd * 2 * 2 / 16 * (hd + 2) / hd
    if shape == (1, 1, 1500):
        assert (n_split, chunk) == (12, 128)


# -- the split and merge against the reference ---------------------------------------

# B, H, K, Sq, Sk, hd, causal, kv_len
SPLIT_CASES = {
    "whisper decode (one query over 1500 frames)": (2, 4, 4, 1, 1500, 64, False, None),
    "kv_len 0: the mean of V": (2, 4, 4, 1, 1500, 64, False, 0),
    "kv_len < Sk: empty splits": (2, 4, 4, 1, 1500, 64, False, 777),
    "causal Sq 3, GQA 8/2": (1, 8, 2, 3, 200, 64, True, None),
    "causal with kv_len < Sq": (1, 8, 2, 4, 200, 32, True, 2),
    "Sq 4 x G 8: two row groups": (1, 16, 2, 4, 300, 96, False, 150),
    "head dim 128, one key": (2, 4, 1, 2, 1, 128, False, None),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_transcription_matches_the_reference(case, dtype):
    B, H, K, Sq, Sk, hd, causal, kv_len = SPLIT_CASES[case]
    dt = getattr(torch, dtype)
    q, k, v = _views(B, H, K, Sq, Sk, hd, dt, seed=Sq * 7 + Sk)
    got, lse = _split_forward(q, k, v, causal=causal, kv_len=kv_len)
    assert tuple(got.shape) == (B, H, Sq, hd) and got.dtype == dt
    G = H // K
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(dtype)
                  for t in (q, k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)))
    want = jref.flash_attention(jq, jk, jv, causal=causal, kv_len=kv_len)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **(BF16 if dtype == "bfloat16" else F32))
    _, want_lse = ref.flash_attention_fwd(q, k, v, causal=causal, kv_len=kv_len)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)


CAP = 5.0


@pytest.mark.parametrize("case", [(1, 1, 1500, 2, 2, 64, False, None),
                                  (2, 4, 200, 2, 4, 32, True, None),
                                  (1, 3, 300, 1, 8, 96, False, 0)],
                         ids=["one-query", "causal-gqa", "kv_len-0"])
def test_capped_split_transcription_matches_fusedkernel_flash_fwd(case):
    """Capped at 5 over q and k 3 times unit normal (logits reach ~15):
    output and LSE against the reference's blockwise forward with
    ``logit_cap``, f32, at the suite's 2e-5."""
    B, Sq, Sk, K, G, hd, causal, kv_len = case
    q, k, v = _views(B, K * G, K, Sq, Sk, hd, torch.float32, seed=Sk + hd, gain=3.0)
    o, lse = _split_forward(q, k, v, causal=causal, kv_len=kv_len, cap=CAP)
    jq = q.transpose(1, 2).reshape(B, Sq, K, G, hd).numpy()
    jo, jlse = jL.fusedkernel_flash_fwd(jq, k.transpose(1, 2).numpy(), v.transpose(1, 2).numpy(),
                                        0, causal=causal, scale=1 / np.sqrt(hd), Cq=Sq, Ck=100,
                                        logit_cap=CAP, kv_len=kv_len)
    np.testing.assert_allclose(o.transpose(1, 2).numpy(),
                               np.asarray(jo).reshape(B, Sq, K * G, hd), **F32)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse).reshape(B, K * G, Sq), **F32)
