"""Plain PyTorch versions of the hand-written kernels (the allclose targets).

Each function is the mathematical definition with the JAX package's
semantics (``repro/kernels/ref.py``).  :mod:`repro_torch.kernels.ops` runs
them for tensors on the CPU; the tests and ``chip_smoke.py`` hold the CUDA
kernels against them on the card.
"""

from __future__ import annotations

import math

import torch


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` accumulated in float32, cast to ``a.dtype``."""
    return torch.matmul(a.to(torch.float32), b.to(torch.float32)).to(a.dtype)


def matadd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise ``a + b`` in the input dtype."""
    return a + b


NEG_INF = -1e30  # the reference's mask value: a fully masked row stays finite


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, kv_len: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """Softmax attention, ``(B, H, Sq, hd)`` queries over ``(B, K, Sk, hd)``
    keys/values with ``K`` dividing ``H`` (query head ``h`` reads KV head
    ``h // (H // K)``; the reference's MHA layout is ``K == H``).

    Logits in f32, divided by ``sqrt(hd)``, or multiplied by ``scale`` where
    one is given (the CUDA kernel's argument: ``1/sqrt`` of the head dim
    before zero-padding); the causal mask is top-left
    aligned (``qpos >= kpos``, both from 0); keys at or past ``kv_len`` are
    masked.  Masked logits are -1e30, so a fully masked row averages V.
    The probabilities are rounded to ``v.dtype`` before the product with V;
    the output is in ``q.dtype``."""
    B, H, Sq, hd = q.shape
    Sk = k.shape[2]
    G = H // k.shape[1]
    if G > 1:
        k = k.repeat_interleave(G, dim=1)
        v = v.repeat_interleave(G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    s = s / math.sqrt(hd) if scale is None else s * scale
    kpos = torch.arange(Sk, device=q.device)
    if causal:
        qpos = torch.arange(Sq, device=q.device)
        s = s.masked_fill(qpos[:, None] < kpos[None, :], NEG_INF)
    if kv_len is not None:
        s = s.masked_fill(kpos >= kv_len, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v).to(q.dtype)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 recurrence.  r/k/v/w: ``(B, H, S, N)``; u: ``(H, N)``.
    Per step ``o_t = r_t (S + (u * k_t) v_t^T)``, ``S <- diag(w_t) S + k_t v_t^T``
    from ``S = 0`` in f32.  Returns the ``(B, H, S, N)`` outputs (in
    ``r.dtype``) and the final ``(B, H, N, N)`` state [k-index, v-index]."""
    B, H, S, N = r.shape
    state = torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
    outs = []
    for t in range(S):
        kv = k[:, :, t, :, None] * v[:, :, t, None, :]
        outs.append(torch.einsum("bhk,bhkn->bhn", r[:, :, t], state + u[..., :, None] * kv))
        state = w[:, :, t, :, None] * state + kv
    o = torch.stack(outs, dim=2) if outs else torch.empty_like(r)
    return o.to(r.dtype), state
