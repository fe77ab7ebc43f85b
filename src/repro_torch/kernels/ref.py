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


def _expand(t: torch.Tensor, G: int) -> torch.Tensor:
    """KV heads repeated for the G query heads of each group."""
    return t.repeat_interleave(G, dim=1) if G > 1 else t


def _scaled(q, k, scale):
    """``q . k`` in f32, divided by ``sqrt(hd)`` or times ``scale``; ``k`` has
    the query heads already."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    return s / math.sqrt(q.shape[-1]) if scale is None else s * scale


def _scores(q, k, causal, kv_len, scale, cap=0.0):
    """Masked logits ``(B, H, Sq, Sk)`` in f32: the scaled dots, capped to
    ``cap tanh(s / cap)`` where ``cap > 0``, then -1e30 where masked (the
    reference caps before it masks).  ``k`` has the query heads already."""
    Sq, Sk = q.shape[2], k.shape[2]
    s = _scaled(q, k, scale)
    if cap > 0:
        s = cap * torch.tanh(s / cap)
    kpos = torch.arange(Sk, device=q.device)
    if causal:
        qpos = torch.arange(Sq, device=q.device)
        s = s.masked_fill(qpos[:, None] < kpos[None, :], NEG_INF)
    if kv_len is not None:
        s = s.masked_fill(kpos >= kv_len, NEG_INF)
    return s


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, kv_len: int | None = None,
                    scale: float | None = None, cap: float = 0.0) -> torch.Tensor:
    """Softmax attention, ``(B, H, Sq, hd)`` queries over ``(B, K, Sk, hd)``
    keys/values with ``K`` dividing ``H`` (query head ``h`` reads KV head
    ``h // (H // K)``; the reference's MHA layout is ``K == H``).

    Logits in f32, divided by ``sqrt(hd)``, or multiplied by ``scale`` where
    one is given (the CUDA kernel's argument: ``1/sqrt`` of the head dim
    before zero-padding); where ``cap > 0`` each scaled logit becomes ``cap
    tanh(s / cap)`` (the reference's ``logit_cap``); the causal mask is top-left
    aligned (``qpos >= kpos``, both from 0); keys at or past ``kv_len`` are
    masked.  Masked logits are -1e30, so a fully masked row averages V.
    The probabilities are rounded to ``v.dtype`` before the product with V;
    the output is in ``q.dtype``."""
    return _attend(q, k, v, causal, kv_len, scale, cap)[0]


def _attend(q, k, v, causal, kv_len, scale, cap):
    """-> (the output, the masked logits)."""
    G = q.shape[1] // k.shape[1]
    s = _scores(q, _expand(k, G), causal, kv_len, scale, cap)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), _expand(v, G)).to(q.dtype), s


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, kv_len: int | None = None,
                        scale: float | None = None, cap: float = 0.0
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention`'s output and each query row's log-sum-exp of
    its masked, scaled (and capped) logits, ``(B, H, Sq)`` f32, as the reference's
    ``_flash_fwd_inner`` returns it: ``m + log(max(l, 1e-30))`` with ``m``
    the row's largest logit and ``l`` the sum of ``exp(s - m)``."""
    o, s = _attend(q, k, v, causal, kv_len, scale, cap)
    m = s.amax(dim=-1)
    l_sum = torch.exp(s - m[..., None]).sum(dim=-1)
    return o, m + torch.log(l_sum.clamp_min(1e-30))


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        lse: torch.Tensor, dout: torch.Tensor, *, causal: bool = True,
                        kv_len: int | None = None, scale: float | None = None,
                        cap: float = 0.0) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients ``(dq, dk, dv)`` of :func:`flash_attention` given its
    output ``o``, the output's gradient ``dout`` and the forward's ``lse``:
    the reference's ``fusedkernel_flash_bwd`` in its two passes, each
    recomputing ``P = exp(s - lse)`` from the saved rows.  ``delta =
    rowsum(dout * o)`` in f32; the dq pass takes ``dS = P (dP - delta) *
    scale`` with ``dP = dout . v``, then ``dq = dS k``; the dk/dv pass
    recomputes P and dS, then ``dk = dS^T q`` and ``dv = P^T dout``, summed
    over the G query heads of each KV head.  P and dS are rounded to the
    input dtype before their products (the reference's ``.astype``); every
    sum is f32; the gradients are in the inputs' dtypes.

    With a cap, ``dS`` also carries the cap's derivative: ``dS = P (dP -
    delta) (1 - t^2) scale`` with ``t = tanh(s scale / cap)`` of every
    pair's unmasked logit.  The reference's ``fusedkernel_flash_bwd`` leaves
    ``1 - t^2`` out (ROADMAP section 3, fault 7); this is the gradient of
    the capped forward."""
    B, H, Sq, hd = q.shape
    Kh, Sk = k.shape[1], k.shape[2]
    G = H // Kh
    sc = 1.0 / math.sqrt(hd) if scale is None else scale
    ke, ve = _expand(k, G), _expand(v, G)
    delta = (dout.float() * o.float()).sum(dim=-1)

    def probs_and_ds():
        p = torch.exp(_scores(q, ke, causal, kv_len, scale, cap) - lse[..., None])
        dp = torch.einsum("bhqd,bhkd->bhqk", dout.float(), ve.float())
        ds = p * (dp - delta[..., None])
        if cap > 0:
            t = torch.tanh(_scaled(q, ke, scale) / cap)
            ds = ds * (1 - t * t)
        return p, ds * sc

    # pass 1: dq
    _, ds = probs_and_ds()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds.to(k.dtype).float(), ke.float())
    # pass 2: dk and dv, P recomputed
    p, ds = probs_and_ds()
    dk = torch.einsum("bhqk,bhqd->bhkd", ds.to(q.dtype).float(), q.float())
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(dout.dtype).float(), dout.float())
    dk = dk.view(B, Kh, G, Sk, hd).sum(dim=2)
    dv = dv.view(B, Kh, G, Sk, hd).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


def wkv6_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
             u: torch.Tensor, do: torch.Tensor, dstate: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, ...]:
    """The gradients ``(dr, dk, dv, dw, du)`` of :func:`wkv6` given the
    outputs' gradient ``do (B, H, S, N)`` and the final state's ``dstate (B,
    H, N, N)`` (``None``: 0), all f32.  With ``G_t`` the gradient of the
    state after step t (``dstate`` at the last step), backwards in time::

        dr_t = (S_{t-1} + (u * k_t) v_t^T) do_t
        dk_t = G_t v_t + u * r_t (v_t . do_t)
        dv_t = G_t^T k_t + do_t (sum_i r_ti u_i k_ti)
        dw_t = rowsum(S_{t-1} * G_t)
        du   = sum over b, t of r_t * k_t (v_t . do_t)
        G_{t-1} = diag(w_t) G_t + r_t do_t^T

    The forward states are kept (no division by w: decays reach 0)."""
    B, H, S, N = r.shape
    r, k, v, w, u, do = (t.float() for t in (r, k, v, w, u, do))
    states = [torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)]
    for t in range(S - 1):  # S_{t-1} for every step t
        states.append(w[:, :, t, :, None] * states[-1]
                      + k[:, :, t, :, None] * v[:, :, t, None, :])
    g = (torch.zeros_like(states[0]) if dstate is None else dstate.float().clone())
    grads = [torch.empty((B, H, S, N), dtype=torch.float32, device=r.device) for _ in range(4)]
    dr, dk, dv, dw = grads
    du = torch.zeros((H, N), dtype=torch.float32, device=r.device)
    for t in reversed(range(S)):
        s_prev = states.pop()
        rt, kt, vt, wt, dot = (x[:, :, t] for x in (r, k, v, w, do))
        vdo = (vt * dot).sum(-1, keepdim=True)                  # (B, H, 1)
        bonus = (rt * u * kt).sum(-1, keepdim=True)
        dr[:, :, t] = torch.einsum("bhij,bhj->bhi", s_prev, dot) + u * kt * vdo
        dk[:, :, t] = torch.einsum("bhij,bhj->bhi", g, vt) + u * rt * vdo
        dv[:, :, t] = torch.einsum("bhij,bhi->bhj", g, kt) + dot * bonus
        dw[:, :, t] = (s_prev * g).sum(-1)
        du += (rt * kt * vdo).sum(0)
        g = wt[..., :, None] * g + rt[..., :, None] * dot[..., None, :]
    return dr, dk, dv, dw, du
