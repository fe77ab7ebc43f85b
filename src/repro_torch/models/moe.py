"""Mixture-of-Experts FFN, one device (the port of the single-device part of
``repro/models/moe.py``).

``moe_ref`` is the reference's exact, dropless form: every expert computed
for every token, the router's top-k weights then picking each token's
outputs.  It is the reference's path on one device, prefill and decode
alike.  The expert-parallel paths (``moe_ep``, ``moe_ep_dedup``) need a
mesh and wait for ROADMAP queue 1, item 9; :func:`moe_apply` raises on a
sharded context.  The reference has no Pallas kernel here, so plain tensor
code is the port.

``coactivation_counts`` and ``dispatch_bytes`` are the routing statistics
that :mod:`repro_torch.core.placement` partitions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import Ctx
from .params import P


def padded_experts(n_experts: int, tp: int) -> int:
    return ((n_experts + tp - 1) // tp) * tp


def moe_params(cfg, tp: int = 1) -> dict:
    d, f = cfg.d_model, cfg.moe_d_ff
    e_pad = padded_experts(cfg.n_experts, tp)
    p = {
        "router": P((d, cfg.n_experts), init="small"),
        "w_gate": P((e_pad, d, f)),
        "w_up": P((e_pad, d, f)),
        "w_down": P((e_pad, f, d)),
    }
    if cfg.n_shared_experts:
        fs = cfg.moe_d_ff * cfg.n_shared_experts
        p["shared"] = {
            "wi_gate": P((d, fs)),
            "wi_up": P((d, fs)),
            "wo": P((fs, d)),
        }
    return p


def _router(p, x2, cfg):
    """x2: (T, D) -> (weights (T, k) in x2's dtype, idx (T, k), aux loss).

    The aux loss is the Switch-style load-balance term.  The expert counts
    are summed with ``index_add_`` (no host read, so a decode step that
    routes stays capturable)."""
    logits = x2.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, cfg.top_k, dim=-1)
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    me = probs.mean(dim=0)                                  # (E,)
    flat = idx.reshape(-1)
    ce = torch.zeros_like(me).index_add_(
        0, flat, torch.ones(flat.shape, dtype=me.dtype, device=me.device)
    ) / (x2.shape[0] * cfg.top_k)
    aux = cfg.n_experts * torch.sum(me * ce)
    return w.to(x2.dtype), idx, aux


def _expert_ffn(w_gate, w_up, w_down, x2, dtype):
    """x2: (T, D), every token to every expert -> (E, T, D).  The tokens
    reach every expert as a stride-0 view: ``torch.matmul`` of a matrix by a
    stack of matrices would copy each expert's weights first."""
    xb = x2.expand(w_gate.shape[0], *x2.shape)
    h = torch.bmm(xb, w_gate.to(dtype))                     # (E, T, F)
    u = torch.bmm(xb, w_up.to(dtype))
    return torch.bmm(F.silu(h) * u, w_down.to(dtype))


def _shared_ffn(ps, x, dtype):
    h = F.silu(x @ ps["wi_gate"].to(dtype)) * (x @ ps["wi_up"].to(dtype))
    return h @ ps["wo"].to(dtype)


def moe_ref(p, x, cfg, ctx: Ctx):
    """Exact (dropless) MoE: every expert computed for every token.
    x: (B, S, D) -> (out (B, S, D), aux loss).

    The reference combines with a one-hot ``(T, k, E)`` einsum; here each
    token gathers its k chosen rows of the all-expert output and sums them
    weighted (``(T, k, D)``), the same sum without a ``(T, k, E, D)``
    intermediate."""
    B, S, D = x.shape
    x2 = x.reshape(B * S, D)
    w, idx, aux = _router(p, x2, cfg)
    all_out = _expert_ffn(p["w_gate"], p["w_up"], p["w_down"], x2, x.dtype)
    tok = torch.arange(x2.shape[0], device=x.device)[:, None]
    out = torch.einsum("tk,tkd->td", w, all_out[idx, tok])
    if cfg.n_shared_experts:
        out = out + _shared_ffn(p["shared"], x2, x.dtype)
    return out.reshape(B, S, D), aux


def moe_apply(p, x, cfg, ctx: Ctx):
    """One device: :func:`moe_ref`, as the reference dispatches there.  A
    context with a "model" mesh axis above 1 asks for the expert-parallel
    paths, which are not ported (ROADMAP queue 1, item 9)."""
    tp = ctx.mesh.shape.get("model", 1) if ctx.mesh is not None else 1
    if tp > 1:
        raise NotImplementedError(
            "expert-parallel MoE (moe_ep, moe_ep_dedup) over a sharded mesh is not "
            "ported yet (ROADMAP queue 1, item 9)")
    return moe_ref(p, x, cfg, ctx)


# ---------------------------------------------------------------------------
# dispatch statistics for the placement objective (core/placement.py)
# ---------------------------------------------------------------------------

def coactivation_counts(idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """idx: (T, k) routed expert ids -> (E, E) f32 co-activation counts.
    Edge weight (i, j) = #tokens routed to both i and j."""
    per_tok = F.one_hot(idx.long(), n_experts).float().sum(dim=1)   # (T, E)
    co = per_tok.T @ per_tok
    return co - torch.diag(torch.diag(co))


def dispatch_bytes(idx: torch.Tensor, expert_to_shard: torch.Tensor, d_model: int,
                   bytes_per: int = 2) -> torch.Tensor:
    """Bytes sent for routing table ``idx`` under an expert->shard placement,
    one send per (token, destination shard); an f32 scalar tensor."""
    shards = expert_to_shard.long()[idx.long()]                    # (T, k)
    n_shards = int(expert_to_shard.max()) + 1
    dest_any = F.one_hot(shards, n_shards).float().sum(dim=1).clamp(0, 1)
    return dest_any.sum() * d_model * bytes_per
