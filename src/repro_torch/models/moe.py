"""Mixture-of-Experts FFN (the port of ``repro/models/moe.py``).

``moe_ref`` is the reference's exact, dropless form: every expert computed
for every token, the router's top-k weights then picking each token's
outputs.  It is the reference's path on one device, prefill and decode
alike.  On a mesh whose "model" axis is above 1, :func:`moe_apply` takes
the reference's expert-parallel paths for a sequence at least that long:
:func:`moe_ep` (capacity buckets, one send per (token, expert)) or
:func:`moe_ep_dedup` (one send per (token, destination rank)), each over
``torch.distributed`` all-to-alls on the "model" axis, each process one
rank holding its blocks as :class:`~.layers.Ctx` sets out; experts are
sharded over "model" (rank m computes experts ``[m E/tp, (m+1) E/tp)`` of
the whole weights every rank holds), and ``expert_perm`` (a placement from
:mod:`repro_torch.core.placement`) maps each logical expert to its physical
slot.  The reference has no Pallas kernel here, so plain tensor code is the
port.

``coactivation_counts`` and ``dispatch_bytes`` are the routing statistics
that :mod:`repro_torch.core.placement` partitions.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..parallel.sharding import dp_axes
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


def _expert_ffn(w_gate, w_up, w_down, xb, dtype):
    """xb: (E, N, D), each expert's rows -> (E, N, D).  ``moe_ref`` hands
    every token to every expert as a stride-0 view: ``torch.matmul`` of a
    matrix by a stack of matrices would copy each expert's weights first."""
    h = torch.bmm(xb, w_gate.to(dtype))                     # (E, N, F)
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
    xb = x2.expand(p["w_gate"].shape[0], *x2.shape)
    all_out = _expert_ffn(p["w_gate"], p["w_up"], p["w_down"], xb, x.dtype)
    tok = torch.arange(x2.shape[0], device=x.device)[:, None]
    out = torch.einsum("tk,tkd->td", w, all_out[idx, tok])
    if cfg.n_shared_experts:
        out = out + _shared_ffn(p["shared"], x2, x.dtype)
    return out.reshape(B, S, D), aux


# ---------------------------------------------------------------------------
# expert parallel over the "model" axis: capacity buckets + all-to-all
# ---------------------------------------------------------------------------

def _local_tokens(x, mesh):
    """The rank's sequence slice of its data block, and the slice's length."""
    tp = mesh.shape["model"]
    B, S, D = x.shape
    if S % tp:
        raise ValueError(f"sequence {S} is not a multiple of the model axis' {tp}")
    m, Sl = mesh.axis_index("model"), S // tp
    return x[:, m * Sl:(m + 1) * Sl], Sl


def _local_experts(p, mesh):
    """The rank's experts: its ``E/tp`` rows of the whole expert weights."""
    tp, m = mesh.shape["model"], mesh.axis_index("model")
    e_pad = p["w_gate"].shape[0]
    if e_pad % tp:
        raise ValueError(f"{e_pad} experts do not shard over the model axis' {tp}")
    e_loc = e_pad // tp
    return [p[k][m * e_loc:(m + 1) * e_loc] for k in ("w_gate", "w_up", "w_down")], e_loc


def _finish(out_loc, aux, x, p, cfg, mesh):
    """All-gather the sequence slices over "model", average the aux loss
    over "model" and then each data axis (the reference's ``pmean``s), add
    the shared experts on the whole data block."""
    out = mesh.all_gather(out_loc, "model", dim=1)
    aux = mesh.pmean(aux, "model")
    for a in dp_axes(mesh):
        aux = mesh.pmean(aux, a)
    if cfg.n_shared_experts:
        B, S, D = x.shape
        out = out + _shared_ffn(p["shared"], x.reshape(-1, D), x.dtype).reshape(B, S, D)
    return out, aux


def _bucket_positions(ids, n: int):
    """ids (N,) in [0, n) -> each entry's position among the earlier entries
    with its id (a cumulative count, as the reference's one-hot cumsum)."""
    oh = F.one_hot(ids.long(), n)
    return (oh.cumsum(0) - oh).gather(1, ids.long()[:, None])[:, 0]


def moe_ep(p, x, cfg, ctx: Ctx, *, capacity_factor: float = 1.25, expert_perm=None):
    """Expert-parallel MoE over "model".  x: the rank's data block (B, S, D),
    replicated over "model"; returns (out (B, S, D), aux), both replicated.

    The rank routes its sequence slice's T tokens; each (token, k) takes
    the next position of its expert's bucket of ``C = max(ceil(T k / E cf),
    4)`` and is dropped at or past C.  One all-to-all sends each expert's
    buckets to the rank that owns it, the rank runs its ``E/tp`` experts
    over the ``tp C`` rows each received, a second all-to-all returns them,
    and each token sums its kept results weighted.  ``expert_perm``
    (logical expert -> physical slot) remaps the router's choices before
    bucketing."""
    mesh = ctx.mesh
    tp = mesh.shape["model"]
    (w_gate, w_up, w_down), e_loc = _local_experts(p, mesh)
    e_pad = e_loc * tp
    x_loc, Sl = _local_tokens(x, mesh)
    B, _, D = x.shape
    dtype = x.dtype
    T, k = B * Sl, cfg.top_k
    x2 = x_loc.reshape(T, D)
    w, idx, aux = _router(p, x2, cfg)
    if expert_perm is not None:
        idx = torch.as_tensor(expert_perm, device=idx.device)[idx]   # logical -> physical
    C = max(int(math.ceil(T * k / e_pad * capacity_factor)), 4)
    flat_e = idx.reshape(-1)                             # (T k,)
    pos = _bucket_positions(flat_e, e_pad)
    keep = pos < C
    slot = torch.where(keep, flat_e * C + pos, e_pad * C)  # a drop -> a spare row
    tok = torch.arange(T, device=x.device).repeat_interleave(k)
    buf = x2.new_zeros(e_pad * C + 1, D)
    buf[slot] = x2[tok]
    # block i of the send buffer holds the buckets of rank i's experts
    recv = mesh.all_to_all(buf[:-1].reshape(tp, e_loc * C, D), "model")
    recv = recv.reshape(tp, e_loc, C, D).transpose(0, 1).reshape(e_loc, tp * C, D)
    out_e = _expert_ffn(w_gate, w_up, w_down, recv, dtype)
    back = out_e.reshape(e_loc, tp, C, D).transpose(0, 1).reshape(tp, e_loc * C, D)
    ret = mesh.all_to_all(back, "model").reshape(e_pad * C, D)
    ret = torch.cat([ret, ret.new_zeros(1, D)])         # a drop reads the zero spare row
    out = (ret[slot] * w.reshape(-1)[:, None]).reshape(T, k, D).sum(1)
    return _finish(out.reshape(B, Sl, D), aux, x, p, cfg, mesh)


def moe_ep_dedup(p, x, cfg, ctx: Ctx, *, expert_perm=None, dest_k: float | None = None,
                 capacity_factor: float = 1.25):
    """Deduplicated-dispatch EP: a token crosses the all-to-all once per
    destination rank, not once per expert; its local expert ids (-1 for
    none) and f32 weights travel beside it, and the weighted combine
    happens on the receiver.  Blocks and returns as :func:`moe_ep`.

    ``dest_k``, the expected distinct destination ranks a token, sizes the
    per-destination capacity ``C_d = max(ceil(T dest_k / tp cf), 4)``; its
    default ``min(k, tp (1 - (1 - 1/tp)^k))`` is a random placement's.  The
    graph-partition placement (``core/placement.py``) co-locates experts
    that fire together and pushes it toward 1-2: the paper's edge cut as
    all-to-all bytes.  The receiver buckets its (row, expert) pairs per
    local expert at ``C_e = max(ceil(T k / E cf) tp, 4)`` and combines in
    f32."""
    mesh = ctx.mesh
    tp = mesh.shape["model"]
    (w_gate, w_up, w_down), e_loc = _local_experts(p, mesh)
    e_pad = e_loc * tp
    k = cfg.top_k
    if dest_k is None:
        dest_k = min(k, tp * (1.0 - (1.0 - 1.0 / tp) ** k))
    x_loc, Sl = _local_tokens(x, mesh)
    B, _, D = x.shape
    dtype, dev = x.dtype, x.device
    T = B * Sl
    x2 = x_loc.reshape(T, D)
    w, idx, aux = _router(p, x2, cfg)
    if expert_perm is not None:
        idx = torch.as_tensor(expert_perm, device=dev)[idx]
    dest = idx // e_loc                                   # (T, k)
    local_e = (idx % e_loc).int()
    Cd = max(int(math.ceil(T * dest_k / tp * capacity_factor)), 4)
    # one row a (token, destination), deduplicated over the token's k
    dest_oh = (F.one_hot(dest.long(), tp).sum(1) > 0).long()   # (T, tp)
    pos = dest_oh.cumsum(0) - dest_oh
    keep = (pos < Cd) & (dest_oh > 0)
    slot = torch.where(keep, torch.arange(tp, device=dev)[None] * Cd + pos, tp * Cd)
    # a spare last row takes what is dropped on the way out and reads 0 on
    # the way back (the reference's out-of-bounds "drop" and "fill")
    xbuf = x2.new_zeros(tp * Cd + 1, D)
    ebuf = torch.full((tp * Cd + 1, k), -1, dtype=torch.int32, device=dev)
    wbuf = torch.zeros(tp * Cd + 1, k, device=dev)
    # expert j of a token belongs in its row for rank dest[t, j]
    mine = dest[:, None, :] == torch.arange(tp, device=dev)[None, :, None]   # (T, tp, k)
    e_entry = torch.where(mine, local_e[:, None, :], -1).int()
    w_entry = torch.where(e_entry >= 0, w[:, None, :].float(), 0.0)
    flat = slot.reshape(-1)
    xbuf[flat] = x2[:, None].expand(T, tp, D).reshape(-1, D)
    ebuf[flat] = e_entry.reshape(-1, k)
    wbuf[flat] = w_entry.reshape(-1, k)
    rows = mesh.all_to_all(xbuf[:-1].reshape(tp, Cd, D), "model").reshape(tp * Cd, D)
    rexp = mesh.all_to_all(ebuf[:-1].reshape(tp, Cd, k), "model").reshape(tp * Cd, k)
    rwgt = mesh.all_to_all(wbuf[:-1].reshape(tp, Cd, k), "model").reshape(tp * Cd, k)
    # bucket the received (row, j) pairs per local expert
    N = tp * Cd
    Ce = max(int(math.ceil(T * k / e_pad * capacity_factor)) * tp, 4)
    flat_e = rexp.reshape(-1).long()                      # (N k,)
    valid = flat_e >= 0
    bpos = _bucket_positions(torch.where(valid, flat_e, e_loc), e_loc + 1)
    bkeep = valid & (bpos < Ce)
    bslot = torch.where(bkeep, flat_e.clamp_min(0) * Ce + bpos, e_loc * Ce)
    rowid = torch.arange(N, device=dev).repeat_interleave(k)
    bbuf = x2.new_zeros(e_loc * Ce + 1, D)
    bbuf[bslot] = rows[rowid]
    out_e = _expert_ffn(w_gate, w_up, w_down, bbuf[:-1].reshape(e_loc, Ce, D), dtype)
    out_e = torch.cat([out_e.reshape(e_loc * Ce, D), out_e.new_zeros(1, D)])
    row_out = (out_e[bslot].float() * rwgt.reshape(-1)[:, None]).reshape(N, k, D).sum(1)
    back = mesh.all_to_all(row_out.reshape(tp, Cd, D).to(dtype), "model")
    ret = torch.cat([back.reshape(N, D), back.new_zeros(1, D)])
    out = ret[flat].reshape(T, tp, D).sum(1).to(dtype)
    return _finish(out.reshape(B, Sl, D), aux, x, p, cfg, mesh)


def moe_apply(p, x, cfg, ctx: Ctx, *, expert_perm=None):
    """Dispatch as the reference does: expert parallel (:func:`moe_ep`, or
    :func:`moe_ep_dedup` under ``ctx.moe_dedup``) on a "model" axis above 1
    for a sequence at least that long; :func:`moe_ref` otherwise, on one
    device and in decode (the reference's decode path: each rank reads the
    whole experts once either way)."""
    tp = ctx.mesh.shape.get("model", 1) if ctx.mesh is not None else 1
    if tp > 1 and x.shape[1] >= tp:
        if ctx.moe_dedup:
            return moe_ep_dedup(p, x, cfg, ctx, expert_perm=expert_perm)
        return moe_ep(p, x, cfg, ctx, expert_perm=expert_perm)
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
