"""Shared transformer layers: norms, rotary embeddings, the dense MLP, GQA
attention and MLA (the port of ``repro/models/layers.py``).

All functions take ``params`` (nested dicts of tensors) and activations and
return tensors; parameter builders return :class:`~.params.P` spec trees.
On a mesh each process runs them on its own blocks (:class:`Ctx`).
Prefill and training attention is K3
(:func:`repro_torch.kernels.ops.flash_attention`): the hand-written CUDA
kernel on the card, its plain version on the CPU; under autograd its
gradient is K3b (:class:`repro_torch.kernels.ops.FlashAttention`), on the
CPU too through the plain versions, as the reference's ``custom_vjp``.
Decode attention (one new token against the cache) has no TPU kernel in the
reference and stays plain tensor code, on one device and sequence-parallel
over a mesh (:func:`decode_attn_seqpar`, ``torch.distributed``
collectives); so does MLA's absorbed-weight decode.
A model's ``attn_logit_softcap`` caps the GQA block's logits, in prefill,
training and decode, as the reference's ``attn_block`` and
``attn_decode_block`` do; MLA and cross-attention take no cap there.

Weights are cast to the activation dtype at each use, as in the reference
(``p["wq"].to(x.dtype)``); a tree cast once at load
(:func:`~.params.cast_params`) makes those casts no-ops with the same bits.
Norms and rope compute in f32, as the reference does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels import ops
from .params import P

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class Ctx:
    """Execution context: the activation dtype, the device mesh, the
    decode and MoE strategies on it, and whether training rematerializes
    each unit and each CE chunk (``remat``, the reference's
    ``jax.checkpoint``; it changes no value).

    ``mesh`` is ``None`` on one device, or a
    :class:`~repro_torch.launch.mesh.Mesh` with axes ("data", "model")
    (``mesh.shape`` maps axis names to sizes), each process one rank of it.
    Tensors go in and out of the model in SPMD form, each rank holding its
    own block of what the reference's ``shard_map`` would see whole:

    - activations are the rank's data block of the batch (over the data
      axes that divide it, :func:`repro_torch.parallel.sharding.batch_block`),
      replicated over "model" within it;
    - parameters are whole on every rank;
    - the expert-parallel MoE (:func:`repro_torch.models.moe.moe_ep`,
      ``moe_ep_dedup``, chosen by :func:`~repro_torch.models.moe.moe_apply`
      when "model" is above 1 and the sequence at least as long) routes the
      rank's slice ``x[:, m S/tp:(m+1) S/tp]`` of its data block (rank m of
      tp along "model", the reference's ``PS(bspec, "model")``) and
      all-gathers the output over "model" before it returns;
    - with ``decode_seqpar``, decode attention
      (:func:`decode_attn_seqpar`) holds each attention cache as the
      rank's ``(batch block, S/tp)`` shard
      (:func:`repro_torch.models.transformer.shard_caches`) and returns its
      updated shard and the whole output of its batch block.

    ``moe_dedup`` sends a token once per destination rank, not once per
    expert (the reference's field).  The reference's ``moe_dest_k`` is not
    taken: no entry point builds a mesh yet (ROADMAP queue 1, item 9), and
    the dedup path sizes its buffers by its default.  The reference's attention chunk sizes are not taken: they
    pick one of two attention branches that compute the same function, and
    the port sends both to one K3 call."""

    dtype: torch.dtype = torch.bfloat16
    mesh: Any = None
    decode_seqpar: bool = False        # shard each attention cache's sequence over "model"
    remat: bool = True
    moe_dedup: bool = False            # dedup EP dispatch (one send per shard)


def _remat(ctx: Ctx) -> bool:
    """Rematerialize in the backward: asked for, and a backward can follow."""
    return ctx.remat and torch.is_grad_enabled()


def _checkpoint(fn, *args):
    """``fn(*args)`` with its activations recomputed in the backward instead
    of kept (no random numbers are drawn, so no RNG state is saved)."""
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_params(d: int) -> dict:
    return {"scale": P((d,), init="ones")}


def rmsnorm(p, x, eps: float = 1e-5):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions broadcasts against the sequence dim:
    shape (S,) or (B, S).  Rotate-half convention, in f32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    ang = positions[..., None].float() * freqs         # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                  # over the head axis
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# dense MLP (SwiGLU)
# ---------------------------------------------------------------------------

def mlp_params(d: int, d_ff: int) -> dict:
    return {
        "wi_gate": P((d, d_ff)),
        "wi_up": P((d, d_ff)),
        "wo": P((d_ff, d)),
    }


def mlp(p, x, ctx: Ctx):
    h = x @ p["wi_gate"].to(x.dtype)
    u = x @ p["wi_up"].to(x.dtype)
    return (F.silu(h) * u) @ p["wo"].to(x.dtype)


# ---------------------------------------------------------------------------
# attention (K3)
# ---------------------------------------------------------------------------

def attention(q, k, v, *, causal: bool, logit_cap: float = 0.0):
    """q: (B, Sq, H, hd); k, v: (B, Sk, K, hd) with H = K * G.  One K3 call on
    (B, heads, S, hd) views: no transposed copies, no K/V repeat; under
    autograd its backward is one K3b call.  ``logit_cap > 0`` caps each
    scaled logit to ``cap tanh(s / cap)`` before the mask, as the
    reference's.  The reference's query offset is not taken: every caller
    of the port attends from position 0."""
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                            causal=causal, cap=logit_cap)
    return o.transpose(1, 2)


# ---------------------------------------------------------------------------
# GQA attention block (attn mixer)
# ---------------------------------------------------------------------------

def attn_params(cfg) -> dict:
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {
        "wq": P((d, H, hd)),
        "wk": P((d, K, hd)),
        "wv": P((d, K, hd)),
        "wo": P((H, hd, d)),
    }
    if cfg.qkv_bias:
        p["bq"] = P((H, hd), init="zeros")
        p["bk"] = P((K, hd), init="zeros")
        p["bv"] = P((K, hd), init="zeros")
    return p


def _proj(x, w):
    """x (B, S, d) @ w (d, heads, hd) -> (B, S, heads, hd)."""
    d, heads, hd = w.shape
    return (x @ w.to(x.dtype).reshape(d, heads * hd)).view(*x.shape[:-1], heads, hd)


def _out(o, w, dtype):
    """o (B, S, heads, hd) @ w (heads, hd, d) -> (B, S, d)."""
    heads, hd, d = w.shape
    return o.reshape(*o.shape[:-2], heads * hd) @ w.to(dtype).reshape(heads * hd, d)


def _qkv(p, x, cfg, ctx: Ctx):
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return q, k, v


def attn_block(p, x, cfg, ctx: Ctx, *, positions, causal=True):
    """Full-sequence attention (prefill).  positions: (S,) or (B, S).
    Returns (out, (k, v)) — the cache-ready keys/values."""
    q, k, v = _qkv(p, x, cfg, ctx)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = attention(q, k, v, causal=causal, logit_cap=cfg.attn_logit_softcap)
    return _out(o, p["wo"], x.dtype), (k, v)


# ---------------------------------------------------------------------------
# decode attention (one new token against a cache)
# ---------------------------------------------------------------------------

def decode_attn_dense(q, ck, cv, k_new, v_new, pos: torch.Tensor, *, logit_cap: float = 0.0):
    """q: (B, H, hd); caches (B, S, K, hd); pos: write position of the new
    token, a one-element ``long`` tensor on the caches' device.  The caches
    are updated in place (the serving loop owns them) and returned.
    ``logit_cap > 0`` caps each scaled logit to ``cap tanh(s / cap)``
    before the mask, as the reference's.

    The position is never read on the host (``index_copy_`` writes at it,
    a comparison against ``arange`` masks past it), and the cap is a Python
    float, so the step can be captured into a CUDA graph (which bakes the
    cap in) and replayed with the position advanced on the card."""
    B, S, K, hd = ck.shape
    H = q.shape[1]
    G = H // K
    ck.index_copy_(1, pos, k_new[:, None].to(ck.dtype))
    cv.index_copy_(1, pos, v_new[:, None].to(cv.dtype))
    qg = q.reshape(B, K, G, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qg.float(), ck.float()) / math.sqrt(hd)
    if logit_cap > 0:
        s = logit_cap * torch.tanh(s / logit_cap)
    s = s.masked_fill(torch.arange(S, device=s.device) > pos, NEG_INF)
    p = torch.softmax(s, dim=-1).to(cv.dtype)
    o = torch.einsum("bkgs,bskh->bkgh", p, cv)
    return o.reshape(B, H, hd).to(q.dtype), (ck, cv)


def decode_attn_seqpar(q, ck, cv, k_new, v_new, pos: torch.Tensor, *, ctx: Ctx,
                       logit_cap: float = 0.0):
    """Flash decode over a cache whose sequence is sharded over "model":
    q (B, H, hd) and the new k, v (B, K, hd) of the rank's batch block;
    ck, cv (B, S/tp, K, hd), the rank's shard of positions
    ``[m S/tp, (m+1) S/tp)``.  Each rank scores its shard (a partial
    softmax), and the global max, the sums of the weights and the weighted
    values are combined over "model"; only the (B, H, hd) partials cross
    between ranks, not the cache.  Returns (o (B, H, hd), (ck, cv)).

    The new key and value are written at ``pos`` (a one-element ``long``
    tensor) only on the rank that owns it, in place, as
    :func:`decode_attn_dense` writes (no host read); positions past
    ``pos`` are masked."""
    mesh = ctx.mesh
    B, S_loc, K, hd = ck.shape
    H = q.shape[1]
    G = H // K
    off = mesh.axis_index("model") * S_loc
    lpos = pos - off
    owned = ((lpos >= 0) & (lpos < S_loc)).view(1, 1, 1, 1)
    li = lpos.clamp(0, S_loc - 1)
    ck.index_copy_(1, li, torch.where(owned, k_new[:, None].to(ck.dtype), ck.index_select(1, li)))
    cv.index_copy_(1, li, torch.where(owned, v_new[:, None].to(cv.dtype), cv.index_select(1, li)))
    qg = q.reshape(B, K, G, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qg.float(), ck.float()) / math.sqrt(hd)
    if logit_cap > 0:
        s = logit_cap * torch.tanh(s / logit_cap)
    s = s.masked_fill(off + torch.arange(S_loc, device=s.device) > pos, NEG_INF)
    m = mesh.pmax(s.amax(dim=-1), "model")
    pexp = torch.exp(s - m[..., None])
    l_sum = mesh.psum(pexp.sum(dim=-1), "model")
    o = torch.einsum("bkgs,bskh->bkgh", pexp.to(cv.dtype).float(), cv.float())
    o = mesh.psum(o, "model") / l_sum.clamp_min(1e-30)[..., None]
    return o.reshape(B, H, hd).to(q.dtype), (ck, cv)


def attn_decode_block(p, x, cfg, ctx: Ctx, *, cache, pos: torch.Tensor):
    """x: (B, 1, d).  cache: {"k": (B,S,K,hd), "v": ...}, each the rank's
    sequence shard under ``ctx.decode_seqpar`` on a "model" axis above 1
    (:func:`decode_attn_seqpar`); pos: a one-element ``long`` tensor.
    Returns (out (B,1,d), cache)."""
    q, k, v = _qkv(p, x, cfg, ctx)               # (B,1,H,hd)/(B,1,K,hd)
    posv = pos.view(1, 1).expand(x.shape[0], 1)
    q = apply_rope(q, posv, cfg.rope_theta)[:, 0]
    k = apply_rope(k, posv, cfg.rope_theta)[:, 0]
    if ctx.decode_seqpar and ctx.mesh is not None and ctx.mesh.shape.get("model", 1) > 1:
        o, (ck, cv) = decode_attn_seqpar(q, cache["k"], cache["v"], k, v[:, 0], pos, ctx=ctx,
                                         logit_cap=cfg.attn_logit_softcap)
    else:
        o, (ck, cv) = decode_attn_dense(q, cache["k"], cache["v"], k, v[:, 0], pos,
                                        logit_cap=cfg.attn_logit_softcap)
    return _out(o, p["wo"], x.dtype)[:, None], {"k": ck, "v": cv}


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, MiniCPM3 / DeepSeek-V2 style)
# ---------------------------------------------------------------------------

def mla_params(cfg) -> dict:
    d, H = cfg.d_model, cfg.n_heads
    r_kv, r_q = cfg.kv_lora_rank, cfg.q_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "wq_a": P((d, r_q)),
        "q_norm": rmsnorm_params(r_q),
        "wq_b": P((r_q, H, dn + dr)),
        "wkv_a": P((d, r_kv + dr)),
        "kv_norm": rmsnorm_params(r_kv),
        "wk_b": P((r_kv, H, dn)),
        "wv_b": P((r_kv, H, dv)),
        "wo": P((H, dv, d)),
    }


def _mla_q(p, x, cfg, ctx: Ctx, positions):
    dn = cfg.qk_nope_dim
    ql = rmsnorm(p["q_norm"], x @ p["wq_a"].to(x.dtype), cfg.norm_eps)
    q = _proj(ql, p["wq_b"])
    q_rope = apply_rope(q[..., dn:], positions, cfg.rope_theta)
    return q[..., :dn], q_rope


def _mla_latent(p, x, cfg, ctx: Ctx, positions):
    r_kv = cfg.kv_lora_rank
    kv = x @ p["wkv_a"].to(x.dtype)
    latent = rmsnorm(p["kv_norm"], kv[..., :r_kv], cfg.norm_eps)
    # k_rope is a single shared rope head: (B, S, dr) -> (B, S, 1, dr)
    k_rope = apply_rope(kv[..., None, r_kv:], positions, cfg.rope_theta)[..., 0, :]
    return latent, k_rope


def mla_block(p, x, cfg, ctx: Ctx, *, positions):
    """Prefill MLA: K and V expanded from the latent, one K3 call at head dim
    ``qk_nope + qk_rope`` (v zero-padded up to it and the output cropped,
    as in the reference).  Returns (out, (latent, k_rope)) for caching."""
    B, S, _ = x.shape
    H, dn, dr, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q_nope, q_rope = _mla_q(p, x, cfg, ctx, positions)
    latent, k_rope = _mla_latent(p, x, cfg, ctx, positions)
    k_nope = _proj(latent, p["wk_b"])
    v = _proj(latent, p["wv_b"])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None].expand(B, S, H, dr)], dim=-1)
    o = attention(q, k, F.pad(v, (0, dn + dr - dv)), causal=True)[..., :dv]
    return _out(o, p["wo"], x.dtype), (latent, k_rope)


def mla_decode_block(p, x, cfg, ctx: Ctx, *, cache, pos: torch.Tensor):
    """Absorbed-weight MLA decode: the query scored in latent space against
    the compact cache {"latent": (B, S, r_kv), "k_rope": (B, S, dr)}, which
    is written at ``pos`` (a one-element ``long`` tensor) in place and
    returned; like :func:`decode_attn_dense`, nothing is read on the host."""
    B = x.shape[0]
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    posv = pos.view(1, 1).expand(B, 1)
    q_nope, q_rope = _mla_q(p, x, cfg, ctx, posv)          # (B, 1, H, .)
    latent_new, k_rope_new = _mla_latent(p, x, cfg, ctx, posv)
    cl, cr = cache["latent"], cache["k_rope"]
    cl.index_copy_(1, pos, latent_new.to(cl.dtype))
    cr.index_copy_(1, pos, k_rope_new.to(cr.dtype))
    S = cl.shape[1]
    # absorb wk_b into the query: q_lat (B, H, r_kv)
    q_lat = torch.einsum("bhk,rhk->bhr", q_nope[:, 0], p["wk_b"].to(x.dtype))
    s = (torch.einsum("bhr,bsr->bhs", q_lat.float(), cl.float())
         + torch.einsum("bhk,bsk->bhs", q_rope[:, 0].float(), cr.float())) * (
        1.0 / math.sqrt(dn + dr))
    s = s.masked_fill(torch.arange(S, device=s.device) > pos, NEG_INF)
    w = torch.softmax(s, dim=-1).to(x.dtype)
    o_lat = torch.einsum("bhs,bsr->bhr", w, cl.to(x.dtype))
    o = torch.einsum("bhr,rhk->bhk", o_lat, p["wv_b"].to(x.dtype))
    return _out(o, p["wo"], x.dtype)[:, None], {"latent": cl, "k_rope": cr}
