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
from typing import Any, Mapping

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels import ops
from ..parallel import sharding as shd
from .params import P

NEG_INF = -1e30


# logical axes whose blocks the model computes on where they lie (tensor,
# expert and vocab parallelism); every other sharded dimension of a weight
# is gathered before use (FSDP)
LOCAL_AXES = frozenset({"heads", "kv_heads", "mlp", "rwkv_heads", "mamba_inner", "experts",
                        "vocab"})


@dataclasses.dataclass(frozen=True)
class Ctx:
    """Execution context: the activation dtype, the device mesh and the
    logical-axis rules on it, the decode and MoE strategies, and whether
    training rematerializes each unit and each CE chunk (``remat``, the
    reference's ``jax.checkpoint``; it changes no value).

    ``mesh`` is ``None`` on one device, or a
    :class:`~repro_torch.launch.mesh.Mesh` (``mesh.shape`` maps axis names
    to sizes), each process one rank of it, with the ``rules`` of the phase
    (:func:`repro_torch.launch.steps.make_ctx`).  Tensors go in and out of
    the model in SPMD form, each rank holding its own blocks: every
    parameter is the rank's block under
    :func:`repro_torch.parallel.sharding.spec_for` of its logical axes, and
    the model computes as the reference's rule sets lay it out:

    - activations are the rank's data block of the batch, replicated over
      "model", or under sequence parallelism (``rules["seq"] == "model"``)
      its slice of the sequence (:meth:`cs`);
    - attention, MLA, the MLP, RWKV-6 and Mamba run on the rank's heads,
      ``mlp`` or ``mamba_inner`` block (Megatron): the input is whole (under
      sequence parallelism all-gathered over "model"), the row-parallel
      output is summed over "model" (reduce-scattered over the sequence
      under sequence parallelism); in decode too;
    - the embedding and the LM head are vocab-parallel;
    - a weight's other sharded dimensions (FSDP's ``embed_fsdp``) are
      all-gathered per layer before use (:meth:`gather_params`); expert
      weights stay sharded: the expert-parallel MoE
      (:func:`repro_torch.models.moe.moe_ep`, ``moe_ep_dedup``, chosen by
      :func:`~repro_torch.models.moe.moe_apply` when "model" is above 1 and
      the sequence at least as long) routes the rank's slice
      ``x[:, m S/tp:(m+1) S/tp]`` of its data block over its own ``E/tp``
      experts and all-gathers the output over "model";
    - with ``decode_seqpar`` (``DECODE_RULES``' ``cache_seq``), each
      attention cache is the rank's ``(batch block, S/tp)`` sequence shard
      holding every key/value head, and decode attention
      (:func:`decode_attn_seqpar`, MLA's :func:`mla_decode_block`) gathers
      the rank's query heads over "model", attends over its shard and
      combines the partial softmaxes; without it the caches hold the rank's
      heads, whole along the sequence.

    ``moe_dedup`` sends a token once per destination rank, not once per
    expert, and ``moe_dest_k`` (the expected distinct destination ranks of
    a token) sizes that path's buffers (the reference's fields).  The
    reference's attention chunk sizes are not taken: they pick one of two
    attention branches that compute the same function, and the port sends
    both to one K3 call."""

    dtype: torch.dtype = torch.bfloat16
    mesh: Any = None
    decode_seqpar: bool = False        # each attention cache's sequence over "model"
    remat: bool = True
    moe_dedup: bool = False            # dedup EP dispatch (one send per shard)
    rules: Mapping[str, object] | None = None
    moe_dest_k: float | None = None    # expected distinct dest shards/token

    def __post_init__(self):
        if self.mesh is not None and self.rules is None:
            raise ValueError("a Ctx on a mesh needs the rules that lay out its parameters")

    @property
    def tp(self) -> int:
        """The size of the "model" axis (1 on one device)."""
        return self.mesh.shape.get("model", 1) if self.mesh is not None else 1

    @property
    def seq_parallel(self) -> bool:
        """Activations hold the rank's slice of the sequence over "model"."""
        return self.tp > 1 and self.rules.get("seq") == "model"

    @property
    def seq_sharded_cache(self) -> bool:
        """Each attention cache is the rank's shard of the sequence."""
        return self.decode_seqpar and self.tp > 1

    def tp_sharded(self, name: str, size: int) -> bool:
        """A dimension of logical axis ``name`` and ``size`` is split over
        "model" (the rank computes on its block of it)."""
        return (self.tp > 1
                and shd.spec_for((name,), self.rules, self.mesh, (size,)) == ("model",))

    def cs(self, x, *axes):
        """``x`` (whole but for its batch block) to the layout ``axes``
        have under the rules: the rank's block of each dimension they shard
        (:func:`repro_torch.parallel.sharding.constraint`)."""
        if self.mesh is None or self.mesh.size == 1:
            return x
        return shd.constraint(x, axes, self.rules, self.mesh)

    def gather_params(self, p, specs):
        """The layer's weights ``p`` with every sharded dimension whose
        logical axis is not computed on locally (:data:`LOCAL_AXES`: FSDP's
        ``embed_fsdp``, over "model" and, for a config with ``fsdp``, over
        "data") all-gathered; ``specs`` is the layer's :class:`P` tree.  The
        gathers' backward reduce-scatters the gradients (ZeRO-3)."""
        if self.mesh is None or self.mesh.size == 1:
            return p
        if isinstance(p, dict):
            return {k: self.gather_params(v, specs[k]) for k, v in p.items()}
        spec = shd.spec_for(specs.axes, self.rules, self.mesh, specs.shape)
        dims = [i for i, e in enumerate(spec) if e is not None and specs.axes[i] not in LOCAL_AXES]
        return shd.gather(p, spec, self.mesh, dims) if dims else p

    def seq_in(self, x):
        """Into a tensor-parallel region: the whole sequence of ``x``
        (all-gathered over "model" under sequence parallelism)."""
        return self.mesh.all_gather(x, "model", 1) if self.seq_parallel else x

    def seq_out(self, y, partial: bool):
        """Out of a tensor-parallel region: ``y`` is the whole sequence,
        ``partial`` when it is this rank's term of a sum over "model".
        Returns the sum (reduce-scattered over the sequence under sequence
        parallelism), or under sequence parallelism the rank's slice."""
        if self.seq_parallel:
            if partial:
                return self.mesh.psum_scatter(y, "model", 1)
            return shd.block(y, (None, "model"), self.mesh)
        return self.mesh.psum(y, "model") if partial else y


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
    return {"scale": P((d,), (None,), init="ones")}


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
        "wi_gate": P((d, d_ff), ("embed_fsdp", "mlp")),
        "wi_up": P((d, d_ff), ("embed_fsdp", "mlp")),
        "wo": P((d_ff, d), ("mlp", "embed_fsdp")),
    }


def mlp(p, x, ctx: Ctx, d_ff: int | None = None):
    """SwiGLU.  ``d_ff``, the hidden width of the whole weights, says
    whether ``p`` holds the rank's ``mlp`` block (column-parallel in,
    row-parallel out, :meth:`Ctx.seq_out`); without it the weights are
    whole."""
    partial = d_ff is not None and ctx.tp_sharded("mlp", d_ff)
    x = ctx.seq_in(x)
    h = x @ p["wi_gate"].to(x.dtype)
    u = x @ p["wi_up"].to(x.dtype)
    return ctx.seq_out((F.silu(h) * u) @ p["wo"].to(x.dtype), partial)


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
        "wq": P((d, H, hd), ("embed_fsdp", "heads", "head_dim")),
        "wk": P((d, K, hd), ("embed_fsdp", "kv_heads", "head_dim")),
        "wv": P((d, K, hd), ("embed_fsdp", "kv_heads", "head_dim")),
        "wo": P((H, hd, d), ("heads", "head_dim", "embed_fsdp")),
    }
    if cfg.qkv_bias:
        p["bq"] = P((H, hd), ("heads", "head_dim"), init="zeros")
        p["bk"] = P((K, hd), ("kv_heads", "head_dim"), init="zeros")
        p["bv"] = P((K, hd), ("kv_heads", "head_dim"), init="zeros")
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


def _heads_sharded(cfg, ctx: Ctx) -> bool:
    """The attention weights hold the rank's query and key/value heads
    (both split over "model", or neither: ``pad_for_tp`` makes both
    divide)."""
    q = ctx.tp_sharded("heads", cfg.n_heads)
    if q != ctx.tp_sharded("kv_heads", cfg.n_kv_heads):
        raise ValueError(f"{cfg.n_heads} query and {cfg.n_kv_heads} key/value heads do not "
                         f"both split over the model axis' {ctx.tp}")
    return q


def attn_block(p, x, cfg, ctx: Ctx, *, positions, causal=True):
    """Full-sequence attention (prefill, training).  positions: (S,) or
    (B, S) over the whole sequence.  Returns (out, (k, v)) — the
    cache-ready keys/values.  With the rank's heads (``rules``), K3 and K3b
    see ``(B, S, H/tp, hd)`` and the GQA ratio ``H/K`` unchanged."""
    sharded = _heads_sharded(cfg, ctx)
    x = ctx.seq_in(x)
    q, k, v = _qkv(p, x, cfg, ctx)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = attention(q, k, v, causal=causal, logit_cap=cfg.attn_logit_softcap)
    return ctx.seq_out(_out(o, p["wo"], x.dtype), sharded), (k, v)


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


def _gather_heads(ctx: Ctx, *ts):
    """Each of ``ts`` (B, the rank's heads, ...) with every rank's heads,
    in rank order along dim 1: one all-gather over "model"."""
    B, tp = ts[0].shape[0], ctx.tp
    widths = [t.shape[1] for t in ts]
    got = ctx.mesh.all_gather(torch.cat(ts, dim=1), "model", 1)
    parts = got.view(B, tp, sum(widths), *got.shape[2:]).split(widths, dim=2)
    return [p.reshape(B, tp * w, *p.shape[3:]) for p, w in zip(parts, widths)]


def _write_owned(c, new, pos: torch.Tensor, off: int):
    """Write ``new`` (B, ...) at global position ``pos`` of the sequence
    shard ``c`` (B, S_loc, ...) that starts at ``off``, in place, only where
    this rank owns ``pos`` (the others write back what they hold); no host
    read."""
    S_loc = c.shape[1]
    lpos = pos - off
    owned = ((lpos >= 0) & (lpos < S_loc)).view(1, *[1] * (c.dim() - 1))
    li = lpos.clamp(0, S_loc - 1)
    c.index_copy_(1, li, torch.where(owned, new[:, None].to(c.dtype), c.index_select(1, li)))


def _shard_softmax(s, off: int, pos: torch.Tensor, mesh):
    """Partial softmax of the logits ``s`` (..., S_loc) of a sequence shard
    starting at ``off``, positions past ``pos`` masked: (the weights
    ``exp(s - m)`` under the max ``m`` over "model", their sum over
    "model")."""
    s = s.masked_fill(off + torch.arange(s.shape[-1], device=s.device) > pos, NEG_INF)
    m = mesh.pmax(s.amax(dim=-1), "model")
    pexp = torch.exp(s - m[..., None])
    return pexp, mesh.psum(pexp.sum(dim=-1), "model")


def decode_attn_seqpar(q, ck, cv, k_new, v_new, pos: torch.Tensor, *, ctx: Ctx,
                       logit_cap: float = 0.0):
    """Flash decode over a cache whose sequence is sharded over "model":
    q (B, H/tp, hd) and the new k, v (B, K/tp, hd), the rank's heads of its
    batch block (from its ``wq``/``wk``/``wv`` blocks); ck, cv
    (B, S/tp, K, hd), the rank's shard of positions ``[m S/tp, (m+1) S/tp)``
    holding every key/value head.  The query and the new key and value are
    gathered over "model" (every head); each rank scores its shard (a
    partial softmax), and the global max, the sums of the weights and the
    weighted values are combined over "model" (the reference's
    ``shard_map`` body): only (B, H, hd) partials cross between ranks, not
    the cache.  Returns (o (B, H/tp, hd), the rank's heads for its
    row-parallel ``wo``; (ck, cv)).

    The new key and value are written at ``pos`` (a one-element ``long``
    tensor) only on the rank that owns it, in place, as
    :func:`decode_attn_dense` writes (no host read); positions past
    ``pos`` are masked."""
    mesh = ctx.mesh
    Hl = q.shape[1]
    q, k_new, v_new = _gather_heads(ctx, q, k_new, v_new)
    B, S_loc, K, hd = ck.shape
    H = q.shape[1]
    G = H // K
    m = mesh.axis_index("model")
    off = m * S_loc
    _write_owned(ck, k_new, pos, off)
    _write_owned(cv, v_new, pos, off)
    qg = q.reshape(B, K, G, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qg.float(), ck.float()) / math.sqrt(hd)
    if logit_cap > 0:
        s = logit_cap * torch.tanh(s / logit_cap)
    pexp, l_sum = _shard_softmax(s, off, pos, mesh)
    o = torch.einsum("bkgs,bskh->bkgh", pexp.to(cv.dtype).float(), cv.float())
    o = mesh.psum(o, "model") / l_sum.clamp_min(1e-30)[..., None]
    return o.reshape(B, H, hd)[:, m * Hl:(m + 1) * Hl].to(q.dtype), (ck, cv)


def attn_decode_block(p, x, cfg, ctx: Ctx, *, cache, pos: torch.Tensor):
    """x: (B, 1, d).  cache: {"k": (B,S,K,hd), "v": ...}, on a mesh the
    rank's sequence shard (every head, :func:`decode_attn_seqpar`) where
    ``ctx.seq_sharded_cache``, else its heads; pos: a one-element ``long``
    tensor.  On the rank's heads, with the row-parallel output summed over
    "model".  Returns (out (B,1,d), cache)."""
    sharded = _heads_sharded(cfg, ctx)
    q, k, v = _qkv(p, x, cfg, ctx)               # (B,1,H,hd)/(B,1,K,hd)
    posv = pos.view(1, 1).expand(x.shape[0], 1)
    q = apply_rope(q, posv, cfg.rope_theta)[:, 0]
    k = apply_rope(k, posv, cfg.rope_theta)[:, 0]
    if ctx.seq_sharded_cache:
        o, (ck, cv) = decode_attn_seqpar(q, cache["k"], cache["v"], k, v[:, 0], pos, ctx=ctx,
                                         logit_cap=cfg.attn_logit_softcap)
    else:
        o, (ck, cv) = decode_attn_dense(q, cache["k"], cache["v"], k, v[:, 0], pos,
                                        logit_cap=cfg.attn_logit_softcap)
    return ctx.seq_out(_out(o, p["wo"], x.dtype)[:, None], sharded), {"k": ck, "v": cv}


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, MiniCPM3 / DeepSeek-V2 style)
# ---------------------------------------------------------------------------

def mla_params(cfg) -> dict:
    d, H = cfg.d_model, cfg.n_heads
    r_kv, r_q = cfg.kv_lora_rank, cfg.q_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "wq_a": P((d, r_q), ("embed_fsdp", "q_lora")),
        "q_norm": rmsnorm_params(r_q),
        "wq_b": P((r_q, H, dn + dr), ("q_lora", "heads", "head_dim")),
        "wkv_a": P((d, r_kv + dr), ("embed_fsdp", "kv_lora")),
        "kv_norm": rmsnorm_params(r_kv),
        "wk_b": P((r_kv, H, dn), ("kv_lora", "heads", "head_dim")),
        "wv_b": P((r_kv, H, dv), ("kv_lora", "heads", "head_dim")),
        "wo": P((H, dv, d), ("heads", "head_dim", "embed_fsdp")),
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
    sharded = ctx.tp_sharded("heads", cfg.n_heads)
    x = ctx.seq_in(x)
    B, S, _ = x.shape
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q_nope, q_rope = _mla_q(p, x, cfg, ctx, positions)
    latent, k_rope = _mla_latent(p, x, cfg, ctx, positions)
    k_nope = _proj(latent, p["wk_b"])
    v = _proj(latent, p["wv_b"])
    q = torch.cat([q_nope, q_rope], dim=-1)
    H = q.shape[2]                                  # the rank's heads
    k = torch.cat([k_nope, k_rope[:, :, None].expand(B, S, H, dr)], dim=-1)
    o = attention(q, k, F.pad(v, (0, dn + dr - dv)), causal=True)[..., :dv]
    return ctx.seq_out(_out(o, p["wo"], x.dtype), sharded), (latent, k_rope)


def mla_decode_block(p, x, cfg, ctx: Ctx, *, cache, pos: torch.Tensor):
    """Absorbed-weight MLA decode: the query scored in latent space against
    the compact cache {"latent": (B, S, r_kv), "k_rope": (B, S, dr)}, which
    is written at ``pos`` (a one-element ``long`` tensor) in place and
    returned; like :func:`decode_attn_dense`, nothing is read on the host.
    On the rank's heads, the row-parallel output summed over "model"; where
    ``ctx.seq_sharded_cache`` the cache is the rank's sequence shard, and
    the latent queries are gathered over "model" and the partial softmaxes
    combined, as :func:`decode_attn_seqpar` does."""
    sharded = ctx.tp_sharded("heads", cfg.n_heads)
    B = x.shape[0]
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    posv = pos.view(1, 1).expand(B, 1)
    q_nope, q_rope = _mla_q(p, x, cfg, ctx, posv)          # (B, 1, H, .)
    latent_new, k_rope_new = _mla_latent(p, x, cfg, ctx, posv)
    cl, cr = cache["latent"], cache["k_rope"]
    # absorb wk_b into the query: q_lat (B, H, r_kv)
    q_lat = torch.einsum("bhk,rhk->bhr", q_nope[:, 0], p["wk_b"].to(x.dtype))
    q_rope = q_rope[:, 0]
    if ctx.seq_sharded_cache:
        Hl = q_lat.shape[1]
        m = ctx.mesh.axis_index("model")
        off = m * cl.shape[1]
        r_kv = q_lat.shape[-1]
        q_lat, q_rope = _gather_heads(ctx, torch.cat([q_lat, q_rope], -1))[0].split(
            [r_kv, q_rope.shape[-1]], -1)
        _write_owned(cl, latent_new[:, 0], pos, off)
        _write_owned(cr, k_rope_new[:, 0], pos, off)
    else:
        cl.index_copy_(1, pos, latent_new.to(cl.dtype))
        cr.index_copy_(1, pos, k_rope_new.to(cr.dtype))
    s = (torch.einsum("bhr,bsr->bhs", q_lat.float(), cl.float())
         + torch.einsum("bhk,bsk->bhs", q_rope.float(), cr.float())) * (
        1.0 / math.sqrt(dn + dr))
    if ctx.seq_sharded_cache:
        pexp, l_sum = _shard_softmax(s, off, pos, ctx.mesh)
        o_lat = torch.einsum("bhs,bsr->bhr", pexp.to(x.dtype), cl.to(x.dtype)).float()
        o_lat = ctx.mesh.psum(o_lat, "model") / l_sum.clamp_min(1e-30)[..., None]
        o_lat = o_lat[:, m * Hl:(m + 1) * Hl].to(x.dtype)
    else:
        s = s.masked_fill(torch.arange(cl.shape[1], device=s.device) > pos, NEG_INF)
        w = torch.softmax(s, dim=-1).to(x.dtype)
        o_lat = torch.einsum("bhs,bsr->bhr", w, cl.to(x.dtype))
    o = torch.einsum("bhr,rhk->bhk", o_lat, p["wv_b"].to(x.dtype))
    out = ctx.seq_out(_out(o, p["wo"], x.dtype)[:, None], sharded)
    return out, {"latent": cl, "k_rope": cr}
