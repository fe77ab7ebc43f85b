"""RWKV-6 "Finch" mixer: linear attention with data-dependent decay (the port
of ``repro/models/rwkv.py``; on a mesh with ``rules``, tensor-parallel over
the rank's heads).

Per head (head size N): state S in R^{N x N},
    o_t = r_t @ (S_{t-1} + (u * k_t) v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
with w_t in (0,1) data-dependent and u a learned per-channel bonus.
Receptance/key/value/gate/decay come from a data-dependent token shift
(ddlerp with a low-rank adapter).

* ``rwkv6_block`` (prefill, and training) runs the whole recurrence as ONE
  K4 call (:func:`repro_torch.kernels.ops.wkv6`), which also returns the
  final state; the reference's chunked scan pads S to a multiple of 32 with
  decay 1, which the kernel does not need.  Under grad the call goes
  through :class:`repro_torch.kernels.ops.WKV6`, whose backward is K4b (the
  gradient of the reference's checkpointed scan; on the CPU, its plain
  version).
* ``rwkv6_decode_block``: a single recurrence step against the cached state,
  plain tensor code (on a mesh, on the rank's heads).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops
from .layers import Ctx, _out, _proj
from .params import P

LORA_DIM = 32          # TIME_MIX_EXTRA_DIM in the reference implementation
DECAY_LORA_DIM = 64


def rwkv_params(cfg) -> dict:
    d = cfg.d_model
    H = cfg.rwkv_n_heads
    N = cfg.rwkv_head_size
    return {
        # ddlerp: 5 interpolation anchors (r,k,v,g,w) + low-rank adapters
        "mu_x": P((d,), (None,), init="zeros"),
        "mu": P((5, d), (None, None), init="zeros"),
        "lora_a": P((d, 5, LORA_DIM), ("embed_fsdp", None, None), init="small"),
        "lora_b": P((5, LORA_DIM, d), (None, None, "embed_fsdp"), init="small"),
        # decay: w = exp(-exp(w0 + tanh(x A_w) B_w)) — per (head, channel)
        "w0": P((H, N), ("rwkv_heads", None), init="zeros"),
        "w_a": P((d, DECAY_LORA_DIM), ("embed_fsdp", None), init="small"),
        "w_b": P((DECAY_LORA_DIM, H, N), (None, "rwkv_heads", None), init="small"),
        "u": P((H, N), ("rwkv_heads", None), init="zeros"),   # bonus
        "wr": P((d, H, N), ("embed_fsdp", "rwkv_heads", None)),
        "wk": P((d, H, N), ("embed_fsdp", "rwkv_heads", None)),
        "wv": P((d, H, N), ("embed_fsdp", "rwkv_heads", None)),
        "wg": P((d, H, N), ("embed_fsdp", "rwkv_heads", None)),
        "ln_out_scale": P((H * N,), (None,), init="ones"),
        "ln_out_bias": P((H * N,), (None,), init="zeros"),
        "wo": P((H, N, d), ("rwkv_heads", None, "embed_fsdp")),
    }


def _ddlerp(p, x, x_prev):
    """Data-dependent token-shift interpolation.

    x, x_prev: (B, S, d).  Returns 5 mixed streams (r,k,v,g,w): (5, B, S, d).
    """
    dx = x_prev - x
    xx = x + dx * p["mu_x"].to(x.dtype)
    # low-rank data-dependent adjustment for the 5 mixes
    a = torch.tanh(torch.einsum("bsd,dfl->bsfl", xx, p["lora_a"].to(x.dtype)))
    adj = torch.einsum("bsfl,fld->fbsd", a, p["lora_b"].to(x.dtype))
    mix = p["mu"].to(x.dtype)[:, None, None] + adj        # (5,B,S,d)
    return x[None] + dx[None] * mix


def _rkvgw(p, x, x_prev, cfg, ctx: Ctx):
    H, N = p["wr"].shape[1], cfg.rwkv_head_size       # H: the rank's heads
    mr, mk, mv, mg, mw = _ddlerp(p, x, x_prev)
    r = _proj(mr, p["wr"])
    k = _proj(mk, p["wk"])
    v = _proj(mv, p["wv"])
    B, S, _ = x.shape
    g = F.silu(_proj(mg, p["wg"]).reshape(B, S, H * N))
    lora = torch.tanh(mw @ p["w_a"].to(x.dtype)).float()
    wraw = p["w0"].float() + torch.einsum("bsl,lhn->bshn", lora, p["w_b"].float())
    w = torch.exp(-torch.exp(wraw - 0.5))                 # (B,S,H,N) in (0,1)
    return r, k, v, g, w


def _group_norm(p, x, H, eps=64e-5):
    """Per-head group norm over the flattened (H, N) output, in f32 with the
    population variance.  x: (B,S,H*N)."""
    B, S, d = x.shape
    xh = x.reshape(B, S, H, d // H).float()
    mu = xh.mean(dim=-1, keepdim=True)
    var = xh.var(dim=-1, keepdim=True, correction=0)
    xh = (xh - mu) * torch.rsqrt(var + eps)
    return xh.reshape(B, S, d) * p["ln_out_scale"].float() + p["ln_out_bias"].float()


def _wkv_step(state, r_t, k_t, v_t, w_t, u):
    """One recurrence step.  state: (B,H,N,N) [k-index, v-index].
    r/k/v/w_t: (B,H,N); u: (H,N)."""
    kv = k_t[..., :, None] * v_t[..., None, :]                # (B,H,N,N)
    o = torch.einsum("bhk,bhkn->bhn", r_t, state + u[..., :, None] * kv)
    state = w_t[..., :, None] * state + kv
    return state, o


def rwkv6_block(p, x, cfg, ctx: Ctx):
    """Full-sequence mixer.  x: (B,S,d) -> (out, cache {"S","x_last"}).
    With the rank's ``rwkv_heads`` block (``rules``), K4 and K4b run on its
    heads, the output group norm takes its slice of the (replicated) scale
    and bias, and the row-parallel output is summed over "model"."""
    sharded = ctx.tp_sharded("rwkv_heads", cfg.rwkv_n_heads)
    x = ctx.seq_in(x)
    B, S, d = x.shape
    H, N = p["wr"].shape[1], cfg.rwkv_head_size
    x_prev = F.pad(x, (0, 0, 1, 0))[:, :-1]
    r, k, v, g, w = _rkvgw(p, x, x_prev, cfg, ctx)
    # four contiguous (B, S, H, N) f32 tensors, handed to K4 as (B, H, S, N) views
    rf, kf, vf, wf = (t.float().contiguous().transpose(1, 2) for t in (r, k, v, w))
    o, state = ops.wkv6(rf, kf, vf, wf, p["u"].float())
    o = o.transpose(1, 2).reshape(B, S, H * N)
    o = _group_norm(_norm_block(p, H * N, ctx, sharded), o, H).to(x.dtype) * g
    out = ctx.seq_out(_out(o.view(B, S, H, N), p["wo"], x.dtype), sharded)
    return out, {"S": state, "x_last": x[:, -1].clone()}


def _norm_block(p, width: int, ctx: Ctx, sharded: bool):
    """The output group norm's scale and bias (replicated) for the rank's
    ``width`` channels where its heads are a block of them."""
    if not sharded:
        return p
    m = ctx.mesh.axis_index("model")
    return {k: p[k][m * width:(m + 1) * width] for k in ("ln_out_scale", "ln_out_bias")}


def rwkv6_decode_block(p, x, cfg, ctx: Ctx, *, cache, pos: torch.Tensor):
    """One-token step.  x: (B,1,d); cache {"S": (B,H,N,N), "x_last": (B,d)}.
    ``pos`` is not read: the recurrence carries the position in its state.
    On the rank's heads (and its block of the state), as
    :func:`rwkv6_block`."""
    sharded = ctx.tp_sharded("rwkv_heads", cfg.rwkv_n_heads)
    B = x.shape[0]
    H, N = p["wr"].shape[1], cfg.rwkv_head_size
    x_prev = cache["x_last"][:, None]
    r, k, v, g, w = _rkvgw(p, x, x_prev, cfg, ctx)
    state, o = _wkv_step(cache["S"], r[:, 0].float(), k[:, 0].float(), v[:, 0].float(),
                         w[:, 0], p["u"].float())
    o = _group_norm(_norm_block(p, H * N, ctx, sharded), o.reshape(B, 1, H * N), H)
    o = o.to(x.dtype) * g
    out = ctx.seq_out(_out(o.view(B, 1, H, N), p["wo"], x.dtype), sharded)
    return out, {"S": state, "x_last": x[:, 0].to(cache["x_last"].dtype)}
