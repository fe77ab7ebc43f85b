"""Mamba (S6 selective SSM) mixer, Jamba's attention-free layer (the port of
``repro/models/ssm.py``; on a mesh with ``rules``, tensor-parallel over the
rank's ``mamba_inner`` channels).

Recurrence (diagonal, per channel c and state n):
    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * x_t
    y_t = C_t . h_t + D * x_t

The reference has no kernel for it: it runs the recurrence as a chunked
``lax.scan`` of plain ``jnp`` steps, so plain tensor code is its port.

* ``mamba_block`` (prefill and training) walks the sequence in chunks of
  :data:`CHUNK` steps.  Each chunk's decay ``exp(dt A)`` and input term
  ``(dt x) B`` are computed at once, ``(B, CHUNK, d_inner, d_state)``; the
  state then advances step by step with the reference's operations in its
  order (times the decay, plus the input term), and the chunk's outputs
  ``C . h`` are one product.  The ``(B, S, d_inner, d_state)`` expansion
  never exists.  The reference pads S to a multiple of the chunk with
  ``dt = 0`` after the softplus, steps that leave ``h`` unchanged; the last
  chunk here is short instead.  Under autograd with ``ctx.remat`` each chunk
  is checkpointed, as the reference's ``jax.checkpoint(chunk_step)``.
* ``mamba_decode_block``: one step against the cached state and the last
  ``d_conv - 1`` pre-convolution inputs (on a mesh, on the rank's channels).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import Ctx, _checkpoint, _remat, rmsnorm, rmsnorm_params
from .params import P

CHUNK = 16  # the reference's scan chunk


def mamba_params(cfg) -> dict:
    d = cfg.d_model
    di = cfg.mamba_d_inner
    ds = cfg.mamba_d_state
    dc = cfg.mamba_d_conv
    dt_rank = math.ceil(d / 16)
    return {
        "in_proj": P((d, 2 * di), ("embed_fsdp", "mamba_inner")),
        "conv_w": P((dc, di), (None, "mamba_inner"), init="normal", scale=1.0 / math.sqrt(dc)),
        "conv_b": P((di,), ("mamba_inner",), init="zeros"),
        "x_proj": P((di, dt_rank + 2 * ds), ("mamba_inner", None)),
        "dt_proj": P((dt_rank, di), (None, "mamba_inner")),
        "dt_bias": P((di,), ("mamba_inner",), init="zeros"),
        "A_log": P((di, ds), ("mamba_inner", None), init="zeros"),
        "D": P((di,), ("mamba_inner",), init="ones"),
        "out_proj": P((di, d), ("mamba_inner", "embed_fsdp")),
        # Jamba's extra norms on dt/B/C
        "dt_norm": rmsnorm_params(dt_rank),
        "b_norm": rmsnorm_params(ds),
        "c_norm": rmsnorm_params(ds),
    }


def _dt_bc(p, xs, cfg, dt_rank, ctx: Ctx | None = None):
    """xs: (..., di) -> dt (..., di), B (..., ds), C (..., ds), all f32.  The
    dt norm and ``dt_proj`` run in the activation dtype, the softplus in
    f32.  With ``ctx``, xs and ``x_proj`` are the rank's channels, and their
    partial products are summed over "model"."""
    ds = cfg.mamba_d_state
    dbc = xs @ p["x_proj"].to(xs.dtype)
    if ctx is not None:
        dbc = ctx.mesh.psum(dbc, "model")
    dt, b, c = torch.split(dbc, [dt_rank, ds, ds], dim=-1)
    dt = rmsnorm(p["dt_norm"], dt, cfg.norm_eps)
    b = rmsnorm(p["b_norm"], b, cfg.norm_eps).float()
    c = rmsnorm(p["c_norm"], c, cfg.norm_eps).float()
    dt = dt @ p["dt_proj"].to(dt.dtype)
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    return dt, b, c


def _conv_causal(p, x):
    """Depthwise causal conv, width d_conv.  x: (B, S, di)."""
    dc = p["conv_w"].shape[0]
    S = x.shape[1]
    w = p["conv_w"].to(x.dtype)
    out = x * w[-1]
    for i in range(1, dc):
        out = out + F.pad(x, (0, 0, i, 0))[:, :S] * w[-1 - i]
    return out + p["conv_b"].to(x.dtype)


def _scan_chunk(h, xc, dtc, bc, cc, A):
    """Advance the state over one chunk.  h: (B, di, ds); xc, dtc: (B, T, di);
    bc, cc: (B, T, ds) (all f32) -> (h, y (B, T, di))."""
    da = torch.exp(dtc[..., None] * A)                        # (B,T,di,ds)
    dbx = (dtc * xc)[..., None] * bc[:, :, None, :]           # (B,T,di,ds)
    hs = []
    for da_t, dbx_t in zip(da.unbind(1), dbx.unbind(1)):
        h = da_t * h + dbx_t
        hs.append(h)
    return h, torch.einsum("btis,bts->bti", torch.stack(hs, 1), cc)


def scan(xf, dt, b, c, A, ctx: Ctx):
    """The recurrence over the whole sequence from a zero state, chunk by
    chunk.  xf, dt: (B, S, di); b, c: (B, S, ds); A: (di, ds), all f32 ->
    (final h (B, di, ds), y = C . h (B, S, di))."""
    B, S, di = xf.shape
    h = torch.zeros(B, di, A.shape[1], dtype=torch.float32, device=xf.device)
    ys = []
    for t0 in range(0, S, CHUNK):
        sl = slice(t0, t0 + CHUNK)
        args = (h, xf[:, sl], dt[:, sl], b[:, sl], c[:, sl], A)
        h, y = _checkpoint(_scan_chunk, *args) if _remat(ctx) else _scan_chunk(*args)
        ys.append(y)
    return h, torch.cat(ys, 1)


def _in_proj(p, x, cfg, ctx: Ctx, *, decode: bool = False):
    """x @ in_proj -> (xs, z), each (B, S, di) or, with the rank's
    ``mamba_inner`` block, its channels of each.  The block of ``in_proj``
    the rules give a rank is a slice of its 2 di columns, which mixes xs's
    and z's channels, so a rank's xs and z columns are gathered over
    "model" (backward: a reduce-scatter) and taken: over a sequence the
    block itself, (d, 2 di / tp), fewer bytes than the product when
    B S > d; in ``decode`` the rank's product x @ block, (B, 1, 2 di / tp),
    fewer than the block when B < d."""
    w = p["in_proj"]
    if not ctx.tp_sharded("mamba_inner", cfg.mamba_d_inner):
        return (x @ w.to(x.dtype)).chunk(2, dim=-1)
    di, tp, m = cfg.mamba_d_inner, ctx.tp, ctx.mesh.axis_index("model")
    n = di // tp
    if decode:
        y = ctx.mesh.all_gather(x @ w.to(x.dtype), "model", x.dim() - 1)
        return y[..., m * n:(m + 1) * n], y[..., di + m * n:di + (m + 1) * n]
    w = ctx.mesh.all_gather(w, "model", 1)
    cols = torch.cat([w[:, m * n:(m + 1) * n], w[:, di + m * n:di + (m + 1) * n]], dim=1)
    return (x @ cols.to(x.dtype)).chunk(2, dim=-1)


def mamba_block(p, x, cfg, ctx: Ctx):
    """Full-sequence mixer.  x: (B, S, d) -> (out, state) where state is the
    decode-ready cache {"h": (B, di, ds) f32, "conv": (B, dc-1, di)}: the
    last ``dc - 1`` pre-convolution inputs in the activation dtype,
    zero-padded on the left when S is shorter.  With the rank's
    ``mamba_inner`` block (``rules``) it runs on its channels: ``x_proj``'s
    partial products are summed over "model" (dt, B and C are whole), and
    so is the row-parallel output."""
    sharded = ctx.tp_sharded("mamba_inner", cfg.mamba_d_inner)
    x = ctx.seq_in(x)
    B, S, _ = x.shape
    dc = cfg.mamba_d_conv
    dt_rank = math.ceil(cfg.d_model / 16)
    pre, z = _in_proj(p, x, cfg, ctx)
    di = pre.shape[-1]
    xs = F.silu(_conv_causal(p, pre))
    dt, b, c = _dt_bc(p, xs, cfg, dt_rank, ctx if sharded else None)  # (B,S,di),(B,S,ds)
    A = -torch.exp(p["A_log"].float())                        # (di, ds)
    xf = xs.float()
    h, y = scan(xf, dt, b, c, A, ctx)
    y = y + xf * p["D"].float()
    y = y.to(x.dtype) * F.silu(z)
    out = ctx.seq_out(y @ p["out_proj"].to(x.dtype), sharded)
    n = min(S, dc - 1)
    conv = x.new_zeros(B, dc - 1, di)
    conv[:, dc - 1 - n:] = pre[:, S - n:]
    return out, {"h": h, "conv": conv}


def mamba_decode_block(p, x, cfg, ctx: Ctx, *, cache, pos: torch.Tensor):
    """One-token step.  x: (B, 1, d); cache {"h": (B, di, ds), "conv":
    (B, dc-1, di)} -> (out (B, 1, d), new cache).  The convolution runs over
    ``[cache["conv"], x]`` in the cache's dtype; ``pos`` is not read.  On the
    rank's ``mamba_inner`` channels (and its block of the cache), as
    :func:`mamba_block`."""
    sharded = ctx.tp_sharded("mamba_inner", cfg.mamba_d_inner)
    dt_rank = math.ceil(cfg.d_model / 16)
    xs, z = (t[:, 0] for t in _in_proj(p, x, cfg, ctx, decode=True))
    hist = torch.cat([cache["conv"], xs[:, None].to(cache["conv"].dtype)], dim=1)
    w = p["conv_w"].to(x.dtype)                               # (dc, di)
    cdt = torch.promote_types(hist.dtype, w.dtype)
    xs = torch.einsum("bci,ci->bi", hist.to(cdt), w.to(cdt)) + p["conv_b"].to(x.dtype)
    xs = F.silu(xs)
    dt, b, c = _dt_bc(p, xs, cfg, dt_rank, ctx if sharded else None)   # (B,di),(B,ds)
    A = -torch.exp(p["A_log"].float())
    da = torch.exp(dt[..., None] * A)
    h = da * cache["h"] + (dt * xs.float())[..., None] * b[:, None, :]
    y = torch.einsum("bis,bs->bi", h, c)
    y = y + xs.float() * p["D"].float()
    y = y.to(x.dtype) * F.silu(z)
    out = ctx.seq_out((y @ p["out_proj"].to(x.dtype))[:, None], sharded)
    return out, {"h": h, "conv": hist[:, 1:]}
