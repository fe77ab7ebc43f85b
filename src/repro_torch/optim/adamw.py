"""AdamW with a configurable state dtype, global-norm clipping and optional
int8 gradient compression with error feedback (the port of
``repro/optim/adamw.py``).  On a mesh each rank updates its blocks; the
norm of the clip and the int8 scales are the whole tensors'.

The state mirrors the parameter tree, as the reference's does: ``{"step":
int32 scalar, "moments": {... leaf: {"m", "v"}}}`` plus ``"error"`` (bf16,
one per leaf) under int8 compression, so a reference state carries across
with :func:`repro_torch.models.params.params_from_numpy`.  The arithmetic is
the reference's, in f32 whatever the state dtype; :func:`apply_updates`
writes the new parameters and state into the given tensors (the reference's
jitted step donates both buffers) and returns the same trees.  Plain tensor
code: the reference has no kernel here.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..models.params import P, tree_leaves, tree_map

# leaves above this many elements are updated a few leading-axis rows at a
# time (a stacked unit weight one unit at a time), which bounds the f32
# temporaries
_SLICE_NUMEL = 1 << 24


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: torch.dtype = torch.float32  # bf16 fits the 398B on one pod
    compress_int8: bool = False  # int8 grad all-reduce + error feedback


def init_state(params, cfg: AdamWConfig) -> dict:
    """Zero moments (and zero bf16 errors under compression) beside each
    parameter, on its device, and step 0."""
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    st = {"step": torch.zeros((), dtype=torch.int32, device=device),
          "moments": tree_map(lambda p: {
              "m": torch.zeros(p.shape, dtype=cfg.state_dtype, device=p.device),
              "v": torch.zeros(p.shape, dtype=cfg.state_dtype, device=p.device)}, params)}
    if cfg.compress_int8:
        st["error"] = tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device), params)
    return st


def state_specs(param_specs, cfg: AdamWConfig) -> dict:
    """The :class:`P` spec tree of the optimizer state (``init_params`` of it
    is :func:`init_state`)."""
    st = {"step": P((), (), torch.int32, "zeros"),
          "moments": tree_map(lambda s: {"m": P(s.shape, s.axes, cfg.state_dtype, "zeros"),
                                         "v": P(s.shape, s.axes, cfg.state_dtype, "zeros")},
                              param_specs)}
    if cfg.compress_int8:
        st["error"] = tree_map(lambda s: P(s.shape, s.axes, torch.bfloat16, "zeros"),
                               param_specs)
    return st


def _zip(params, *trees):
    """(parameter, the same leaf of each tree) in the reference's leaf order;
    a moments tree's leaf is its {"m", "v"} dict."""
    if isinstance(params, dict):
        for k in sorted(params):
            yield from _zip(params[k], *(t[k] for t in trees))
    else:
        yield (params, *trees)


def _sharded_axes(spec, mesh) -> tuple[str, ...]:
    from ..parallel.sharding import spec_axes

    return tuple(a for a in mesh.axis_names if a in spec_axes(spec) and mesh.shape[a] > 1)


def global_norm(tree, specs=None, mesh=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32.  With the leaves'
    ``specs`` on ``mesh`` (each leaf the rank's block), each leaf's sum of
    squares is summed over the axes it is sharded on, so a replicated leaf
    counts once: the norm of the whole tree."""
    sq = [x.float().square().sum() for x in tree_leaves(tree)]
    if specs is None:
        return torch.stack(sq).sum().sqrt()
    by_axes: dict = {}
    for s, spec in zip(sq, tree_leaves(specs)):
        by_axes.setdefault(_sharded_axes(spec, mesh), []).append(s)
    total = []
    for axes, parts in by_axes.items():
        part = torch.stack(parts).sum()
        for a in axes:
            part = mesh.psum(part, a)
        total.append(part)
    return torch.stack(total).sum().sqrt()


def _quantize_int8(g: torch.Tensor, amax=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization; returns (q, scale).
    ``amax`` is the tensor's largest magnitude where ``g`` is a block of it."""
    scale = ((g.abs().max() if amax is None else amax) + 1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_grads(grads, error, specs=None, mesh=None) -> tuple[dict, dict]:
    """int8 compression with error feedback: the quantization residual is
    carried into the next step instead of being lost.  Returns (the
    dequantized gradients in their dtype, the new bf16 errors), two trees
    of the gradients' structure.  With ``specs`` on ``mesh`` each scale is
    the whole tensor's (the blocks' largest magnitude over the axes the
    leaf is sharded on)."""
    if isinstance(grads, dict):
        parts = {k: compress_grads(grads[k], error[k], None if specs is None else specs[k],
                                   mesh) for k in grads}
        return {k: g for k, (g, _) in parts.items()}, {k: e for k, (_, e) in parts.items()}
    gf = grads.float() + error.float()
    amax = None
    if specs is not None:
        amax = gf.abs().max()
        for a in _sharded_axes(specs, mesh):
            amax = mesh.pmax(amax, a)
    q, scale = _quantize_int8(gf, amax)
    deq = q.float() * scale
    return deq.to(grads.dtype), (gf - deq).to(torch.bfloat16)


def _slices(*ts):
    """The tensors in pieces along the leading axis, each of at most
    :data:`_SLICE_NUMEL` elements where a row allows it (one piece when
    they are small)."""
    t = ts[0]
    if t.dim() < 2 or t.numel() <= _SLICE_NUMEL:
        return [ts]
    rows = max(1, _SLICE_NUMEL // (t.numel() // t.shape[0]))
    return zip(*(x.split(rows) for x in ts))


@torch.no_grad()
def apply_updates(params, grads, state, cfg: AdamWConfig, lr_scale=1.0, specs=None, mesh=None):
    """One AdamW step, in place.  Returns (params, state, {"grad_norm"}).
    With the leaves' ``specs`` on ``mesh``, the trees are the rank's blocks
    and the global norm is the whole tree's (:func:`global_norm`)."""
    gn = global_norm(grads, specs, mesh)
    clip = (torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-9), max=1.0)
            if cfg.grad_clip > 0 else 1.0)
    if cfg.compress_int8:
        grads, new_error = compress_grads(tree_map(lambda g: g * clip, grads), state["error"],
                                          specs, mesh)
        clip_applied = 1.0
    else:
        new_error = None
        clip_applied = clip
    step = state["step"] + 1
    t = step.float()
    bc1 = 1.0 - torch.pow(cfg.b1, t)
    bc2 = 1.0 - torch.pow(cfg.b2, t)
    lr = cfg.lr * lr_scale

    for p, g, mo in _zip(params, grads, state["moments"]):
        for ps, gs, ms, vs in _slices(p, g, mo["m"], mo["v"]):
            gf = gs.float() * clip_applied
            m = cfg.b1 * ms.float() + (1 - cfg.b1) * gf
            v = cfg.b2 * vs.float() + (1 - cfg.b2) * gf * gf
            mhat = m / bc1
            vhat = v / bc2
            delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * ps.float()
            ps.copy_(ps.float() - lr * delta)
            ms.copy_(m)
            vs.copy_(v)
    state["step"].copy_(step)
    if new_error is not None:
        for e, ne in _zip(state["error"], new_error):
            e.copy_(ne)
    return params, state, {"grad_norm": gn}


# -- lr schedules -------------------------------------------------------------


def cosine_schedule(step: torch.Tensor, *, warmup: int, total: int, floor: float = 0.1
                    ) -> torch.Tensor:
    """Linear warm-up to 1 over ``warmup`` steps, then a cosine decay to
    ``floor`` at ``total``; f32, as the reference computes it."""
    t = step.float()
    warm = t / max(warmup, 1)
    prog = torch.clamp((t - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(t < warmup, warm, cos)
