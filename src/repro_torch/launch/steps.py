"""Step factories shared by the trainer and the server (the port of
``repro/launch/steps.py``, one device): a train step, a prefill step and a
decode step from a config.

The reference derives each step's shardings from a mesh.  The port's model
has the multi-rank paths (the expert-parallel MoE and the sequence-parallel
decode, taken when :class:`~repro_torch.models.layers.Ctx` holds a mesh),
but the trainer and the server build no mesh yet (ROADMAP queue 1, item
9): :func:`make_ctx` gives every step a one-device context.
:class:`DistConfig` keeps the reference's field names.  ``make_ctx``
refuses, raising and naming item 9, the fields that only mean something
on a mesh: ``sharding_mode="fsdp"``, ``seq_parallel``, ``moe_dedup`` and a
``moe_dest_k`` that is set.  It drops ``decode_seqpar`` (True by default;
on one device the reference decodes densely too) and ``q_chunk`` and
``kv_chunk``, which pick between attention branches that compute the same
function; the port sends both to one K3 call.
"""

from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ModelConfig
from ..models import transformer as T
from ..models.layers import Ctx
from ..models.params import tree_leaves
from ..optim import adamw

MESH_ONLY = "needs a device mesh (ROADMAP queue 1, item 9)"


@dataclasses.dataclass(frozen=True)
class DistConfig:
    """Distribution knobs, the reference's fields."""

    sharding_mode: str = "tp"  # tp (Megatron, baseline) | fsdp
    seq_parallel: bool = False
    decode_seqpar: bool = True  # flash-decode cache seq-sharding
    remat: bool = True
    q_chunk: int = 512
    kv_chunk: int = 1024
    compress_int8: bool = False
    moe_dedup: bool = False
    moe_dest_k: float | None = None
    lr: float = 3e-4


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def make_ctx(cfg: ModelConfig, phase: str, dist: DistConfig) -> Ctx:
    """The model's one-device context for ``phase`` (train | prefill |
    decode); raises on the mesh-only fields."""
    if dist.sharding_mode != "tp":
        raise NotImplementedError(f"sharding_mode={dist.sharding_mode!r} {MESH_ONLY}")
    if dist.seq_parallel:
        raise NotImplementedError(f"seq_parallel {MESH_ONLY}")
    if dist.moe_dedup:
        raise NotImplementedError(f"moe_dedup {MESH_ONLY}")
    if dist.moe_dest_k is not None:
        raise NotImplementedError(f"moe_dest_k {MESH_ONLY}")
    return Ctx(dtype=_dtype(cfg.activation_dtype), remat=dist.remat and cfg.remat)


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------


def make_train_step(cfg: ModelConfig, dist: DistConfig = DistConfig(),
                    opt_cfg: adamw.AdamWConfig | None = None):
    """Returns (train_step, param_specs, opt_specs, ctx).

    ``train_step(params, opt_state, batch)`` takes the gradient of
    :func:`~repro_torch.models.transformer.lm_loss` by autograd and applies
    one AdamW step under the reference's cosine schedule (100 warm-up steps
    of 10000).  It updates ``params`` and ``opt_state`` in place (the
    reference's jitted step donates both) and returns (params, opt_state,
    metrics), the metrics being the loss, ``ce``, ``aux``, ``n_tok`` and
    ``grad_norm`` as tensors on the device, read by no host code here."""
    opt_cfg = opt_cfg or adamw.AdamWConfig(
        lr=dist.lr, state_dtype=_dtype(cfg.optstate_dtype), compress_int8=dist.compress_int8)
    ctx = make_ctx(cfg, "train", dist)
    param_specs = T.model_param_specs(cfg, tp=1)
    opt_specs = adamw.state_specs(param_specs, opt_cfg)

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        live = [p.detach().requires_grad_(p.is_floating_point()) for p in leaves]
        it = iter(live)
        grad_params = _rebuild(params, it)
        with torch.enable_grad():
            loss, metrics = T.lm_loss(grad_params, batch, cfg, ctx)
            wrt = [p for p in live if p.requires_grad]
            grads = torch.autograd.grad(loss, wrt, allow_unused=True, materialize_grads=True)
        it = iter(grads)
        grad_tree = _rebuild(params, (next(it) if p.is_floating_point() else None
                                      for p in leaves))
        lr_scale = adamw.cosine_schedule(opt_state["step"] + 1, warmup=100, total=10000)
        params, opt_state, om = adamw.apply_updates(params, grad_tree, opt_state, opt_cfg,
                                                    lr_scale=lr_scale)
        out = {"loss": loss.detach(), **{k: v.detach() for k, v in metrics.items()}, **om}
        return params, opt_state, out

    return train_step, param_specs, opt_specs, ctx


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves, in the reference's (sorted-key)
    order, taken from the iterator ``leaves``."""
    if isinstance(tree, dict):
        made = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: made[k] for k in tree}
    return next(leaves)


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------


def make_prefill_step(cfg: ModelConfig, dist: DistConfig = DistConfig(),
                      cache_len: int | None = None):
    """Returns (prefill_step, param_specs, ctx); ``prefill_step(params,
    batch)`` is :func:`~repro_torch.models.transformer.prefill`."""
    ctx = make_ctx(cfg, "prefill", dist)
    param_specs = T.model_param_specs(cfg, tp=1)

    def prefill_step(params, batch):
        return T.prefill(params, batch, cfg, ctx, cache_len=cache_len)

    return prefill_step, param_specs, ctx


def make_decode_step(cfg: ModelConfig, dist: DistConfig, batch: int, cache_len: int):
    """Returns (decode_step, param_specs, cache_specs, ctx);
    ``decode_step(params, cache, tokens, pos)`` is
    :func:`~repro_torch.models.transformer.decode_step`."""
    ctx = make_ctx(cfg, "decode", dist)
    param_specs = T.model_param_specs(cfg, tp=1)
    cache_spec_tree = T.cache_specs(cfg, batch, cache_len)

    def decode_step(params, cache, tokens, pos):
        return T.decode_step(params, cache, tokens, pos, cfg, ctx)

    return decode_step, param_specs, cache_spec_tree, ctx
