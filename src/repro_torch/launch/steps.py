"""Step factories shared by the trainer and the server (the port of
``repro/launch/steps.py``): a train step, a prefill step and a decode step
from a config, and the shardings of their trees from the logical-axis
rules.

Each factory with ``mesh=None`` gives the one-device step.  On a
:class:`~repro_torch.launch.mesh.Mesh` each process is one rank and holds
its blocks of the parameters, the optimizer state, the caches and the batch
(:func:`repro_torch.parallel.sharding.tree_shardings`,
:func:`shardings_for_batch`; cut with
:func:`repro_torch.parallel.sharding.shard_tree`), and the step is explicit
SPMD: Megatron tensor parallelism over "model" (or ZeRO-3 with
``sharding_mode="fsdp"``), sequence parallelism with ``seq_parallel``, the
expert-parallel MoE, data parallelism over "pod" and "data", each where the
reference's rule sets put it (:class:`~repro_torch.models.layers.Ctx`).
Prefill (``TRAIN_RULES``) and decode (``DECODE_RULES``) share one parameter
layout; decode shards each attention cache's sequence over "model".  On the
host mesh (every axis of size 1) each step computes what the one-device
step does, bit for bit.

:class:`DistConfig` keeps the reference's fields but ``q_chunk`` and
``kv_chunk``: they pick between attention branches that compute the same
function, and the port sends both to one K3 call.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch

from ..configs.base import ModelConfig, pad_for_tp
from ..models import transformer as T
from ..models.layers import Ctx
from ..models.params import tree_leaves
from ..optim import adamw
from ..parallel import sharding as shd


@dataclasses.dataclass(frozen=True)
class DistConfig:
    """Distribution knobs, the reference's fields."""

    sharding_mode: str = "tp"  # tp (Megatron, baseline) | fsdp
    seq_parallel: bool = False
    decode_seqpar: bool = True  # flash-decode cache seq-sharding
    remat: bool = True
    compress_int8: bool = False
    moe_dedup: bool = False
    moe_dest_k: float | None = None
    lr: float = 3e-4


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _tp(mesh) -> int:
    """The size of the "model" axis (1 without a mesh)."""
    return shd.model_size(mesh) if mesh is not None else 1


def make_ctx(cfg: ModelConfig, mesh, phase: str, dist: DistConfig) -> Ctx:
    """The model's context for ``phase`` (train | prefill | decode) on
    ``mesh`` (None: one device), with the rule set the reference derives."""
    rules = shd.rules_for(cfg, phase, seq_parallel=dist.seq_parallel,
                          sharding_mode=dist.sharding_mode)
    return Ctx(
        rules=rules,
        dtype=_dtype(cfg.activation_dtype),
        mesh=mesh,
        decode_seqpar=dist.decode_seqpar,
        remat=dist.remat and cfg.remat,
        moe_dedup=dist.moe_dedup,
        moe_dest_k=dist.moe_dest_k,
    )


def batch_axes(batch_tree: Mapping[str, Any]) -> dict:
    """Logical axes for a batch dict by array rank."""

    def axes(v):
        return {1: ("batch",), 2: ("batch", "seq"), 3: ("batch", "seq", "embed")}[len(v.shape)]

    return {k: axes(v) for k, v in batch_tree.items()}


def shardings_for_batch(batch_tree, mesh, rules) -> dict:
    """{key: NamedSharding} of a batch dict (anything with ``.shape``): the
    batch dimension over the data axes that divide it, the rest whole.
    Unlike the reference's, the sequence stays whole under sequence
    parallelism: the vocab-parallel embedding and CE read every token of
    the sequence on each rank of "model", and the model takes the rank's
    slice after the lookup (:meth:`~repro_torch.models.layers.Ctx.cs`)."""
    return {k: shd.NamedSharding(mesh, shd.spec_for(a[:1], rules, mesh, batch_tree[k].shape))
            for k, a in batch_axes(batch_tree).items()}


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------


def _reduce_axes(spec: tuple, mesh) -> tuple[str, ...]:
    """The mesh axes above 1 that a leaf of ``spec`` is replicated on."""
    used = shd.spec_axes(spec)
    return tuple(a for a in mesh.axis_names if mesh.shape[a] > 1 and a not in used)


def sum_replicated_grads(grads: list, specs: list, mesh) -> None:
    """Sum each gradient over the mesh axes its leaf is replicated on, in
    place: the ranks' shares of the global gradient (each rank seeds its
    backward with 1 / world size of the loss, and every collective's
    backward is its transpose, :mod:`repro_torch.launch.mesh`).  For data
    parallelism this is the all-reduce GSPMD inserts; over "model" it
    completes the leaves the ranks use on their own blocks (norm scales
    under sequence parallelism, the router on each rank's tokens, RWKV-6's
    output norm on its heads).  Leaves sharing the axes and dtype go in
    one flat all-reduce."""
    buckets: dict = {}
    for g, spec in zip(grads, specs):
        axes = _reduce_axes(spec, mesh)
        if axes:
            buckets.setdefault((axes, g.dtype), []).append(g)
    for (axes, _), gs in buckets.items():
        flat = torch.cat([g.reshape(-1) for g in gs])
        for a in axes:
            flat = mesh.psum(flat, a)
        for g, part in zip(gs, flat.split([g.numel() for g in gs])):
            g.copy_(part.view_as(g))


def make_train_step(cfg: ModelConfig, mesh, dist: DistConfig = DistConfig(),
                    opt_cfg: adamw.AdamWConfig | None = None):
    """Returns (train_step, param_specs, opt_specs, ctx).

    ``train_step(params, opt_state, batch)`` takes the gradient of
    :func:`~repro_torch.models.transformer.lm_loss` by autograd and applies
    one AdamW step under the reference's cosine schedule (100 warm-up steps
    of 10000).  It updates ``params`` and ``opt_state`` in place (the
    reference's jitted step donates both) and returns (params, opt_state,
    metrics), the metrics being the loss, ``ce``, ``aux``, ``n_tok`` and
    ``grad_norm`` as tensors on the device, read by no host code here.

    On a mesh the trees and the batch are the rank's blocks under
    :func:`~repro_torch.parallel.sharding.tree_shardings` and
    :func:`shardings_for_batch` of the returned specs and ``ctx.rules``;
    the config is padded for the model axis
    (:func:`repro_torch.configs.base.pad_for_tp`), as the specs are.  The
    loss is the global batch's (normalised by the global token count),
    every gradient is summed over the axes its leaf is replicated on
    (:func:`sum_replicated_grads`), and the clip's norm is the global one,
    so the step is the unsharded step's."""
    opt_cfg = opt_cfg or adamw.AdamWConfig(
        lr=dist.lr, state_dtype=_dtype(cfg.optstate_dtype), compress_int8=dist.compress_int8)
    tp = _tp(mesh)
    cfg = pad_for_tp(cfg, tp)
    ctx = make_ctx(cfg, mesh, "train", dist)
    param_specs = T.model_param_specs(cfg, tp=tp)
    opt_specs = adamw.state_specs(param_specs, opt_cfg)
    multi = mesh is not None and mesh.size > 1
    specs = ([s.spec for s in tree_leaves(shd.tree_shardings(param_specs, mesh, ctx.rules))]
             if multi else None)

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        live = [p.detach().requires_grad_(p.is_floating_point()) for p in leaves]
        it = iter(live)
        grad_params = _rebuild(params, it)
        with torch.enable_grad():
            loss, metrics = T.lm_loss(grad_params, batch, cfg, ctx)
            wrt = [p for p in live if p.requires_grad]
            seed = loss / mesh.size if multi else loss
            grads = torch.autograd.grad(seed, wrt, allow_unused=True, materialize_grads=True)
        if multi:
            sum_replicated_grads(list(grads), [s for s, p in zip(specs, leaves)
                                               if p.is_floating_point()], mesh)
        it = iter(grads)
        grad_tree = _rebuild(params, (next(it) if p.is_floating_point() else None
                                      for p in leaves))
        lr_scale = adamw.cosine_schedule(opt_state["step"] + 1, warmup=100, total=10000)
        params, opt_state, om = adamw.apply_updates(
            params, grad_tree, opt_state, opt_cfg, lr_scale=lr_scale,
            specs=_rebuild(params, iter(specs)) if multi else None, mesh=mesh)
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


def _decode_rules(cfg: ModelConfig, mesh, dist: DistConfig, cache_len: int) -> dict:
    """Decode's rule set: ``DECODE_RULES``, each attention cache's
    sequence over "model" where ``decode_seqpar`` asks and the model axis
    divides ``cache_len``, else the caches split by heads."""
    rules = shd.rules_for(cfg, "decode")
    if not (dist.decode_seqpar and cache_len % shd.model_size(mesh) == 0):
        rules["cache_seq"] = None
    return rules


def make_prefill_step(cfg: ModelConfig, mesh=None, dist: DistConfig = DistConfig(),
                      cache_len: int | None = None):
    """Returns (prefill_step, param_specs, ctx); ``prefill_step(params,
    batch)`` is :func:`~repro_torch.models.transformer.prefill` of the
    config padded for the model axis, returning (caches, logits).

    On a mesh ``params`` and ``batch`` are the rank's blocks (as for the
    train step), the logits are its data block's over the whole padded
    vocabulary, and the caches are its blocks in the layout
    :func:`make_decode_step` reads (:func:`~repro_torch.models.transformer.
    shard_caches`: one all-to-all over "model" per attention cache)."""
    tp = _tp(mesh)
    cfg = pad_for_tp(cfg, tp)
    ctx = make_ctx(cfg, mesh, "prefill", dist)
    param_specs = T.model_param_specs(cfg, tp=tp)

    def prefill_step(params, batch):
        caches, logits = T.prefill(params, batch, cfg, ctx, cache_len=cache_len)
        if tp > 1:
            S = cache_len or batch["tokens"].shape[1] + (
                batch["patch_embeds"].shape[1] if cfg.vlm else 0)
            caches = T.shard_caches(caches, T.cache_specs(cfg, 1, S, tp=tp), mesh, ctx.rules,
                                    _decode_rules(cfg, mesh, dist, S))
        return caches, logits

    return prefill_step, param_specs, ctx


def make_decode_step(cfg: ModelConfig, mesh, dist: DistConfig, batch: int, cache_len: int):
    """Returns (decode_step, param_specs, cache_specs, ctx);
    ``decode_step(params, cache, tokens, pos)`` is
    :func:`~repro_torch.models.transformer.decode_step` of the config padded
    for the model axis.  On a mesh the parameters are laid out as for
    prefill, each cache is the rank's block under the returned context's
    rules (``DECODE_RULES``: each attention cache's sequence over "model"),
    and ``tokens`` and the logits (over the whole padded vocabulary) are
    its data block's."""
    tp = _tp(mesh)
    cfg = pad_for_tp(cfg, tp)
    ctx = make_ctx(cfg, mesh, "decode", dist)
    if mesh is not None:
        rules = _decode_rules(cfg, mesh, dist, cache_len)
        ctx = dataclasses.replace(ctx, rules=rules,
                                  decode_seqpar=rules["cache_seq"] == "model")
    param_specs = T.model_param_specs(cfg, tp=tp)
    cache_spec_tree = T.cache_specs(cfg, batch, cache_len, tp=tp)

    def decode_step(params, cache, tokens, pos):
        return T.decode_step(params, cache, tokens, pos, cfg, ctx)

    return decode_step, param_specs, cache_spec_tree, ctx


def replicated(mesh) -> shd.NamedSharding:
    """A tensor whole on every rank of ``mesh``."""
    return shd.NamedSharding(mesh, ())
