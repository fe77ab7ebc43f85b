"""Parameter specification: shapes, init recipes, and the two ways a tree
of real tensors is made from them (the port of ``repro/models/params.py``).

Models define their parameters as (nested dicts of) :class:`P` specs:
shape, dtype, *logical axis names* and an init recipe.  ``init_params``
draws real tensors from an explicit :class:`torch.Generator` with the
reference's init rules; ``params_from_numpy`` carries the reference's own
arrays across, so the parity tests run both packages on the same weights;
``eval_specs`` stands ``meta`` tensors in for them (the dry run);
``logical_axes`` is the axis-name tree that
:mod:`repro_torch.parallel.sharding` maps onto a mesh.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class P:
    """One parameter: shape, logical axes (one name or None per dim), dtype
    and init recipe."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    dtype: torch.dtype = torch.float32
    init: str = "normal"  # normal | zeros | ones | embed | small
    scale: float | None = None  # override init stddev

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


def _fan_in(shape: tuple[int, ...]) -> int:
    # all-but-last dims are treated as input dims for scaled init
    if len(shape) <= 1:
        return max(shape[0] if shape else 1, 1)
    return max(math.prod(shape[:-1]), 1)


def init_array(spec: P, generator: torch.Generator) -> torch.Tensor:
    device = generator.device
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "embed":
        std = spec.scale if spec.scale is not None else 0.02
    else:
        std = spec.scale if spec.scale is not None else 1.0 / math.sqrt(_fan_in(spec.shape))
        if spec.init == "small":
            std *= 0.1
    x = torch.randn(spec.shape, generator=generator, device=device, dtype=torch.float32)
    return x.mul_(std).to(spec.dtype)


def tree_map(fn, tree, *rest):
    """Apply ``fn`` to every leaf (anything but a dict) of a nested dict, and
    to the leaves at the same places of the trees in ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in the reference's order (``jax.tree.leaves`` sorts dict keys)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def init_params(tree, generator: torch.Generator, dtype: torch.dtype | None = None):
    """Materialize a spec tree into real tensors on ``generator.device``,
    leaf by leaf in the reference's order (deterministic in the generator's
    seed; the values differ from ``jax.random``'s).

    With ``dtype``, each leaf that :func:`cast_params` would cast is cast as
    soon as it is drawn: the same bits as ``cast_params(init_params(tree,
    generator), dtype)``, while the tree never exists in f32 (at most one
    f32 leaf beside the cast ones).  On a CUDA device the allocator's cache
    is then emptied: the block that held the largest f32 leaf, split later
    by small tensors, would leave no room for a large one."""

    def walk(t, name=None):
        if not isinstance(t, dict):
            leaf = init_array(t, generator)
            return leaf if dtype is None else _cast(name, leaf, dtype)
        made = {k: walk(t[k], k) for k in sorted(t)}
        return {k: made[k] for k in t}

    params = walk(tree)
    if dtype is not None and generator.device.type == "cuda":
        torch.cuda.empty_cache()
    return params


def params_from_numpy(tree, device) -> dict:
    """The reference's parameter tree, converted leaf by leaf with
    ``np.asarray``, as tensors on ``device`` (the same bits, bf16 included;
    the stacked ``"unit"`` axis is kept).  Any nested dict of arrays carries
    across the same way: the reference's AdamW state (its int32 step, the
    {"m", "v"} moments, the bf16 errors), whose spec tree is
    :func:`repro_torch.optim.adamw.state_specs`."""

    def one(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
        return torch.from_numpy(a.copy()).to(device)

    return tree_map(one, tree)


# parameters the model reads in float32 wherever it uses them (norm scales,
# the RWKV decay and bonus, the RWKV output group norm, Mamba's A_log, D and
# dt_bias); every other floating parameter is cast to the activation dtype at
# each use
F32_PARAMS = frozenset({"scale", "w0", "w_b", "u", "ln_out_scale", "ln_out_bias",
                        "A_log", "D", "dt_bias"})


def _cast(name, leaf: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if name in F32_PARAMS or not leaf.is_floating_point():
        return leaf
    return leaf.to(dtype)


def cast_params(tree, dtype: torch.dtype) -> dict:
    """Cast once, at load, what the model would cast to the activation
    ``dtype`` at every use (``p["wq"].to(x.dtype)``): the same bits, without
    a fresh copy of every weight in every step.  Leaves named in
    :data:`F32_PARAMS` keep their dtype."""

    def walk(t):
        return {k: walk(v) if isinstance(v, dict) else _cast(k, v, dtype)
                for k, v in t.items()}

    return walk(tree)


def eval_specs(tree, param_dtype: torch.dtype | None = None):
    """A tree of ``meta`` tensors of the specs' shapes and dtypes (floating
    ones in ``param_dtype`` where given): the dry run's stand-ins, which
    allocate nothing."""

    def make(spec: P):
        dt = spec.dtype
        if param_dtype is not None and dt.is_floating_point:
            dt = param_dtype
        return torch.empty(spec.shape, dtype=dt, device="meta")

    return tree_map(make, tree)


def logical_axes(tree):
    """Tree of logical-axis tuples, same structure as the spec tree."""
    return tree_map(lambda s: s.axes, tree)


def count_params(tree) -> int:
    """Elements in a spec tree."""
    return sum(math.prod(s.shape) for s in tree_leaves(tree))

