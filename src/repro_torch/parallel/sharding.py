"""Logical-axis sharding rules -> each rank's blocks (the port of
``repro/parallel/sharding.py``).

Every tensor in the framework carries *logical* axis names ("embed",
"heads", "experts", ...); a rule set maps logical names onto mesh axes per
execution context (train vs decode use different mappings).  Rules may map
a logical axis to a mesh axis name, a tuple of mesh axes, or None
(replicated).  Mesh axes already consumed by an earlier dimension of the
same tensor are dropped.

The reference hands its specs to XLA as ``NamedSharding``s.  In the port
each process is one rank of a :class:`~repro_torch.launch.mesh.Mesh` and
holds its own blocks: :func:`spec_for` gives the reference's
``PartitionSpec`` contents as a tuple, and :func:`block` cuts a whole tensor
into this rank's block by it (the port of ``jax.device_put(x,
NamedSharding)``); :func:`gather` is its inverse, differentiable, and
:func:`constraint` is where an activation's layout changes.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import torch

# Default rule sets -----------------------------------------------------------
# Mesh axes: ("pod",) "data", "model".  DP over (pod, data); TP/EP over model.

TRAIN_RULES: dict[str, object] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,            # activation d_model axis
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",           # ffn hidden
    "vocab": "model",
    "experts": "model",
    "expert_mlp": None,
    "layers": None,           # stacked unit axis
    "mamba_inner": "model",
    "rwkv_heads": "model",
    "kv_lora": None,
    "q_lora": None,
    "seq_shard": "model",     # sequence axis when explicitly seq-parallel
    "frames": None,
}

# FSDP variant: weight "embed"/replicated dims additionally sharded over data.
FSDP_EXTRA = {
    "embed_fsdp": "data",     # weights' d_model axis under FSDP
    "expert_mlp": "data",
}

DECODE_RULES = dict(TRAIN_RULES)
DECODE_RULES.update({
    "cache_seq": "model",     # flash-decode: KV cache sequence-sharded
    "batch": ("pod", "data"),
})

# FSDP (ZeRO-3) rule set: weights shard over "model" on their d_model axis
# and are all-gathered per layer; the batch stays on the dp axes; the
# embedding/LM-head keep their vocab sharding (the CE never gathers the
# vocab matrix).
FSDP_RULES: dict[str, object] = {
    **TRAIN_RULES,
    "heads": None, "kv_heads": None, "mlp": None,
    "mamba_inner": None, "rwkv_heads": None,
    "embed_fsdp": "model",
    "vocab": "model",
    "experts": "model",     # EP keeps its expert sharding under FSDP
}


def spec_for(axes: Sequence[str | None], rules: Mapping[str, object], mesh,
             shape: Sequence[int] | None = None) -> tuple:
    """The partition spec of one tensor's logical axes under ``rules``: one
    entry per dimension (a mesh axis, a tuple of them, or None), trailing
    Nones dropped; the reference's ``PartitionSpec`` contents.

    When ``shape`` is given, mesh axes that do not evenly divide the
    corresponding dimension are dropped (greedy prefix: batch=8 on a
    (pod=2, data=16) mesh keeps only "pod").  ``mesh`` is read only for its
    ``axis_names`` and ``shape``."""
    used: set[str] = set()
    out = []
    mesh_axes = set(mesh.axis_names)

    def resolve(name, dim):
        if name is None:
            return None
        r = rules.get(name, None)
        if r is None:
            return None
        if isinstance(r, str):
            r = (r,)
        picked = []
        rem = dim
        for a in r:
            if a not in mesh_axes or a in used:
                continue
            n = mesh.shape[a]
            if rem is not None:
                if rem % n != 0:
                    break  # greedy prefix: stop at first non-divisible axis
                rem //= n
            picked.append(a)
            used.add(a)
        if not picked:
            return None
        return tuple(picked) if len(picked) > 1 else picked[0]

    for i, name in enumerate(axes):
        dim = shape[i] if shape is not None else None
        out.append(resolve(name, dim))
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry, in order."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec: tuple) -> set[str]:
    """Every mesh axis a spec shards over."""
    return {a for e in spec for a in entry_axes(e)}


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the port's ``jax.sharding.NamedSharding``."""

    mesh: object
    spec: tuple


def tree_shardings(spec_tree, mesh, rules: Mapping[str, object]):
    """Map a tree of P-specs (shape + logical axes) to a tree of
    :class:`NamedSharding` on ``mesh``."""
    return _map(lambda s: NamedSharding(mesh, spec_for(s.axes, rules, mesh, s.shape)),
                spec_tree)


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def shard_tree(tree, shardings):
    """This rank's block of every leaf of a whole tree under a tree of
    :class:`NamedSharding` (the port of ``jax.device_put(tree,
    shardings)``): a copy where a leaf is split, so the whole one can be
    freed, the leaf itself where it is not."""
    def one(x, sh):
        b = block(x, sh.spec, sh.mesh)
        return x if b is x else b.clone()

    return _map(one, tree, shardings)


def _coord(mesh, axes: tuple[str, ...]) -> tuple[int, int]:
    """(this rank's row-major index over ``axes``, their product)."""
    idx, n = 0, 1
    for a in axes:
        idx = idx * mesh.shape[a] + mesh.axis_index(a)
        n *= mesh.shape[a]
    return idx, n


def block(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of the whole tensor ``x`` under ``spec``: along each
    dimension whose entry names mesh axes, the slice at the rank's row-major
    coordinate over them (a view; ``x`` itself where nothing is sharded)."""
    for dim, entry in enumerate(spec):
        idx, n = _coord(mesh, entry_axes(entry))
        if n > 1:
            if x.shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {n}")
            size = x.shape[dim] // n
            x = x.narrow(dim, idx * size, size)
    return x


def gather(x: torch.Tensor, spec: tuple, mesh, dims: Sequence[int] | None = None
           ) -> torch.Tensor:
    """The whole tensor from each rank's block under ``spec`` (all of its
    sharded dimensions, or those in ``dims``): one all-gather per mesh
    axis, the minor one first, differentiable (its backward is a
    reduce-scatter)."""
    for dim, entry in enumerate(spec):
        if dims is not None and dim not in dims:
            continue
        for a in reversed(entry_axes(entry)):
            x = mesh.all_gather(x, a, dim)
    return x


def _dim_of(spec: tuple, axis: str) -> int | None:
    """The dimension whose entry of ``spec`` is ``axis`` alone (None where
    no entry names it)."""
    for dim, entry in enumerate(spec):
        axes = entry_axes(entry)
        if axis in axes:
            if len(axes) > 1:
                raise ValueError(f"{axis!r} shares dim {dim} of {spec} with other axes")
            return dim
    return None


def reshard(x: torch.Tensor, src: tuple, dst: tuple, mesh, axis: str = "model"
            ) -> torch.Tensor:
    """This rank's block under ``dst`` from its block ``x`` under ``src``,
    where the two specs differ only in where ``axis`` splits the tensor:
    from one dimension to another one all-to-all over ``axis`` (each rank
    sends block j of the new dimension to coordinate j and concatenates
    what it receives along the old one), onto a dimension that was whole
    a slice."""
    i, j = _dim_of(src, axis), _dim_of(dst, axis)
    n = mesh.shape[axis]
    if i == j or n == 1:
        return x
    if j is None:
        raise ValueError(f"{axis!r} splits dim {i} of {src} and none of {dst}")
    if i is None:
        return block(x, tuple(axis if d == j else None for d in range(j + 1)), mesh).clone()
    if x.shape[j] % n:
        raise ValueError(f"dim {j} of {tuple(x.shape)} does not split over {n}")
    parts = x.unflatten(j, (n, x.shape[j] // n)).movedim(j, 0).contiguous()
    return torch.cat(mesh.all_to_all(parts, axis).unbind(0), dim=i)


def constraint(x, axes: Sequence[str | None], rules: Mapping[str, object] | None, mesh=None):
    """Where an activation's layout changes: ``x`` holds the rank's block of
    the batch ("batch" is the data block every activation enters with) and
    is whole along its other dimensions; returns the rank's block of each
    of those that ``rules`` shard (under sequence parallelism, its slice of
    the sequence).  Without a mesh or rules it returns ``x``, as the
    reference's does without an ambient mesh."""
    if mesh is None or rules is None:
        return x
    spec = spec_for([None if a == "batch" else a for a in axes], rules, mesh, x.shape)
    return block(x, spec, mesh)


def rules_for(cfg, phase: str = "train", *, seq_parallel: bool = False,
              sharding_mode: str = "tp") -> dict:
    """Rule set for one (config, phase).  ``phase``: train|prefill|decode.

    ``sharding_mode``: "tp" (Megatron tensor parallel over "model") or
    "fsdp" (ZeRO-3).  ``seq_parallel``: shard the activation sequence axis
    over "model" (converts the TP all-reduces into reduce-scatter /
    all-gather pairs and splits norm/elementwise work)."""
    if sharding_mode == "fsdp" and phase != "decode":
        rules = dict(FSDP_RULES)
        if getattr(cfg, "fsdp", False):
            rules["embed_fsdp"] = ("model", "data")
        return rules
    rules = dict(DECODE_RULES if phase == "decode" else TRAIN_RULES)
    rules["embed_fsdp"] = "data" if getattr(cfg, "fsdp", False) else None
    if seq_parallel and phase != "decode":
        rules["seq"] = "model"
    return rules


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel mesh axes present in this mesh."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def model_size(mesh) -> int:
    """The size of the "model" axis (1 where the mesh has none)."""
    return mesh.shape.get("model", 1)


def batch_block(mesh, B: int) -> slice:
    """This rank's block of a batch of ``B``: sharded over the data-parallel
    axes that divide it, taken in order, and replicated over the others, as
    the reference's flash decode shards its batch (a batch of 1 replicates
    over every data axis)."""
    n, idx, rem = 1, 0, B
    for a in dp_axes(mesh):
        size = mesh.shape[a]
        if rem % size == 0:
            idx = idx * size + mesh.axis_index(a)
            n *= size
            rem //= size
    return slice(idx * (B // n), (idx + 1) * (B // n))
