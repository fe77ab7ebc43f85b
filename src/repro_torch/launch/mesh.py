"""Device meshes over ``torch.distributed`` (the port of
``repro/launch/mesh.py``): the reference's production meshes, its host mesh,
``make_mesh`` for any shape, and the roofline constants of one GPU that the
dry run's terms divide by.

A :class:`Mesh` names the axes of a ``DeviceMesh`` built over the process
group the caller started, and keeps the reference's view of it: ``shape``
maps axis names to sizes.  Its collectives take the names of the
reference's ``jax.lax`` ones (``psum``, ``pmax``, ``pmean``,
``all_to_all``, ``all_gather``, ``psum_scatter``, ``axis_index``) over one
axis; over an axis of size 1 each is the identity, with no collective.
They are ``torch.distributed`` calls (gloo on the CPU, and on CUDA tensors
too; NCCL on CUDA) and, except ``pmax``, differentiable: each one's
backward is its transpose, so that a step whose ranks each seed the
backward with ``1 / world size`` of the (replicated) loss gets, on every
rank, its share of the global gradient:

  * ``psum``: an all-reduce; its backward is an all-reduce;
  * ``all_gather``: its backward is a reduce-scatter;
  * ``psum_scatter``: a reduce-scatter; its backward is an all-gather;
  * ``all_to_all``: a permutation of blocks; its backward is the reverse
    all-to-all (the same exchange).

A leaf replicated over an axis then holds a partial gradient on each rank
there, summed over that axis by the train step
(:func:`repro_torch.launch.steps.make_train_step`).  Under ``torch.no_grad``
(the serving paths) each is the forward collective alone.

  # 4 CPU processes as a (data 2, model 2) mesh, in each rank r
  torch.distributed.init_process_group("gloo", init_method="file:///tmp/rdv",
                                       rank=r, world_size=4)
  mesh = make_mesh((2, 2), ("data", "model"))
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, op=op, group=group)
    return x


def _all_gather(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _reduce_scatter(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {n}")
    parts = x.chunk(n, dim=dim)
    out = torch.empty_like(parts[0], memory_format=torch.contiguous_format)
    # the blocks one after another along dim 0, as reduce_scatter_tensor reads them
    dist.reduce_scatter_tensor(out, torch.cat([p.reshape(-1) for p in parts]).view(
        n * out.shape[0], *out.shape[1:]), group=group)
    return out


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.group, ctx.n, ctx.dim = group, n, dim
        return _all_gather(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.n, ctx.dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.group, ctx.n, ctx.dim = group, n, dim
        return _reduce_scatter(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.n, ctx.dim), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


class Mesh:
    """Named mesh axes over a ``DeviceMesh``.  ``shape`` maps each axis name
    to its size, in order.  A mesh whose axes are all of size 1 needs no
    ``DeviceMesh`` and no process group (:func:`make_host_mesh`)."""

    def __init__(self, shape: dict[str, int], device_mesh=None):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.device_mesh = device_mesh
        if device_mesh is None and self.size > 1:
            raise ValueError(f"a mesh of {self.shape} needs a DeviceMesh")

    @property
    def size(self) -> int:
        """The number of ranks."""
        return math.prod(self.shape.values())

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return 0 if self.shape[axis] == 1 else self.device_mesh.get_local_rank(axis)

    def _group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def psum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        if self.shape[axis] == 1:
            return x
        return _PSum.apply(x, self._group(axis))

    def pmax(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The largest value over ``axis``; not differentiable (its callers
        take it of values whose gradient it would not change)."""
        if self.shape[axis] == 1:
            return x
        return _all_reduce(x.detach(), self._group(axis), dist.ReduceOp.MAX)

    def pmean(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        return self.psum(x, axis) / self.shape[axis]

    def all_to_all(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``x`` (n, ...) with n the axis' size: block i goes to coordinate
        i, and block j of the result came from coordinate j (``jax.lax.
        all_to_all`` with split and concat axis 0, not tiled)."""
        n = self.shape[axis]
        if x.shape[0] != n:
            raise ValueError(f"all_to_all over {axis!r} ({n}) of a leading dim {x.shape[0]}")
        if n == 1:
            return x
        if not x.is_floating_point():
            return _all_to_all(x, self._group(axis))
        return _AllToAll.apply(x, self._group(axis))

    def all_gather(self, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """The blocks of every coordinate along ``axis``, concatenated in
        coordinate order on ``dim``."""
        n = self.shape[axis]
        if n == 1:
            return x
        if not x.is_floating_point():
            return _all_gather(x, self._group(axis), n, dim)
        return _AllGather.apply(x, self._group(axis), n, dim)

    def psum_scatter(self, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """The sum over ``axis``, of which this rank keeps its block along
        ``dim`` (``jax.lax.psum_scatter`` tiled)."""
        n = self.shape[axis]
        if n == 1:
            return x
        return _ReduceScatter.apply(x, self._group(axis), n, dim)


def make_mesh(shape, axes) -> Mesh:
    """A mesh of ``shape`` named ``axes`` over the default process group
    the caller started, whose world size is the product of ``shape``; rank
    r sits at r's row-major coordinate (``init_device_mesh``).  On NCCL
    each rank has set its CUDA device first."""
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))
    return Mesh(dict(zip(axes, shape)), dm)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production meshes over the caller's process group:
    (data 16, model 16), or (pod 2, data 16, model 16) with ``multi_pod``
    ("pod" carries only data-parallel gradient reduction).  Raises without
    a process group of that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if have != need:
        raise ValueError(f"the production mesh {dict(zip(axes, shape))} needs a process group "
                         f"of {need} ranks; this one has {have}")
    return make_mesh(shape, axes)


def make_host_mesh() -> Mesh:
    """The 1-rank (data 1, model 1) mesh of one process, which needs no
    process group: every collective on it is the identity."""
    return Mesh({"data": 1, "model": 1})


# Roofline constants of one NVIDIA H100 80GB HBM3 (SXM) at its 700 W limit:
# NVIDIA's data sheet, dense rates.  The production meshes lay "model" and
# "data" over NVLink 4 and "pod" over InfiniBand.
PEAK_FLOPS_BF16 = 989e12          # bf16 tensor-core FLOP/s
HBM_BW = 3.35e12                  # bytes/s
NVLINK_BW = 450e9                 # bytes/s each way per GPU (NVLink 4, 18 links)
IB_BW = 50e9                      # bytes/s per GPU (one 400 Gb/s NDR port)
LINK_BW = {"model": NVLINK_BW, "data": NVLINK_BW, "pod": IB_BW}
# torch.cuda.get_device_properties(0).total_memory on an
# "NVIDIA H100 80GB HBM3, 700.00 W" card (chip_smoke.py's [dryrun] prints it)
HBM_PER_CHIP = 85_017_493_504
