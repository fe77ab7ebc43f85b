"""Device meshes over ``torch.distributed`` (the port of
``repro/launch/mesh.py``'s ``make_mesh``; its production meshes and its
host mesh wait for the trainer's mesh, ROADMAP queue 1, item 9: one device
is a model context without a mesh).

A :class:`Mesh` names the axes of a ``DeviceMesh`` built over the process
group the caller started, and keeps the reference's view of it: ``shape``
maps axis names to sizes.  Its collectives take the names of the
reference's ``jax.lax`` ones (``psum``, ``pmax``, ``pmean``,
``all_to_all``, ``all_gather``, ``axis_index``) over one axis; over an axis
of size 1 each is the identity, with no collective.  They are
``torch.distributed`` calls (gloo on the CPU, NCCL on CUDA) outside
autograd: the multi-rank paths run forward only.

  # 4 CPU processes as a (data 2, model 2) mesh, in each rank r
  torch.distributed.init_process_group("gloo", init_method="file:///tmp/rdv",
                                       rank=r, world_size=4)
  mesh = make_mesh((2, 2), ("data", "model"))
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


class Mesh:
    """Named mesh axes over a ``DeviceMesh``.  ``shape`` maps each axis name
    to its size, in order."""

    def __init__(self, shape: dict[str, int], device_mesh):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.device_mesh = device_mesh

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return 0 if self.shape[axis] == 1 else self.device_mesh.get_local_rank(axis)

    def _group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def _all_reduce(self, x: torch.Tensor, axis: str, op) -> torch.Tensor:
        if self.shape[axis] == 1:
            return x
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, op=op, group=self._group(axis))
        return x

    def psum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        return self._all_reduce(x, axis, dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        return self._all_reduce(x, axis, dist.ReduceOp.MAX)

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
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self._group(axis))
        return out

    def all_gather(self, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """The blocks of every coordinate along ``axis``, concatenated in
        coordinate order on ``dim``."""
        n = self.shape[axis]
        if n == 1:
            return x
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=self._group(axis))
        return torch.cat(parts, dim=dim)


def make_mesh(shape, axes) -> Mesh:
    """A mesh of ``shape`` named ``axes`` over the default process group
    the caller started, whose world size is the product of ``shape``; rank
    r sits at r's row-major coordinate (``init_device_mesh``).  On NCCL
    each rank has set its CUDA device first."""
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))
    return Mesh(dict(zip(axes, shape)), dm)
