"""FLOP, memory-traffic and peak-memory counts of one traced step (the port of
``repro/launch/flops.py``).

The reference walks the jaxpr of a step.  The port has no jaxpr: it runs
the step once, eagerly, under a ``TorchDispatchMode`` (:class:`StepTrace`)
that sees every op the step dispatches below autograd: each aten op of the
forward, of the backward autograd runs, and of the recompute a remat'd
region runs inside that backward; each of the port's kernel regions
(``torch.ops.repro_torch.*``, :mod:`repro_torch.kernels.ops`) as one op;
each ``torch.distributed`` collective (``c10d.*``).  On ``meta`` tensors
(the dry run, :mod:`repro_torch.launch.dryrun`) nothing is computed or
allocated.  A torch step has no scan to multiply: a loop runs its body
each time, and each run is seen.

The counts (the fields of :func:`trace_step`'s :class:`StepTrace`):

* **FLOPs** (``flops``): matmuls and convolutions exactly
  (``torch.utils.flop_counter``'s formulas: 2 m n k a product); the kernel
  regions by :data:`repro_torch.kernels.ops.REGION_FLOPS` (K3 over every
  block of its square, as the reference counts its ``fusedkernel``
  regions); a reduction one FLOP per element it reads, a sort n log2 n;
  the ops of the reference's ``_ELEMENTWISE_2X`` set two per output
  element, views, copies, indexing, comparisons and the rest of its
  ``_FREE`` set none, every other op one per output element.
* **Memory traffic** (``mem_bytes``, the reference's fusion-optimistic
  model): the inputs plus outputs of the ops that must
  touch memory (the reference's ``_MEM_HEAVY``: products, gathers and
  scatters, cache writes, sorts, cumulative sums, reductions) and of the
  kernel regions, whose internals stay on chip; elementwise chains are
  taken as fused into their producers.
* **Peak live bytes** (``peak``): a liveness walk over
  storages: the arguments' bytes live throughout, each op's new output
  storage added when it appears and taken off when its last reference dies
  (a ``weakref.finalize`` on the storage), so tensors autograd saves for
  the backward stay live until the backward frees them.  All of it is the
  rank's own: the step traced is one rank's.
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from collections import Counter

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

# the reference's _ELEMENTWISE_2X, by aten name
_ELEMENTWISE_2X = {"exp", "log", "tanh", "sigmoid", "rsqrt", "sqrt", "erf", "sin", "cos",
                   "pow"}
# the reference's _FREE (and the views and allocations it has no primitive
# for), by aten name
_FREE = {
    "view", "_unsafe_view", "reshape", "expand", "permute", "transpose", "t", "squeeze",
    "unsqueeze", "slice", "select", "narrow", "alias", "as_strided", "detach", "unbind",
    "split", "split_with_sizes", "chunk", "unflatten", "movedim", "view_as", "diagonal",
    "clone", "_to_copy", "copy_", "copy", "contiguous", "cat", "stack", "constant_pad_nd",
    "index", "_unsafe_index", "index_select", "gather", "embedding", "take", "scatter",
    "scatter_", "scatter_add", "scatter_add_", "index_put", "index_put_", "_index_put_impl_",
    "index_copy", "index_copy_", "index_add", "index_add_", "slice_scatter", "select_scatter",
    "where", "masked_fill", "masked_fill_", "eq", "ne", "ge", "gt", "le", "lt",
    "logical_and", "logical_or", "logical_not", "logical_xor", "bitwise_and", "bitwise_or",
    "bitwise_not", "bitwise_xor", "sign", "isfinite", "arange", "zeros", "ones", "full",
    "empty", "empty_like", "zeros_like", "ones_like", "full_like", "new_zeros", "new_ones",
    "new_empty", "new_full", "empty_strided", "new_empty_strided", "fill_", "fill", "zero_",
    "lift_fresh", "lift_fresh_copy", "argmax", "argmin", "clamp", "clamp_min", "clamp_max",
    "round", "floor", "ceil", "remainder", "fmod", "one_hot", "repeat", "repeat_interleave",
    "flip", "roll", "tril", "triu", "_local_scalar_dense", "scalar_tensor", "resize_",
}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod", "cumsum", "cumprod",
               "logsumexp", "var", "std", "var_mean", "norm", "linalg_vector_norm", "any",
               "all"}
# the reference's _MEM_HEAVY (products, gathers, scatters, cache writes,
# sorts, cumulative sums) by aten name; reductions are heavy too
_MEM_HEAVY = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "convolution", "_convolution",
              "convolution_backward", "index", "_unsafe_index", "index_select", "gather",
              "embedding", "take", "scatter", "scatter_", "scatter_add", "scatter_add_",
              "index_put", "index_put_", "_index_put_impl_", "index_copy", "index_copy_",
              "index_add", "index_add_", "slice_scatter", "select_scatter", "sort",
              "cumsum"} | _REDUCTIONS
# c10d ops -> the reference's collective kinds
_COLLECTIVES = {"allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
                "allgather_": "all-gather", "_allgather_base_": "all-gather",
                "allgather_into_tensor_coalesced_": "all-gather",
                "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
                "reduce_scatter_tensor_coalesced_": "reduce-scatter",
                "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
                "broadcast_": "collective-permute", "send": "collective-permute",
                "recv_": "collective-permute"}


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x) -> list[torch.Tensor]:
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _group_name(args) -> str | None:
    """The name of the process group a c10d op runs over."""
    for a in args:
        if isinstance(a, torch.ScriptObject) and a._type().name() == "ProcessGroup":
            return dist.ProcessGroup.unbox(a).group_name
        if isinstance(a, dist.ProcessGroup):
            return a.group_name
    return None


@dataclasses.dataclass
class Collective:
    """One collective of a traced step: its kind (the reference's names),
    its wire bytes (the reference's model: an all-reduce moves twice its
    payload, the others their output once), its process group and a short
    description."""

    kind: str
    wire_bytes: int
    group: str | None
    desc: str


class StepTrace(TorchDispatchMode):
    """Counts what the ops dispatched under it compute and move (see the
    module's docstring).  Use as a context manager around one step, after
    :meth:`hold` of the step's arguments."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.mem_bytes = 0.0     # the fusion-optimistic traffic
        self.io_bytes = 0.0      # every op's inputs and outputs, unfused
        self.collectives: list[Collective] = []
        self.op_counts: Counter = Counter()
        self.live = 0
        self.peak = 0
        self._storages: dict[int, int] = {}

    def hold(self, *args) -> StepTrace:
        """Count the storages of ``args`` live for the whole step."""
        for t in _tensors(args):
            key = t.untyped_storage()._cdata
            if key not in self._storages:
                self._storages[key] = -1                      # never freed
                self.live += t.untyped_storage().nbytes()
        self.peak = max(self.peak, self.live)
        return self

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._storages:
                continue
            n = st.nbytes()
            self._storages[key] = n
            self.live += n
            weakref.finalize(st, self._free, key)
        self.peak = max(self.peak, self.live)

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns, name = func.namespace, func._schema.name.split("::")[-1]
        self.op_counts[f"{ns}.{name}"] += 1
        if ns == "c10d":
            kind = _COLLECTIVES.get(name)
            if kind is not None:
                payload = _tensors(args[0])
                nbytes = sum(_bytes(t) for t in payload)
                t0 = payload[0]
                desc = f"{kind} {str(t0.dtype).removeprefix('torch.')}{list(t0.shape)}"
                self.collectives.append(Collective(kind, nbytes * (2 if kind == "all-reduce"
                                                                   else 1),
                                                   _group_name(args), desc))
            return out
        self._track(out)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        io = sum(_bytes(t) for t in ins) + sum(_bytes(t) for t in outs)
        packet = func._overloadpacket
        if ns == "repro_torch":                             # a kernel region
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
            self.mem_bytes += io
            self.io_bytes += io
            return out
        if not func.is_view:
            self.io_bytes += io
        if name in _MEM_HEAVY:
            self.mem_bytes += io
        if name in _FREE or name.rstrip("_") in _FREE:
            return out
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        elif name in _REDUCTIONS:
            self.flops += max(ins[0].numel(), 1) if ins else 0
        elif name == "sort":
            n = max(ins[0].numel(), 1)
            self.flops += n * max(int(math.log2(max(n, 2))), 1)
        else:
            n = sum(t.numel() for t in outs)
            self.flops += 2 * n if name.rstrip("_") in _ELEMENTWISE_2X else n
        return out


def trace_step(fn, *args) -> tuple[object, StepTrace]:
    """Run ``fn(*args)`` once under a :class:`StepTrace` holding the
    arguments live; returns (its output, the trace)."""
    with StepTrace().hold(*args) as trace:
        out = fn(*args)
    return out, trace

