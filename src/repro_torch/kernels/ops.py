"""Dispatch by device: a CUDA tensor goes to the hand-written kernel (which
runs or raises), a CPU tensor to the plain PyTorch version.  There is no
switch that sends CUDA tensors anywhere else."""

from __future__ import annotations

import torch

from . import ref as _ref
from .flash_attention import HEAD_DIMS
from .flash_attention import flash_attention as _flash_kernel
from .matadd import matadd as _matadd_kernel
from .matmul import matmul as _matmul_kernel
from .wkv6 import HEAD_SIZES as WKV6_HEAD_SIZES
from .wkv6 import wkv6 as _wkv6_kernel


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.is_cuda or b.is_cuda:
        return _matmul_kernel(a, b)
    return _ref.matmul(a, b)


def matadd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.is_cuda or b.is_cuda:
        return _matadd_kernel(a, b)
    return _ref.matadd(a, b)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, kv_len: int | None = None) -> torch.Tensor:
    """q ``(B, H, Sq, hd)`` over k, v ``(B, K, Sk, hd)``, K dividing H."""
    if q.is_cuda or k.is_cuda or v.is_cuda:
        return _flash_kernel(q, k, v, causal=causal, kv_len=kv_len)
    return _ref.flash_attention(q, k, v, causal=causal, kv_len=kv_len)


def wkv6(r, k, v, w, u) -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 recurrence -> (o ``(B, H, S, N)``, final state ``(B, H, N, N)``)."""
    if any(t.is_cuda for t in (r, k, v, w, u)):
        return _wkv6_kernel(r, k, v, w, u)
    return _ref.wkv6(r, k, v, w, u)


def warm_up(device) -> None:
    """Build and load the CUDA kernels and launch each once at a tiny shape:
    K1's ``wgmma`` path in each dtype and each operand layout (K-major or
    MN-major A and B) and its ``fma`` path, K2, K3 in each dtype and head dim
    it is built for, and K4 at each head size, so that the one-time costs
    (the ``nvcc`` build, loading the library and each kernel's module, the
    shared-memory settings) stay out of a timed run.  A no-op for a CPU device."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.zeros(16, 16, device=device, dtype=dtype)
        for a in (x, x.T):
            for b in (x, x.T):
                _matmul_kernel(a, b)
        y = torch.zeros(16, 15, device=device, dtype=dtype)
        _matmul_kernel(y, y.T)  # rows of 15 elements, not 16-byte multiples: fma
    x = torch.zeros(8, 8, device=device)
    _matadd_kernel(x, x)
    for dtype in (torch.float32, torch.bfloat16):
        for hd in HEAD_DIMS:
            a = torch.zeros(1, 1, 8, hd, device=device, dtype=dtype)
            _flash_kernel(a, a, a)
    for n in WKV6_HEAD_SIZES:
        u = torch.zeros(1, n, device=device)
        _wkv6_kernel(*[torch.zeros(1, 1, 8, n, device=device)] * 4, u)
    torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# Super-step chain builder
# ---------------------------------------------------------------------------

def build_chain(steps, keep=None):
    """Compose a group's intra-group kernel chain into ONE callable.

    ``steps`` is a sequence of ``(fn, srcs)`` in topological order, where each
    ``srcs`` entry names one positional argument of ``fn``:

    * ``("ext", i)`` — the i-th *external* input of the chain (a block that
      lives outside the group-step: a host seed or another group's output);
    * ``("mem", j)`` — the output of the j-th earlier step (an intra-group
      edge; it never touches host or comm lanes).

    ``keep`` selects which step outputs the chain returns (default: all).
    Outputs that are dead after the chain — every consumer is an earlier
    ``("mem", ...)`` reference — should be omitted: XLA then fuses straight
    through them instead of materializing one buffer per kernel, which is
    most of the super-step's dispatch-overhead win.

    The returned ``chain(*ext) -> tuple(kept outputs)`` is pure and
    jit-friendly: the executor jits it once per (revision, group signature,
    shapes/dtypes) with dead external buffers donated, so a whole partition
    group runs as a single XLA computation — one async dispatch and one
    ready-barrier per group-step instead of one per kernel.
    """
    plan = [(fn, tuple(srcs)) for fn, srcs in steps]
    keep = tuple(range(len(plan))) if keep is None else tuple(keep)

    def chain(*ext):
        outs = []
        for fn, srcs in plan:
            args = [ext[i] if kind == "ext" else outs[i] for kind, i in srcs]
            outs.append(fn(*args))
        return tuple(outs[i] for i in keep)

    return chain
