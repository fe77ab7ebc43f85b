"""Wrapper of the CUDA matadd kernel (``csrc/matadd.cu``), the port of the
Pallas TPU kernel ``repro/kernels/matadd.py::matadd``.

Elementwise ``a + b`` in the input dtype for float32, bfloat16 or int32
CUDA tensors of any (equal) shape.  The kernel streams contiguous operands;
a non-contiguous one (a fused chain's reshape or transpose, say) is first
copied contiguous.  Which of the two the wrapper does is decided from the
layout alone (:func:`prepare`) and counted by path: ``direct`` (the caller's
tensors read in place) or ``copy``.
"""

from __future__ import annotations

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
PATHS = ("direct", "copy")


def prepare(a: torch.Tensor, b: torch.Tensor) -> tuple[str, torch.Tensor, torch.Tensor]:
    """-> (path, a, b) as the kernel reads them: the operands themselves
    when both are contiguous (``direct``), else contiguous copies of them
    (``copy``).  Device-agnostic: the tests run it on the CPU."""
    if a.is_contiguous() and b.is_contiguous():
        return "direct", a, b
    return "copy", a.contiguous(), b.contiguous()


def matadd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the kernel; raises on an input it does not take."""
    if not (a.is_cuda and b.is_cuda) or a.device != b.device:
        raise ValueError(f"matadd kernel needs both operands on one CUDA device, "
                         f"got {a.device} and {b.device}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"matadd kernel takes float32, bfloat16 or int32 pairs, "
                        f"got {a.dtype} and {b.dtype}")
    if a.shape != b.shape:
        raise ValueError(f"matadd kernel needs equal shapes, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    out = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    n = a.numel()
    if n == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(a.device):
        path, a, b = prepare(a, b)
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.repro_matadd(_DTYPES[a.dtype], a.data_ptr(), b.data_ptr(),
                               out.data_ptr(), n, stream)
    _build.check(err, f"matadd ({path})")
    matadd.launches += 1
    matadd.launches_by_path[path] += 1
    return out


def reset_launches() -> None:
    """Set the launch counts (the total and each path's) to 0."""
    matadd.launches = 0
    matadd.launches_by_path = dict.fromkeys(PATHS, 0)


matadd.launches = 0  # kernel launches since the last reset to 0
matadd.launches_by_path = dict.fromkeys(PATHS, 0)  # the same, by path
