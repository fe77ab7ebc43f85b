"""Wrapper of the CUDA matmul kernel (``csrc/matmul.cu``), the port of the
Pallas TPU kernel ``repro/kernels/matmul.py::matmul``.

``(M, K) @ (K, N) -> (M, N)`` for float32 or bfloat16 CUDA tensors, with an
f32 accumulator and the output in ``a.dtype``.  Operands are read through
their strides, so a transposed view costs no copy; any shape is taken (the
kernel masks its ragged edges).
"""

from __future__ import annotations

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2**31 - 1


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the kernel; raises on an input it does not take."""
    if not (a.is_cuda and b.is_cuda) or a.device != b.device:
        raise ValueError(f"matmul kernel needs both operands on one CUDA device, "
                         f"got {a.device} and {b.device}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"matmul kernel takes float32 or bfloat16 pairs, "
                        f"got {a.dtype} and {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul kernel needs (M, K) @ (K, N), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    M, K = a.shape
    N = b.shape[1]
    if max(M, N, K) > _INT_MAX:
        raise ValueError(f"matmul kernel dimensions must fit int32: {(M, K, N)}")
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if M == 0 or N == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.repro_matmul(_DTYPES[a.dtype], a.data_ptr(), b.data_ptr(),
                               out.data_ptr(), M, N, K, a.stride(0), a.stride(1),
                               b.stride(0), b.stride(1), stream)
    _build.check(err, "matmul")
    matmul.launches += 1
    return out


matmul.launches = 0  # kernel launches since the last reset to 0
