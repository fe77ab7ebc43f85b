"""Wrapper of the CUDA matmul kernel (``csrc/matmul.cu``), the port of the
Pallas TPU kernel ``repro/kernels/matmul.py::matmul``.

``(M, K) @ (K, N) -> (M, N)`` for float32 or bfloat16 CUDA tensors, with an
f32-accurate sum and the output in ``a.dtype``.  Operands are read through
their strides, so a transposed view costs no copy; any shape is taken (the
kernel masks its ragged edges).

The kernel has two paths, picked from the operands' layout alone
(:func:`choose_path`): ``wgmma`` (TMA-fed tensor cores: 3xTF32 in float32,
one bf16 pass in bfloat16) wherever TMA can address both operands, and
``fma`` (f32 FMAs on the CUDA cores, any strides) elsewhere.
"""

from __future__ import annotations

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2**31 - 1
PATHS = ("wgmma", "fma")
_PATH_CODE = {"fma": 0, "wgmma": 1}
_TMA_ALIGN = 16  # bytes: TMA's base address and row-stride granule


def tma_strides(rows: int, k: int, s_rows: int, s_k: int,
                itemsize: int) -> tuple[int, int] | None:
    """Strides ``(s_rows, s_k)`` of a ``rows x k`` operand as TMA takes them:
    exactly one is 1 (K-major when ``s_k`` is, else MN-major) and the other
    a positive multiple of 16 bytes that is at least its row's length, so
    rows do not overlap.  A dimension of size 1 has its stride replaced (it
    is never used).  None when TMA cannot address the operand."""
    step = _TMA_ALIGN // itemsize
    if s_k == 1 or k == 1:
        outer = s_rows if rows > 1 else -(-k // step) * step
        if outer >= k and outer % step == 0:
            return outer, 1
    if s_rows == 1 or rows == 1:
        outer = s_k if k > 1 else -(-rows // step) * step
        if outer >= rows and outer % step == 0:
            return 1, outer
    return None


def choose_path(dtype: torch.dtype, m: int, k: int, n: int,
                a_strides: tuple[int, int], b_strides: tuple[int, int],
                a_ptr: int, b_ptr: int) -> tuple[str, tuple[int, int, int, int]]:
    """-> (path, (sam, sak, sbk, sbn)) for ``A (m, k) @ B (k, n)`` from the
    dtype, the element strides and the data pointers alone: ``wgmma`` when
    TMA can address both operands (bases 16-byte aligned, each with one
    unit stride and the other a multiple of 16 bytes, K >= 1), with the
    strides normalised as :func:`tma_strides` gives them; else ``fma`` with
    the strides as they are."""
    itemsize = dtype.itemsize
    sam, sak = a_strides
    sbk, sbn = b_strides
    if k >= 1 and a_ptr % _TMA_ALIGN == 0 and b_ptr % _TMA_ALIGN == 0:
        a = tma_strides(m, k, sam, sak, itemsize)
        b = tma_strides(n, k, sbn, sbk, itemsize)
        if a is not None and b is not None:
            return "wgmma", (a[0], a[1], b[1], b[0])
    return "fma", (sam, sak, sbk, sbn)


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
    path, strides = choose_path(a.dtype, M, K, N, a.stride(), b.stride(),
                                a.data_ptr(), b.data_ptr())
    lib = _build.library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.repro_matmul(_DTYPES[a.dtype], _PATH_CODE[path], a.data_ptr(), b.data_ptr(),
                               out.data_ptr(), M, N, K, *strides, stream)
    _build.check(err, f"matmul ({path})")
    matmul.launches += 1
    matmul.launches_by_path[path] += 1
    return out


def reset_launches() -> None:
    """Set the launch counts (the total and each path's) to 0."""
    matmul.launches = 0
    matmul.launches_by_path = dict.fromkeys(PATHS, 0)


matmul.launches = 0  # kernel launches since the last reset to 0
matmul.launches_by_path = dict.fromkeys(PATHS, 0)  # the same, by path
