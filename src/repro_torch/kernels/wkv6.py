"""Wrapper of the CUDA RWKV-6 recurrence kernel (``csrc/wkv6.cu``), the port
of the Pallas TPU kernel ``repro/kernels/wkv6.py``.

``r, k, v, w (B, H, S, N)`` and ``u (H, N)``, all float32 CUDA tensors, give
the outputs ``o (B, H, S, N)`` and the final state ``(B, H, N, N)``; the
semantics are :func:`repro_torch.kernels.ref.wkv6`'s.  r, k, v and w are
read through their strides and must share them (the model passes four
``(B, S, H, N)`` tensors as ``(B, H, S, N)`` views); ``o`` is allocated in
that ``(B, S, H, N)`` layout and returned as its ``(B, H, S, N)`` view.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

HEAD_SIZES = (32, 64)
_INT_MAX = 2**31 - 1


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel; raises on an input it does not take."""
    ts = (r, k, v, w, u)
    if not all(t.is_cuda and t.device == r.device for t in ts):
        raise ValueError(f"wkv6 kernel needs r, k, v, w, u on one CUDA device, "
                         f"got {[str(t.device) for t in ts]}")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"wkv6 kernel takes float32 only, got {[t.dtype for t in ts]}")
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"wkv6 kernel needs r, k, v, w of one (B, H, S, N) shape, got "
                         f"{[tuple(t.shape) for t in (r, k, v, w)]}")
    B, H, S, N = r.shape
    if tuple(u.shape) != (H, N):
        raise ValueError(f"wkv6 kernel needs u of shape {(H, N)}, got {tuple(u.shape)}")
    if N not in HEAD_SIZES:
        raise ValueError(f"wkv6 kernel takes head size N in {HEAD_SIZES}, got {N}")
    if any(t.stride() != r.stride() for t in (k, v, w)):
        raise ValueError("wkv6 kernel needs r, k, v, w to share their strides")
    if max(B, H, S) > _INT_MAX:
        raise ValueError(f"wkv6 kernel sizes must fit int32: {(B, H, S)}")
    o = torch.empty((B, S, H, N), dtype=r.dtype, device=r.device).transpose(1, 2)
    state = torch.empty((B, H, N, N), dtype=torch.float32, device=r.device)
    if r.numel() == 0:
        return o, state.zero_()
    u = u.contiguous()
    strides = (ctypes.c_longlong * 8)(*r.stride(), *o.stride())
    lib = _build.library()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.repro_wkv6(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                             u.data_ptr(), o.data_ptr(), state.data_ptr(), B, H, S, N,
                             strides, stream)
    _build.check(err, "wkv6")
    wkv6.launches += 1
    return o, state


wkv6.launches = 0  # kernel launches since the last reset to 0
