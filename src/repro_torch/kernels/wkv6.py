"""Wrapper of the CUDA RWKV-6 recurrence kernel (``csrc/wkv6.cu``), the port
of the Pallas TPU kernel ``repro/kernels/wkv6.py``.

``r, k, v, w (B, H, S, N)`` and ``u (H, N)``, all float32 CUDA tensors, give
the outputs ``o (B, H, S, N)`` and the final state ``(B, H, N, N)``; the
semantics are :func:`repro_torch.kernels.ref.wkv6`'s.  r, k, v and w are
read through their strides and must share them (the model passes four
``(B, S, H, N)`` tensors as ``(B, H, S, N)`` views); ``o`` is allocated in
that ``(B, S, H, N)`` layout and returned as its ``(B, H, S, N)`` view.

The kernel reads r, k, v and w by TMA.  Where TMA cannot address them (an
n-stride other than 1, a stride or a base off the 16-byte granule), the
wrapper first copies them into fresh ``(B, S, H, N)`` buffers; which of the
two it does is decided from the layout alone (:func:`choose_path`) and
counted by path: ``ring`` (the caller's tensors read in place) or ``copy``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

HEAD_SIZES = (32, 64)
_INT_MAX = 2**31 - 1
PATHS = ("ring", "copy")
_TMA_ALIGN = 16  # bytes: TMA's base address and stride granule


def choose_path(shape: tuple[int, int, int, int], strides: tuple[int, int, int, int],
                ptrs: tuple[int, ...]) -> tuple[str, tuple[int, int, int, int]]:
    """-> (path, strides (b, h, s, n)) for float32 r, k, v, w of one ``(B, H,
    S, N)`` shape and one set of element strides, from the layout and the
    data pointers alone: ``ring`` when TMA can address them (n-stride 1,
    every other dimension of size above 1 with a positive stride that is a
    multiple of 16 bytes, every base 16-byte aligned), with the stride of a
    dimension of size 1 (never used) replaced by one past the tensor's span;
    else ``copy`` with the strides as they are."""
    B, H, S, N = shape
    sb, sh, ss, sn = strides
    step = _TMA_ALIGN // 4  # float32 elements
    outer = ((B, sb), (H, sh), (S, ss))
    if (sn == 1 and all(p % _TMA_ALIGN == 0 for p in ptrs)
            and all(st > 0 and st % step == 0 for n, st in outer if n > 1)):
        span = max([N] + [n * st for n, st in outer if n > 1])
        span = -(-span // step) * step
        sb, sh, ss = (st if n > 1 else span for n, st in outer)
        return "ring", (sb, sh, ss, 1)
    return "copy", (sb, sh, ss, sn)


def copy_bshn(t: torch.Tensor) -> torch.Tensor:
    """A fresh ``(B, S, H, N)`` copy of the ``(B, H, S, N)`` tensor ``t``,
    returned as its ``(B, H, S, N)`` view: the model's layout, which TMA
    addresses (the allocator aligns the base)."""
    B, H, S, N = t.shape
    out = torch.empty((B, S, H, N), dtype=t.dtype, device=t.device)
    return out.copy_(t.transpose(1, 2)).transpose(1, 2)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel; raises on an input it does not take."""
    ts = (r, k, v, w, u)
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"wkv6 kernel takes float32 only, got {[t.dtype for t in ts]}")
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"wkv6 kernel needs r, k, v, w of one (B, H, S, N) shape, got "
                         f"{[tuple(t.shape) for t in (r, k, v, w)]}")
    B, H, S, N = r.shape
    if tuple(u.shape) != (H, N):
        raise ValueError(f"wkv6 kernel needs u of shape {(H, N)}, got {tuple(u.shape)}")
    if not all(t.is_cuda and t.device == r.device for t in ts):
        raise ValueError(f"wkv6 kernel needs r, k, v, w, u on one CUDA device, "
                         f"got {[str(t.device) for t in ts]}")
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
    path, st = choose_path((B, H, S, N), r.stride(),
                           tuple(t.data_ptr() for t in (r, k, v, w)))
    lib = _build.library()
    with torch.cuda.device(r.device):
        if path == "copy":
            r, k, v, w = (copy_bshn(t) for t in (r, k, v, w))
            _, st = choose_path((B, H, S, N), r.stride(),
                                tuple(t.data_ptr() for t in (r, k, v, w)))
        strides = (ctypes.c_longlong * 8)(*st, *o.stride())
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.repro_wkv6(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                             u.data_ptr(), o.data_ptr(), state.data_ptr(), B, H, S, N,
                             strides, stream)
    _build.check(err, f"wkv6 ({path})")
    wkv6.launches += 1
    wkv6.launches_by_path[path] += 1
    return o, state


def reset_launches() -> None:
    """Set the launch counts (the total and each path's) to 0."""
    wkv6.launches = 0
    wkv6.launches_by_path = dict.fromkeys(PATHS, 0)


wkv6.launches = 0  # kernel launches since the last reset to 0
wkv6.launches_by_path = dict.fromkeys(PATHS, 0)  # the same, by path
