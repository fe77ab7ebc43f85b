"""Wrapper of the CUDA RWKV-6 recurrence kernel (``csrc/wkv6.cu``), the port
of the Pallas TPU kernel ``repro/kernels/wkv6.py``.

``r, k, v, w (B, H, S, N)`` and ``u (H, N)``, all float32 CUDA tensors, give
the outputs ``o (B, H, S, N)`` and the final state ``(B, H, N, N)``; the
semantics are :func:`repro_torch.kernels.ref.wkv6`'s.  r, k, v and w are
read through their strides (the model passes four ``(B, S, H, N)`` tensors
as ``(B, H, S, N)`` views); ``o`` is allocated in that ``(B, S, H, N)``
layout and returned as its ``(B, H, S, N)`` view.

The kernel is built for head sizes 32 and 64 (:data:`HEAD_SIZES`) and reads
r, k, v and w by TMA through one set of strides.  What the wrapper hands it
is decided from the head size and the layout alone (:func:`prepare`) and
counted by path:

* ``ring``: the caller's tensors read in place;
* ``copy``: tensors TMA cannot address (an n-stride other than 1, a stride
  or a base off the 16-byte granule) or whose strides differ, first copied
  into fresh ``(B, S, H, N)`` buffers;
* ``pad``: a head size that is not built, zero-padded up to the next built
  one in that layout, with o and the final state cropped.  Padding is
  exact: the padded k and v entries are 0, so the state's extra rows and
  columns stay 0 and add nothing to o's first N columns.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .layout import copy_bshd

HEAD_SIZES = (32, 64)  # built; smaller head sizes are padded
_INT_MAX = 2**31 - 1
PATHS = ("ring", "copy", "pad")
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


def built_head_size(n: int) -> int:
    """The smallest built head size that holds ``n``; raises above 64."""
    for built in HEAD_SIZES:
        if n <= built:
            return built
    raise ValueError(f"wkv6 kernel takes head size N up to {HEAD_SIZES[-1]}, got {n}")


def prepare(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
            u: torch.Tensor) -> tuple[str, tuple[torch.Tensor, ...]]:
    """-> (path, (r, k, v, w, u)) as the kernel reads them, from the head
    size and the layout alone (see the module's docstring).  Device-agnostic:
    the tests run it on the CPU."""
    B, H, S, N = r.shape
    built = built_head_size(N)
    if built != N:
        up = torch.zeros((H, built), dtype=u.dtype, device=u.device)
        up[:, :N] = u
        return "pad", (*(copy_bshd(t, built) for t in (r, k, v, w)), up)
    rkvw = (r, k, v, w)
    if (any(t.stride() != r.stride() for t in rkvw)
            or choose_path((B, H, S, N), r.stride(),
                           tuple(t.data_ptr() for t in rkvw))[0] == "copy"):
        return "copy", (*(copy_bshd(t) for t in rkvw), u.contiguous())
    return "ring", (*rkvw, u.contiguous())


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
    built = built_head_size(N)
    if max(B, H, S) > _INT_MAX:
        raise ValueError(f"wkv6 kernel sizes must fit int32: {(B, H, S)}")
    o = torch.empty((B, S, H, built), dtype=r.dtype, device=r.device).transpose(1, 2)
    state = torch.empty((B, H, built, built), dtype=torch.float32, device=r.device)
    if r.numel() == 0:
        return o[..., :N], state.zero_()[:, :, :N, :N]
    lib = _build.library()
    with torch.cuda.device(r.device):
        path, (r, k, v, w, u) = prepare(r, k, v, w, u)
        ring, st = choose_path((B, H, S, built), r.stride(),
                               tuple(t.data_ptr() for t in (r, k, v, w)))
        if ring != "ring":  # prepare's copies are always in the model's layout
            raise RuntimeError(f"wkv6: prepared strides {r.stride()} are not TMA's")
        strides = (ctypes.c_longlong * 8)(*st, *o.stride())
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.repro_wkv6(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                             u.data_ptr(), o.data_ptr(), state.data_ptr(), B, H, S, built,
                             strides, stream)
    _build.check(err, f"wkv6 ({path})")
    wkv6.launches += 1
    wkv6.launches_by_path[path] += 1
    if built == N:
        return o, state
    return o[..., :N], state[:, :, :N, :N]


def reset_launches() -> None:
    """Set the launch counts (the total and each path's) to 0."""
    wkv6.launches = 0
    wkv6.launches_by_path = dict.fromkeys(PATHS, 0)


wkv6.launches = 0  # kernel launches since the last reset to 0
wkv6.launches_by_path = dict.fromkeys(PATHS, 0)  # the same, by path
