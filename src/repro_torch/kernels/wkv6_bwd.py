"""Wrapper of the CUDA RWKV-6 recurrence backward (K4b,
``csrc/wkv6_bwd.cu``), the port of the reference's gradient of its chunked
scan (``repro/models/rwkv.py``, ``jax.lax.scan(jax.checkpoint(chunk_step))``:
autodiff of ``_wkv_step``; the reference has no Pallas kernel for it).

Given K4's inputs ``r, k, v, w (B, H, S, N)`` and ``u (H, N)``, the
outputs' gradient ``do (B, H, S, N)`` and the final state's ``dstate (B,
H, N, N)`` (``None``: 0), all float32 CUDA tensors, it returns ``(dr, dk,
dv, dw, du)`` with the semantics of :func:`repro_torch.kernels.ref.wkv6_bwd`.
dr, dk, dv and dw are allocated in the model's ``(B, S, H, N)`` layout and
returned as their ``(B, H, S, N)`` views; du is ``(H, N)``.

The kernel is built for head sizes 32 and 64 (K4's) and reads r, k, v, w and
do by TMA, each through its own strides; it takes a scratch of one state a
(b, h) every :data:`SEGMENT` steps (:func:`checkpoint_bytes`).  What the
wrapper hands it is decided from the head size and the layout alone
(:func:`prepare`) and counted by path:

* ``direct``: the caller's tensors read in place (n-stride 1, every other
  stride and every base on the 16-byte granule, as TMA takes them: the
  model's views, and the gradient autograd hands back for ``o``, are);
* ``copy``: a tensor that TMA cannot address, first copied into a
  fresh ``(B, S, H, N)`` buffer;
* ``pad``: a head size that is not built, zero-padded up to the next built
  one in that layout (u and dstate too), the gradients cropped.  Padding is
  exact: the padded k, v, r and do entries are 0, so the extra rows and
  columns of S and G stay 0 and add nothing to any real gradient.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .flash_attention import tma_addressable
from .layout import copy_bshd
from .wkv6 import built_head_size

PATHS = ("direct", "copy", "pad")
SEGMENT = 64  # the kernel's checkpoint spacing in steps (csrc/wkv6_bwd.cu, SEG)
_INT_MAX = 2**31 - 1
_GRID_YZ_MAX = 2**16 - 1  # H and B are the grid's y and z dimensions


def checkpoint_bytes(B: int, H: int, S: int, N: int) -> int:
    """Bytes of the kernel's checkpoint scratch: an f32 N x N state a (b,
    h) before every segment of :data:`SEGMENT` steps, at the built head
    size."""
    built = built_head_size(N)
    return B * H * -(-S // SEGMENT) * built * built * 4


def prepare(r, k, v, w, u, do, dstate=None) -> tuple[str, tuple]:
    """-> (path, (r, k, v, w, u, do, dstate)) as the kernel reads them, from
    the head size and the layout alone (see the module's docstring); u and
    dstate contiguous (dstate may stay ``None``).  Device-agnostic: the
    tests run it on the CPU."""
    B, H, S, N = r.shape
    built = built_head_size(N)
    if built != N:
        up = torch.zeros((H, built), dtype=u.dtype, device=u.device)
        up[:, :N] = u
        dsp = None
        if dstate is not None:
            dsp = torch.zeros((B, H, built, built), dtype=dstate.dtype, device=dstate.device)
            dsp[:, :, :N, :N] = dstate
        r, k, v, w, do = (copy_bshd(t, built) for t in (r, k, v, w, do))
        return "pad", (r, k, v, w, up, do, dsp)
    ts = (r, k, v, w, do)
    ok = [tma_addressable(t) for t in ts]
    r, k, v, w, do = (t if good else copy_bshd(t) for t, good in zip(ts, ok))
    dstate = None if dstate is None else dstate.contiguous()
    return ("direct" if all(ok) else "copy"), (r, k, v, w, u.contiguous(), do, dstate)


def wkv6_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
             u: torch.Tensor, do: torch.Tensor, dstate: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, ...]:
    """Launch the kernel; raises on an input it does not take."""
    ts = (r, k, v, w, u, do) + (() if dstate is None else (dstate,))
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"wkv6_bwd kernel takes float32 only, got {[t.dtype for t in ts]}")
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w, do)):
        raise ValueError(f"wkv6_bwd kernel needs r, k, v, w, do of one (B, H, S, N) shape, "
                         f"got {[tuple(t.shape) for t in (r, k, v, w, do)]}")
    B, H, S, N = r.shape
    if tuple(u.shape) != (H, N):
        raise ValueError(f"wkv6_bwd kernel needs u of shape {(H, N)}, got {tuple(u.shape)}")
    if dstate is not None and tuple(dstate.shape) != (B, H, N, N):
        raise ValueError(f"wkv6_bwd kernel needs dstate of shape {(B, H, N, N)}, got "
                         f"{tuple(dstate.shape)}")
    if not all(t.is_cuda and t.device == r.device for t in ts):
        raise ValueError(f"wkv6_bwd kernel needs its inputs on one CUDA device, "
                         f"got {[str(t.device) for t in ts]}")
    built = built_head_size(N)
    if max(B, H) > _GRID_YZ_MAX or max(H * built, S) > _INT_MAX:
        raise ValueError(f"wkv6_bwd kernel needs B, H <= {_GRID_YZ_MAX} and int32 sizes: "
                         f"{(B, H, S, N)}")
    grads = [torch.empty((B, S, H, built), dtype=torch.float32, device=r.device).transpose(1, 2)
             for _ in range(4)]
    du = torch.empty((H, built), dtype=torch.float32, device=r.device)
    if r.numel() == 0:
        du.zero_()
        return (*(g[..., :N].zero_() for g in grads), du[:, :N])
    lib = _build.library()
    ckpt = torch.empty(checkpoint_bytes(B, H, S, N) // 4, dtype=torch.float32, device=r.device)
    du_part = torch.empty(B * H * built, dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        path, (r, k, v, w, u, do, dstate) = prepare(r, k, v, w, u, do, dstate)
        if not all(tma_addressable(t) for t in (r, k, v, w, do)):
            raise RuntimeError(f"wkv6_bwd: prepared strides {r.stride()} are not addressable")
        strides = (ctypes.c_longlong * 24)(*r.stride(), *k.stride(), *v.stride(), *w.stride(),
                                           *do.stride(), *grads[0].stride())
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.repro_wkv6_bwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(), do.data_ptr(),
            None if dstate is None else dstate.data_ptr(), ckpt.data_ptr(),
            *(g.data_ptr() for g in grads), du_part.data_ptr(), du.data_ptr(), B, H, S, built,
            strides, stream)
    _build.check(err, f"wkv6_bwd ({path})")
    wkv6_bwd.launches += 1
    wkv6_bwd.launches_by_path[path] += 1
    if built == N:
        return (*grads, du)
    return (*(g[..., :N] for g in grads), du[:, :N])


def reset_launches() -> None:
    """Set the launch counts (the total and each path's) to 0."""
    wkv6_bwd.launches = 0
    wkv6_bwd.launches_by_path = dict.fromkeys(PATHS, 0)


wkv6_bwd.launches = 0  # kernel launches since the last reset to 0
wkv6_bwd.launches_by_path = dict.fromkeys(PATHS, 0)  # the same, by path
