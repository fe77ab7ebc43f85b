"""Wrapper of the CUDA flash-attention backward (K3b,
``csrc/flash_attention_bwd.cu``), the port of the reference's
``fusedkernel_flash_bwd`` region (``repro/models/layers.py``, the backward
of ``_flash_attend_core``); the reference has no Pallas kernel for it.

Given K3's inputs ``q (B, H, Sq, hd)``, ``k, v (B, K, Sk, hd)``, its output
``o``, the output's gradient ``dout`` and the log-sum-exp rows ``lse (B, H,
Sq)`` f32 that :func:`.flash_attention.flash_attention_fwd` wrote, it
returns ``(dq, dk, dv)`` with the semantics of
:func:`repro_torch.kernels.ref.flash_attention_bwd`, for float32 or
bfloat16 CUDA tensors.  The gradients are allocated in the model's ``(B, S,
heads, hd)`` layout and returned as their ``(B, heads, S, hd)`` views.

The kernel is built for head dims 32, 64 and 128 (:data:`HEAD_DIMS`; K3's
forward also builds 96, which the backward still pads to 128).  What the
wrapper hands it is decided from the dtype, the head dim and the layout
alone (:func:`prepare`, mirroring K3's) and counted by path:

* ``tma``: bf16 on the tensor cores, q, k, v and dout read in place by TMA,
  which takes a layout only when the last dimension is contiguous and every
  other stride and each base address is a multiple of 16 bytes (the model's
  views are); o is read through its strides;
* ``fp32``: f32 on the tensor cores as 3xTF32 (each operand split into two
  TF32 parts, three products summed in f32), every tensor read in place
  through any strides: 16-byte ``cp.async`` copies where the last dimension
  is contiguous and the other strides and the base are 16-byte multiples,
  4-byte ones otherwise;
* ``copy``: a bf16 q, k, v or dout that TMA cannot address, copied first
  into the model's ``(B, S, heads, hd)`` layout;
* ``pad``: q, k, v, o and dout zero-padded up to the next built head dim
  (zero columns add nothing to any product, so the extra columns of the
  gradients are 0 and cropped), with the scale ``1/sqrt`` of the caller's
  head dim.

``cap > 0`` is the forward's logit cap: the kernels recompute the capped
logits and multiply dS by the cap's derivative ``1 - tanh^2``; ``cap <= 0``
launches the uncapped kernels.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .flash_attention import built_head_dim, tma_addressable
from .layout import copy_bshd

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)  # built, for both dtypes; other head dims are padded
PATHS = ("tma", "fp32", "copy", "pad")
_INT_MAX = 2**31 - 1
_BLOCK = 128  # the bf16 kernels' query rows and keys a block: a grid dimension each
_PAD_ROWS = 128  # the bf16 kernels' LSE and delta rows are padded to a multiple of this


def prepare(q, k, v, o, dout) -> tuple[str, tuple[torch.Tensor, ...]]:
    """-> (path, (q, k, v, o, dout)) as the kernel reads them, from the
    dtype, the head dim and the layout alone (see the module's docstring).
    Device-agnostic: the tests run it on the CPU."""
    hd = q.shape[-1]
    built = built_head_dim(hd, HEAD_DIMS)
    if built != hd:
        return "pad", tuple(copy_bshd(t, built) for t in (q, k, v, o, dout))
    if q.dtype == torch.float32:
        return "fp32", (q, k, v, o, dout)
    ok = [tma_addressable(t) for t in (q, k, v, dout)]
    if all(ok):
        return "tma", (q, k, v, o, dout)
    q, k, v, dout = (t if good else copy_bshd(t) for t, good in zip((q, k, v, dout), ok))
    return "copy", (q, k, v, o, dout)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        lse: torch.Tensor, dout: torch.Tensor, *, causal: bool = True,
                        kv_len: int | None = None, cap: float = 0.0
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the kernel; raises on an input it does not take."""
    ts = (q, k, v, o, dout)
    if not all(t.is_cuda and t.device == q.device for t in (*ts, lse)):
        raise ValueError(f"flash_attention_bwd kernel needs its inputs on one CUDA device, "
                         f"got {[str(t.device) for t in (*ts, lse)]}")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in ts):
        raise TypeError(f"flash_attention_bwd kernel takes float32 or bfloat16 q, k, v, o, "
                        f"dout of one dtype, got {[t.dtype for t in ts]}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or o.shape != q.shape \
            or dout.shape != q.shape:
        raise ValueError(f"flash_attention_bwd kernel needs q, o, dout (B, H, Sq, hd) and k, v "
                         f"(B, K, Sk, hd), got {[tuple(t.shape) for t in ts]}")
    B, H, Sq, hd = q.shape
    Kh, Sk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or Kh == 0 or H % Kh:
        raise ValueError(f"flash_attention_bwd kernel: k, v {tuple(k.shape)} do not match "
                         f"q {tuple(q.shape)} (KV heads must divide query heads)")
    if lse.dtype != torch.float32 or tuple(lse.shape) != (B, H, Sq) or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd kernel needs a contiguous float32 lse of shape "
                         f"{(B, H, Sq)}, got {lse.dtype} {tuple(lse.shape)}")
    built = built_head_dim(hd, HEAD_DIMS)
    if Sk == 0 or max(B * H, Sq, Sk) > _INT_MAX or max(Sq, Sk) >= _BLOCK * (2**16 - 1):
        raise ValueError(f"flash_attention_bwd kernel needs 0 < Sk, int32 sizes and Sq, Sk "
                         f"< {_BLOCK * (2**16 - 1)}: {(B, H, Sq, Sk)}")
    kv = Sk if kv_len is None else max(0, min(int(kv_len), Sk))
    dq = torch.empty((B, Sq, H, built), dtype=q.dtype, device=q.device).transpose(1, 2)
    dk = torch.empty((B, Sk, Kh, built), dtype=q.dtype, device=q.device).transpose(1, 2)
    dv = torch.empty((B, Sk, Kh, built), dtype=q.dtype, device=q.device).transpose(1, 2)
    if B == 0 or H == 0 or Sq == 0 or hd == 0:
        dk.zero_()
        dv.zero_()
        return dq[..., :hd], dk[..., :hd], dv[..., :hd]
    lib = _build.library()
    # the bf16 kernels' lse log2(e) and delta rows padded to a multiple of
    # _PAD_ROWS; the f32 kernel forms delta in its blocks and takes none
    scratch = (torch.empty(2 * B * H * -(-Sq // _PAD_ROWS) * _PAD_ROWS, dtype=torch.float32,
                           device=q.device) if q.dtype == torch.bfloat16 else None)
    with torch.cuda.device(q.device):
        path, (q, k, v, o, dout) = prepare(q, k, v, o, dout)
        strides = (ctypes.c_longlong * 32)(*q.stride(), *k.stride(), *v.stride(), *o.stride(),
                                           *dout.stride(), *dq.stride(), *dk.stride(),
                                           *dv.stride())
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attention_bwd(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), None if scratch is None else scratch.data_ptr(),
            dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B, H, H // Kh, Sq, Sk, built, kv, int(causal), 1.0 / math.sqrt(hd),
            float(cap), strides, stream)
    _build.check(err, f"flash_attention_bwd ({path})")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.launches_by_path[path] += 1
    flash_attention_bwd.launches_capped += cap > 0
    if built == hd:
        return dq, dk, dv
    return dq[..., :hd], dk[..., :hd], dv[..., :hd]


def reset_launches() -> None:
    """Set the launch counts (the total, each path's and the capped) to 0."""
    flash_attention_bwd.launches = 0
    flash_attention_bwd.launches_by_path = dict.fromkeys(PATHS, 0)
    flash_attention_bwd.launches_capped = 0


flash_attention_bwd.launches = 0  # kernel launches since the last reset to 0
flash_attention_bwd.launches_by_path = dict.fromkeys(PATHS, 0)  # the same, by path
# of the launches through this wrapper, those with a logit cap (a CUDA graph's
# replays add to the two counts above only: ops.add_launches)
flash_attention_bwd.launches_capped = 0
