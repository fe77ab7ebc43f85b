"""Wrapper of the CUDA flash-attention kernel (``csrc/flash_attention.cu``),
the port of the Pallas TPU kernel ``repro/kernels/flash_attention.py``.

``q (B, H, Sq, hd)`` attends over ``k, v (B, K, Sk, hd)`` with ``K``
dividing ``H`` (GQA: query head ``h`` reads KV head ``h // (H // K)``), for
float32 or bfloat16 CUDA tensors; the semantics are
:func:`repro_torch.kernels.ref.flash_attention`'s.  All four tensors are
read and written through their strides: the output is allocated in the
model's ``(B, Sq, H, hd)`` layout and returned as its ``(B, H, Sq, hd)``
view, so ``o.transpose(1, 2)`` is contiguous.

bf16 runs on the tensor cores and reads q, k and v by TMA, which takes a
layout only when the last dimension is contiguous and every other stride
and each base address is a multiple of 16 bytes: the model's views are.
Any other bf16 layout raises ``ValueError``; f32 takes any strides.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)  # for both dtypes
_INT_MAX = 2**31 - 1
_BQ = 128  # query rows per block; blocks per (batch, head) stay below 2**16


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, kv_len: int | None = None) -> torch.Tensor:
    """Launch the kernel; raises on an input it does not take."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda) or not (q.device == k.device == v.device):
        raise ValueError(f"flash_attention kernel needs q, k, v on one CUDA device, "
                         f"got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or not (k.dtype == v.dtype == q.dtype):
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16 q, k, v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention kernel needs q (B, H, Sq, hd) and k, v "
                         f"(B, K, Sk, hd), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, Sq, hd = q.shape
    Kh, Sk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or Kh == 0 or H % Kh:
        raise ValueError(f"flash_attention kernel: k, v {tuple(k.shape)} do not match "
                         f"q {tuple(q.shape)} (KV heads must divide query heads)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in {HEAD_DIMS}, got {hd}")
    if Sk == 0 or max(B * H, Sq, Sk) > _INT_MAX or -(-Sq // _BQ) >= 2**16:
        raise ValueError(f"flash_attention kernel needs 0 < Sk, int32 sizes and "
                         f"Sq < {_BQ * (2**16 - 1)}: {(B, H, Sq, Sk)}")
    if q.dtype == torch.bfloat16:
        _check_tma_layout(q, k, v)
    kv = Sk if kv_len is None else max(0, min(int(kv_len), Sk))
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device).transpose(1, 2)
    if B == 0 or H == 0 or Sq == 0:
        return out
    strides = (ctypes.c_longlong * 16)(*q.stride(), *k.stride(), *v.stride(), *out.stride())
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attention(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, H // Kh, Sq, Sk, hd, kv, int(causal), strides, stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out



def reset_launches() -> None:
    """Set the launch count to 0."""
    flash_attention.launches = 0


flash_attention.launches = 0  # kernel launches since the last reset to 0


def _check_tma_layout(*ts: torch.Tensor) -> None:
    for name, t in zip("qkv", ts):
        nbytes = t.element_size()
        if (t.stride(-1) != 1 or any(st * nbytes % 16 for st in t.stride()[:-1])
                or t.data_ptr() % 16):
            raise ValueError(f"flash_attention kernel (bf16) needs {name} with a contiguous "
                             f"last dimension, other strides and the base address 16-byte "
                             f"aligned, got strides {t.stride()}")
