"""Wrapper of the CUDA flash-attention kernel (``csrc/flash_attention.cu``),
the port of the Pallas TPU kernel ``repro/kernels/flash_attention.py``.

``q (B, H, Sq, hd)`` attends over ``k, v (B, K, Sk, hd)`` with ``K``
dividing ``H`` (GQA: query head ``h`` reads KV head ``h // (H // K)``), for
float32 or bfloat16 CUDA tensors; the semantics are
:func:`repro_torch.kernels.ref.flash_attention`'s.  The output is allocated
in the model's ``(B, Sq, H, hd)`` layout and returned as its ``(B, H, Sq,
hd)`` view, so ``o.transpose(1, 2)`` is contiguous.

The kernel is built for head dims 32, 64, 96 and 128 (:data:`HEAD_DIMS`)
and takes the scale as an argument.  What the wrapper hands it is decided
from the dtype, the head dim, the number of query rows and the layout alone
(:func:`prepare`) and counted by path:

* ``tma``: bf16 read in place by TMA, which takes a layout only when the
  last dimension is contiguous and every other stride and each base address
  is a multiple of 16 bytes (the model's views are);
* ``split``: the same bf16 layouts at ``Sq <=`` :data:`SPLIT_MAX_SQ` query
  rows (whisper's decode cross-attention: one query over 1500 frames), read
  in place by TMA on the CUDA cores: the keys of each (batch, KV head) are
  cut into :func:`split_count` splits, persistent blocks write each split's
  partial (m, l, O) in f32 to a scratch buffer, and a second kernel merges
  them in a fixed order;
* ``fp32``: f32 on the tensor cores as 3xTF32 (each operand split into two
  TF32 parts, three products summed in f32), read in place through any
  strides: 16-byte ``cp.async`` copies where the last dimension is
  contiguous and the other strides and the base are 16-byte multiples,
  4-byte ones otherwise;
* ``copy``: a bf16 tensor TMA cannot address, copied first into the model's
  ``(B, S, heads, hd)`` layout;
* ``pad``: a head dim that is not built, zero-padded up to the next built
  one (in that same layout) and the output's extra columns cropped.  Padding
  is exact: zero columns add nothing to ``Q K^T``, and the scale passed is
  ``1/sqrt`` of the caller's head dim.

:func:`flash_attention_fwd` is the same launch, which also writes each
row's log-sum-exp ``(B, H, Sq)`` in f32 for the backward (K3b,
:mod:`.flash_attention_bwd`); :func:`flash_attention`, the serving call,
passes the kernel no LSE buffer.  Both count as K3 launches.

``cap > 0`` caps each scaled logit to ``cap tanh(s / cap)`` (a model's
``attn_logit_softcap``) on every path; the kernel is built capped and
uncapped, and ``cap <= 0`` launches the uncapped one.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .layout import copy_bshd

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 96, 128)  # built, for both dtypes; other head dims are padded
PATHS = ("tma", "fp32", "copy", "pad", "split")
SPLIT_MAX_SQ = 4  # bf16 calls with at most this many query rows take ``split``
SPLIT_TILE = 128  # keys a tile of the split kernel; a split is whole tiles
SPLIT_ROWS = 16  # query rows (of a KV head's G x Sq) an item of the split kernel
_INT_MAX = 2**31 - 1
# query rows per block, by dtype; blocks per (batch, head) stay below 2**16
_BQ = {torch.float32: 32, torch.bfloat16: 128}
_TMA_ALIGN = 16  # bytes: TMA's base address and stride granule


def built_head_dim(hd: int, built_dims: tuple[int, ...] = HEAD_DIMS) -> int:
    """The smallest of ``built_dims`` (K3's by default) that holds ``hd``;
    raises above the largest."""
    for built in built_dims:
        if hd <= built:
            return built
    raise ValueError(f"flash_attention kernel takes head_dim up to {built_dims[-1]}, got {hd}")


def split_count(G: int, Sq: int, Sk: int) -> tuple[int, int]:
    """-> (n_split, keys a split) of the ``split`` path, from the shapes
    alone, so that eager calls and a CUDA graph's replays compute the same
    bits: ``ceil(rows / 4)`` tiles of :data:`SPLIT_TILE` keys a split, rows
    being an item's ``min(G Sq, SPLIT_ROWS)`` query rows, so the partials
    (``rows (hd + 2)`` f32 a split, written and read once) stay near 1/16
    of the split's K and V bytes.  The kernel's persistent blocks take the
    (KV head, row group, split) items in turn, so the split count need not
    fill the card: at one query row a split is one tile."""
    rows = min(G * Sq, SPLIT_ROWS)
    chunk = SPLIT_TILE * -(-rows // 4)
    return -(-Sk // chunk), chunk


def tma_addressable(t: torch.Tensor) -> bool:
    """Can TMA read ``t``: a contiguous last dimension, the other strides and
    the base address multiples of 16 bytes."""
    nbytes = t.element_size()
    return (t.stride(-1) == 1 and all(st * nbytes % _TMA_ALIGN == 0 for st in t.stride()[:-1])
            and t.data_ptr() % _TMA_ALIGN == 0)


def prepare(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
            ) -> tuple[str, torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (path, q, k, v) as the kernel reads them, from the dtype, the head
    dim, the query rows and the layout alone (see the module's docstring).
    Device-agnostic: the tests run it on the CPU."""
    hd = q.shape[-1]
    built = built_head_dim(hd)
    if built != hd:
        return ("pad", *(copy_bshd(t, built) for t in (q, k, v)))
    if q.dtype == torch.float32:
        return "fp32", q, k, v
    ok = [tma_addressable(t) for t in (q, k, v)]
    if all(ok):
        return "split" if q.shape[2] <= SPLIT_MAX_SQ else "tma", q, k, v
    return ("copy", *(t if good else copy_bshd(t) for t, good in zip((q, k, v), ok)))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, kv_len: int | None = None,
                    cap: float = 0.0) -> torch.Tensor:
    """Launch the kernel; raises on an input it does not take."""
    return _launch(q, k, v, causal, kv_len, cap, want_lse=False)[0]


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, kv_len: int | None = None, cap: float = 0.0
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (o, lse): the kernel's output and each query row's log-sum-exp of
    its scaled (and capped) logits, ``(B, H, Sq)`` f32 (natural log; ``pad``
    crops nothing from it).  Raises on an input the kernel does not take."""
    return _launch(q, k, v, causal, kv_len, cap, want_lse=True)


def _launch(q, k, v, causal, kv_len, cap, want_lse: bool):
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
    built = built_head_dim(hd)
    bq = _BQ[q.dtype]
    if Sk == 0 or max(B * H, Sq, Sk) > _INT_MAX or -(-Sq // bq) >= 2**16:
        raise ValueError(f"flash_attention kernel needs 0 < Sk, int32 sizes and "
                         f"Sq < {bq * (2**16 - 1)}: {(B, H, Sq, Sk)}")
    kv = Sk if kv_len is None else max(0, min(int(kv_len), Sk))
    out = torch.empty((B, Sq, H, built), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) if want_lse
           else None)
    if B == 0 or H == 0 or Sq == 0 or hd == 0:
        return out[..., :hd], lse
    lib = _build.library()
    with torch.cuda.device(q.device):
        path, q, k, v = prepare(q, k, v)
        strides = (ctypes.c_longlong * 16)(*q.stride(), *k.stride(), *v.stride(),
                                           *out.stride())
        stream = torch.cuda.current_stream(q.device).cuda_stream
        lse_ptr = None if lse is None else lse.data_ptr()
        if path == "split":
            n_split, chunk = split_count(H // Kh, Sq, Sk)
            # each split's (O, m, l) a query row, f32; inside a CUDA graph
            # capture this comes from the graph's pool
            part = torch.empty(B * H * Sq * n_split * (hd + 2), dtype=torch.float32,
                               device=q.device)
            err = lib.repro_flash_attention_split(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse_ptr,
                part.data_ptr(), B, H, H // Kh, Sq, Sk, hd, kv, int(causal),
                1.0 / math.sqrt(hd), float(cap), n_split, chunk, strides, stream)
        else:
            err = lib.repro_flash_attention(
                _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse_ptr, B, H, H // Kh, Sq, Sk, built, kv, int(causal), 1.0 / math.sqrt(hd),
                float(cap), strides, stream)
    _build.check(err, f"flash_attention ({path})")
    flash_attention.launches += 1
    flash_attention.launches_by_path[path] += 1
    flash_attention.launches_capped += cap > 0
    return (out if built == hd else out[..., :hd]), lse


def reset_launches() -> None:
    """Set the launch counts (the total, each path's and the capped) to 0."""
    flash_attention.launches = 0
    flash_attention.launches_by_path = dict.fromkeys(PATHS, 0)
    flash_attention.launches_capped = 0


flash_attention.launches = 0  # kernel launches since the last reset to 0
flash_attention.launches_by_path = dict.fromkeys(PATHS, 0)  # the same, by path
# of the launches through this wrapper, those with a logit cap (a CUDA graph's
# replays add to the two counts above only: ops.add_launches)
flash_attention.launches_capped = 0
