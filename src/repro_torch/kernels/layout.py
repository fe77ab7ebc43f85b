"""The model's activation layout, which the TMA-fed kernels read in place.

The model keeps attention and RWKV-6 activations as ``(B, S, heads, d)``
tensors and hands K3 and K4 their ``(B, heads, S, d)`` views.  A kernel
input in any other layout, or with a head dim the kernel is not built for,
is copied into a fresh tensor of that layout first.
"""

from __future__ import annotations

import torch


def copy_bshd(t: torch.Tensor, d: int | None = None) -> torch.Tensor:
    """A fresh ``(B, S, heads, d)`` copy of the ``(B, heads, S, d0)`` tensor
    ``t``, its last dimension zero-padded from ``d0`` up to ``d`` (default
    ``d0``), returned as its ``(B, heads, S, d)`` view: the model's layout,
    which TMA addresses (the allocator aligns the base)."""
    B, H, S, d0 = t.shape
    d = d0 if d is None else d
    if d == d0:
        out = torch.empty((B, S, H, d), dtype=t.dtype, device=t.device)
        return out.copy_(t.transpose(1, 2)).transpose(1, 2)
    out = torch.zeros((B, S, H, d), dtype=t.dtype, device=t.device)
    out[..., :d0].copy_(t.transpose(1, 2))
    return out.transpose(1, 2)
