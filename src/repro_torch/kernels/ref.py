"""Plain PyTorch versions of the hand-written kernels (the allclose targets).

Each function is the mathematical definition with the JAX package's
semantics (``repro/kernels/ref.py``).  :mod:`repro_torch.kernels.ops` runs
them for tensors on the CPU; the tests and ``chip_smoke.py`` hold the CUDA
kernels against them on the card.
"""

from __future__ import annotations

import torch


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` accumulated in float32, cast to ``a.dtype``."""
    return torch.matmul(a.to(torch.float32), b.to(torch.float32)).to(a.dtype)


def matadd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise ``a + b`` in the input dtype."""
    return a + b
