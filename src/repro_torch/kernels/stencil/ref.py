"""Plain PyTorch versions of the stencil kernels (the oracles of ``jacobi.py``).

The same arithmetic, in the same order, as ``src/repro/kernels/stencil/ref.py``:
compute in f32 and cast the result to ``p.dtype``.
"""

from __future__ import annotations

import torch


def jacobi_sweep_plain(p: torch.Tensor, f: torch.Tensor, h2: float, omega: float = 1.0) -> torch.Tensor:
    p32 = p.to(torch.float32)
    f32 = f.to(torch.float32)
    new = 0.25 * (
        p32[:, :-2, 1:-1] + p32[:, 2:, 1:-1] + p32[:, 1:-1, :-2] + p32[:, 1:-1, 2:] - h2 * f32
    )
    return ((1.0 - omega) * p32[:, 1:-1, 1:-1] + omega * new).to(p.dtype)


def residual_plain(p: torch.Tensor, f: torch.Tensor, h2: float) -> torch.Tensor:
    p32 = p.to(torch.float32)
    f32 = f.to(torch.float32)
    lap = (
        p32[:, :-2, 1:-1]
        + p32[:, 2:, 1:-1]
        + p32[:, 1:-1, :-2]
        + p32[:, 1:-1, 2:]
        - 4.0 * p32[:, 1:-1, 1:-1]
    ) / h2
    return (f32 - lap).to(p.dtype)
