"""Batched weighted-Jacobi sweep and residual over halo-padded d-grids.

Replace the Pallas TPU kernels ``src/repro/kernels/stencil/jacobi.py:51``
(``jacobi_sweep``) and ``:78`` (``residual``) with the CUDA C++ kernels of
``csrc/stencil.cu``.  The work is a 5-point stencil at 7 flops a cell, so on
the H100 it is bound by bytes: each call reads p ``(G, n+2, n+2)`` and f
``(G, n, n)`` once and writes ``(G, n, n)``, all f32, at 3.35 TB/s.  The
kernel gives one thread to each output cell, so any ``(G, n)`` fills the
card and neighbouring threads touch neighbouring addresses; the halo is part
of each d-grid, so no thread reads outside its own grid.

    p'[i,j] = (1−ω)·p[i,j] + ω/4 · (p[i±1,j] + p[i,j±1] − h²·f[i,j])
    r[i,j]  = f[i,j] − (p[i±1,j] + p[i,j±1] − 4·p[i,j]) / h²

The sweep rounds exactly as its plain version.  The residual multiplies by
``1/h²`` as the Pallas kernel does, where the plain version divides by
``h²`` as ``ref.py`` does, so on the CPU the two differ by rounding (on
CUDA, torch itself divides by a scalar as a multiply by its reciprocal).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..build import check_launch, load
from .ref import jacobi_sweep_plain, residual_plain

__all__ = ["jacobi_sweep", "residual", "jacobi_sweep_plain", "residual_plain"]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load("stencil")
    ptr, i64, i32, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    lib.jacobi_sweep_f32.argtypes = [ptr, ptr, ptr, i64, i32, f32, f32, f32, ptr]
    lib.jacobi_sweep_f32.restype = ctypes.c_int
    lib.residual_f32.argtypes = [ptr, ptr, ptr, i64, i32, f32, ptr]
    lib.residual_f32.restype = ctypes.c_int
    return lib


def _on_cpu(p: torch.Tensor, f: torch.Tensor) -> bool:
    """True for CPU inputs; for CUDA inputs, check what the kernel takes."""
    if p.device.type == "cpu" and f.device.type == "cpu":
        return True
    if p.device.type != "cuda" or f.device != p.device:
        raise ValueError(f"p and f must both lie on the CPU or on one CUDA device, got {p.device} and {f.device}")
    if p.dtype != torch.float32 or f.dtype != torch.float32:
        raise TypeError(f"the CUDA stencil kernels take float32, got {p.dtype} and {f.dtype}")
    if p.dim() != 3 or p.shape[1] != p.shape[2] or p.shape[1] < 3:
        raise ValueError(f"p must be (G, n+2, n+2) with n ≥ 1, got {tuple(p.shape)}")
    G, n = p.shape[0], p.shape[1] - 2
    if tuple(f.shape) != (G, n, n):
        raise ValueError(f"f must be {(G, n, n)} for p of shape {tuple(p.shape)}, got {tuple(f.shape)}")
    if not (p.is_contiguous() and f.is_contiguous()):
        raise ValueError("the CUDA stencil kernels take contiguous p and f")
    return False


def jacobi_sweep(p: torch.Tensor, f: torch.Tensor, h2: float, omega: float = 1.0) -> torch.Tensor:
    """One weighted-Jacobi sweep over a batch of d-grids → (G, n, n), dtype of p."""
    if _on_cpu(p, f):
        return jacobi_sweep_plain(p, f, h2, omega)
    G, n = p.shape[0], p.shape[1] - 2
    out = torch.empty((G, n, n), dtype=p.dtype, device=p.device)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().jacobi_sweep_f32(p.data_ptr(), f.data_ptr(), out.data_ptr(), G, n, h2, 1.0 - omega, omega, stream)
    check_launch("jacobi_sweep", err)
    jacobi_sweep.launches += 1
    return out


def residual(p: torch.Tensor, f: torch.Tensor, h2: float) -> torch.Tensor:
    """r = f − ∇²p on each d-grid → (G, n, n), dtype of p."""
    if _on_cpu(p, f):
        return residual_plain(p, f, h2)
    G, n = p.shape[0], p.shape[1] - 2
    out = torch.empty((G, n, n), dtype=p.dtype, device=p.device)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().residual_f32(p.data_ptr(), f.data_ptr(), out.data_ptr(), G, n, 1.0 / h2, stream)
    check_launch("residual", err)
    residual.launches += 1
    return out


jacobi_sweep.launches = 0
residual.launches = 0
