"""d-grid → linear write-buffer pack (paper §3.2).

    "For optimised performance, a one to one mapping of data from the code
     to the HDF5 file is desirable.  For this purpose, a linear write
     buffer is initialised on each rank in which the grid data is copied."

Replaces the Pallas TPU kernel ``src/repro/kernels/pack/linear.py:32``
(``pack_grids``) with the CUDA C++ kernel of ``csrc/pack.cu``: strip the
halo of every ``(n+2, n+2)`` d-grid and lay its interior out as one row of
``n·n`` (row == grid, the file layout).  Pure data movement, so on the H100
it is bound by bytes: ``G·((n+2)² + n²)·itemsize`` at 3.35 TB/s.  The kernel
copies bits, templated on the element size (1, 2, 4, 8 bytes), so it is
exact for every dtype; one thread moves one element, and neighbouring
threads write neighbouring addresses.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..build import check_launch, load


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load("pack")
    ptr = ctypes.c_void_p
    lib.pack_grids.argtypes = [ptr, ptr, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ptr]
    lib.pack_grids.restype = ctypes.c_int
    return lib


def pack_grids_plain(p: torch.Tensor) -> torch.Tensor:
    """(G, n+2, n+2) halo-padded grids → (G, n·n) linear rows."""
    G, np2, _ = p.shape
    n = np2 - 2
    return p[:, 1:-1, 1:-1].reshape(G, n * n)


def pack_grids(p: torch.Tensor) -> torch.Tensor:
    """(G, n+2, n+2) halo-padded grids → (G, n·n) linear rows, bit for bit."""
    if p.device.type == "cpu":
        return pack_grids_plain(p)
    if p.device.type != "cuda":
        raise ValueError(f"pack_grids takes a CPU or CUDA tensor, got {p.device}")
    if p.dim() != 3 or p.shape[1] != p.shape[2] or p.shape[1] < 3:
        raise ValueError(f"p must be (G, n+2, n+2) with n ≥ 1, got {tuple(p.shape)}")
    if p.element_size() not in (1, 2, 4, 8):
        raise TypeError(f"pack_grids takes elements of 1, 2, 4 or 8 bytes, got {p.dtype}")
    if not p.is_contiguous():
        raise ValueError("pack_grids takes a contiguous tensor")
    G, n = p.shape[0], p.shape[1] - 2
    out = torch.empty((G, n * n), dtype=p.dtype, device=p.device)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().pack_grids(p.data_ptr(), out.data_ptr(), G, n, p.element_size(), stream)
    check_launch("pack_grids", err)
    pack_grids.launches += 1
    return out


pack_grids.launches = 0
