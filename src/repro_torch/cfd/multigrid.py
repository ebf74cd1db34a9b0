"""Cell-centred multigrid for the pressure Poisson equation (paper §2.2).

Port of ``src/repro/cfd/multigrid.py``, with the same V-cycle, level
schedule and defaults.  The V-cycle works on composite fields; the smoother
runs on the *blocked* d-grid layout (halo exchange → Dirichlet halos →
weighted-Jacobi sweep), and the residual is computed per d-grid, through the
CUDA kernels ``jacobi_sweep`` and ``residual`` (their plain versions for CPU
tensors).  The reference calls its jnp oracles at these two places.

Dirichlet p=0 on the domain boundary (the pressure level is pinned; the
projection only needs ∇p).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..kernels.stencil.jacobi import jacobi_sweep, residual
from .spacetree import TreeLayout, dirichlet_halos, halo_exchange, to_blocked, to_composite


@dataclass(frozen=True)
class MGConfig:
    n_pre: int = 2  # pre-smoothing sweeps
    n_post: int = 4  # post-smoothing (paper: doubled on coarse levels)
    n_coarse: int = 40  # sweeps on the coarsest level
    omega: float = 0.8  # weighted-Jacobi damping
    n_block: int = 16  # d-grid side used for the blocked smoother
    coarse_size: int = 4  # stop coarsening at this composite size
    double_coarse_smooth: bool = True  # paper's instability mitigation


def _layout(comp: torch.Tensor, h: float, n_block: int) -> TreeLayout:
    """The largest d-grid side ≤ n_block that tiles the composite field."""
    H, W = comp.shape
    n = min(n_block, H, W)
    while H % n or W % n:
        n //= 2
    return TreeLayout(gx=H // n, gy=W // n, n=n, h=h)


def _smooth(comp: torch.Tensor, rhs: torch.Tensor, h: float, sweeps: int, omega: float, n_block: int) -> torch.Tensor:
    """sweeps × (halo exchange + weighted Jacobi) on the blocked layout."""
    layout = _layout(comp, h, n_block)
    b = to_blocked(layout, comp)
    fb = to_blocked(layout, rhs)[:, 1:-1, 1:-1].contiguous()
    h2 = h * h
    for _ in range(sweeps):
        b = dirichlet_halos(layout, halo_exchange(layout, b))
        b[:, 1:-1, 1:-1] = jacobi_sweep(b, fb, h2, omega)  # b is this loop's own tensor
    return to_composite(layout, b)


def _residual(comp: torch.Tensor, rhs: torch.Tensor, h: float, n_block: int) -> torch.Tensor:
    layout = _layout(comp, h, n_block)
    b = dirichlet_halos(layout, halo_exchange(layout, to_blocked(layout, comp)))
    fb = to_blocked(layout, rhs)[:, 1:-1, 1:-1].contiguous()
    r = residual(b, fb, h * h)
    return to_composite(layout, F.pad(r, (1, 1, 1, 1)))


def restrict(fine: torch.Tensor) -> torch.Tensor:
    """Bottom-up step: 2×2 cell averaging (full-weighting lite)."""
    H, W = fine.shape
    return fine.reshape(H // 2, 2, W // 2, 2).mean(dim=(1, 3))


def prolong(coarse: torch.Tensor) -> torch.Tensor:
    """Top-down step: cell-centred **bilinear** prolongation (9/3/3/1
    weights).  Zero ghost cells are Dirichlet-consistent."""
    c = F.pad(coarse, (1, 1, 1, 1))
    cc = c[1:-1, 1:-1]
    up, down = c[:-2, 1:-1], c[2:, 1:-1]
    left, right = c[1:-1, :-2], c[1:-1, 2:]
    ul, ur = c[:-2, :-2], c[:-2, 2:]
    dl, dr = c[2:, :-2], c[2:, 2:]
    f00 = (9 * cc + 3 * up + 3 * left + ul) / 16.0
    f01 = (9 * cc + 3 * up + 3 * right + ur) / 16.0
    f10 = (9 * cc + 3 * down + 3 * left + dl) / 16.0
    f11 = (9 * cc + 3 * down + 3 * right + dr) / 16.0
    H, W = coarse.shape
    out = torch.stack([torch.stack([f00, f01], dim=-1), torch.stack([f10, f11], dim=-1)], dim=-2)
    # out: (H, W, 2, 2) → interleave to (2H, 2W)
    return out.permute(0, 2, 1, 3).reshape(2 * H, 2 * W)


def v_cycle(p: torch.Tensor, rhs: torch.Tensor, h: float, cfg: MGConfig, level: int = 0) -> torch.Tensor:
    H, W = p.shape
    pre, post = cfg.n_pre, cfg.n_post
    if cfg.double_coarse_smooth:  # paper's convergence fix on coarse levels
        pre, post = pre * (1 + level), post * (1 + level)
    if min(H, W) <= cfg.coarse_size:
        return _smooth(p, rhs, h, cfg.n_coarse, cfg.omega, cfg.n_block)
    p = _smooth(p, rhs, h, pre, cfg.omega, cfg.n_block)
    r = _residual(p, rhs, h, cfg.n_block)
    e = v_cycle(torch.zeros((H // 2, W // 2), dtype=p.dtype, device=p.device), restrict(r), 2 * h, cfg, level + 1)
    p = p + prolong(e)
    return _smooth(p, rhs, h, post, cfg.omega, cfg.n_block)


def solve_poisson(rhs: torch.Tensor, h: float, cfg: MGConfig = MGConfig(), cycles: int = 6) -> torch.Tensor:
    """∇²p = rhs with homogeneous Dirichlet BCs; returns p."""
    p = torch.zeros_like(rhs)
    for _ in range(cycles):
        p = v_cycle(p, rhs, h, cfg)
    return p


def residual_norm(p: torch.Tensor, rhs: torch.Tensor, h: float, cfg: MGConfig = MGConfig()) -> torch.Tensor:
    r = _residual(p, rhs, h, cfg.n_block)
    return torch.sqrt(torch.mean(torch.square(r)))
