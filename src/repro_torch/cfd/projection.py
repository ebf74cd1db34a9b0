"""Incompressible Navier–Stokes via Chorin projection (paper §2.1).

Port of ``src/repro/cfd/projection.py``.  Explicit-Euler fractional step on
a collocated grid:

    u* = u + dt·(ν ∇²u − (u·∇)u + b)         (momentum, upwind advection)
    ∇²p = ∇·u* / dt                           (pressure Poisson, multigrid)
    u  = u* − dt·∇p                           (projection → ∇·u = 0)

Thermal coupling (operation-theatre scenario) replaces b with the
Boussinesq buoyancy term and advances the energy equation with the same
upwind/diffusion operators.  Obstacles are immersed boundaries: cell_type
masks force u=v=0 (and Dirichlet T) inside solids.  The stencils wrap
around periodically at the domain edges (``torch.roll``), as the
reference's ``jnp.roll`` does.  ``step`` returns a new state dict and
updates no tensor of the one it is given.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .multigrid import MGConfig, solve_poisson

FLUID, SOLID, INFLOW, OUTFLOW, WALL = 0, 1, 2, 3, 4


@dataclass(frozen=True)
class FluidConfig:
    nx: int  # rows (y direction held in axis 0)
    ny: int  # cols (x / streamwise direction in axis 1)
    h: float
    dt: float
    nu: float = 1e-3  # kinematic viscosity
    u_in: float = 1.0  # inflow velocity (streamwise, axis-1)
    thermal: bool = False
    alpha: float = 1.4e-4  # heat diffusivity
    beta: float = 3.4e-3  # thermal expansion
    T_ref: float = 293.0
    gravity: float = 9.81
    mg: MGConfig = MGConfig()
    mg_cycles: int = 4


def _lap(f: torch.Tensor, h: float) -> torch.Tensor:
    return (
        torch.roll(f, 1, 0) + torch.roll(f, -1, 0) + torch.roll(f, 1, 1) + torch.roll(f, -1, 1) - 4 * f
    ) / (h * h)


def _upwind_adv(f: torch.Tensor, u: torch.Tensor, v: torch.Tensor, h: float) -> torch.Tensor:
    """(u·∇)f with first-order upwinding.  u = axis-1 velocity, v = axis-0."""
    dfdx_m = (f - torch.roll(f, 1, 1)) / h
    dfdx_p = (torch.roll(f, -1, 1) - f) / h
    dfdy_m = (f - torch.roll(f, 1, 0)) / h
    dfdy_p = (torch.roll(f, -1, 0) - f) / h
    return u * torch.where(u > 0, dfdx_m, dfdx_p) + v * torch.where(v > 0, dfdy_m, dfdy_p)


def _grad(p: torch.Tensor, h: float) -> tuple[torch.Tensor, torch.Tensor]:
    dpdx = (torch.roll(p, -1, 1) - torch.roll(p, 1, 1)) / (2 * h)
    dpdy = (torch.roll(p, -1, 0) - torch.roll(p, 1, 0)) / (2 * h)
    return dpdx, dpdy


def divergence(u: torch.Tensor, v: torch.Tensor, h: float) -> torch.Tensor:
    return (torch.roll(u, -1, 1) - torch.roll(u, 1, 1)) / (2 * h) + (
        torch.roll(v, -1, 0) - torch.roll(v, 1, 0)
    ) / (2 * h)


def _outflow(f: torch.Tensor) -> torch.Tensor:
    """Zero-gradient right edge: the last column takes the one before it."""
    return torch.cat([f[:, :-1], f[:, -2:-1]], dim=1)


def apply_velocity_bcs(cfg: FluidConfig, u, v, cell_type):
    # inflow column (left edge): plug flow
    u = torch.where(cell_type == INFLOW, cfg.u_in, u)
    v = torch.where(cell_type == INFLOW, 0.0, v)
    # outflow (right edge): zero-gradient
    u = _outflow(u)
    v = _outflow(v)
    # solid walls + obstacle: no slip
    solid = (cell_type == SOLID) | (cell_type == WALL)
    u = torch.where(solid, 0.0, u)
    v = torch.where(solid, 0.0, v)
    return u, v


def step(cfg: FluidConfig, state: dict) -> dict:
    """One fractional-step update.  state: u, v, p, T, cell_type, t."""
    u, v, p, T, cell_type = state["u"], state["v"], state["p"], state["T"], state["cell_type"]
    dt, h = cfg.dt, cfg.h
    u, v = apply_velocity_bcs(cfg, u, v, cell_type)

    bx = torch.zeros_like(u)
    by = torch.zeros_like(v)
    if cfg.thermal:
        by = by - cfg.gravity * cfg.beta * (T - cfg.T_ref)  # Boussinesq

    u_star = u + dt * (cfg.nu * _lap(u, h) - _upwind_adv(u, u, v, h) + bx)
    v_star = v + dt * (cfg.nu * _lap(v, h) - _upwind_adv(v, u, v, h) + by)
    u_star, v_star = apply_velocity_bcs(cfg, u_star, v_star, cell_type)

    rhs = divergence(u_star, v_star, h) / dt
    p = solve_poisson(rhs, h, cfg.mg, cycles=cfg.mg_cycles)

    dpdx, dpdy = _grad(p, h)
    u_new = u_star - dt * dpdx
    v_new = v_star - dt * dpdy
    u_new, v_new = apply_velocity_bcs(cfg, u_new, v_new, cell_type)

    if cfg.thermal:
        T = T + dt * (cfg.alpha * _lap(T, h) - _upwind_adv(T, u_new, v_new, h))
        T = torch.where(cell_type == SOLID, state["T_solid"], T)
        T = torch.where(cell_type == INFLOW, cfg.T_ref, T)

    return {
        **state,
        "u": u_new,
        "v": v_new,
        "p": p,
        "T": T,
        "t": state["t"] + dt,
    }
