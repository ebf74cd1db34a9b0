"""The paper's two TRS scenarios (§4), as torch state dicts.

Port of ``src/repro/cfd/scenarios.py``: the same configurations and the
same state dict, with tensors on ``device`` (the card unless the caller
passes another device; without a card, the default raises).

1. **Kármán vortex street** — Schäfer–Turek channel benchmark: 2-D channel,
   cylinder obstacle near the inlet, Re = 100 → unsteady vortex shedding.
2. **Operation theatre (thermally coupled)** — simplified 2-D room: inflow
   along one full wall, slightly open "door" outlet on the opposite wall,
   heated bodies (lamps T=324.66 K, humans 299.50 K, equipment 290.16 K).
"""

from __future__ import annotations

import numpy as np
import torch

from .multigrid import MGConfig
from .projection import INFLOW, OUTFLOW, SOLID, WALL, FluidConfig

LAMP_T = 324.66
HUMAN_T = 299.50
OBJECT_T = 290.16
ROOM_T = 290.16


def _fields(nx: int, ny: int, u_in: float, T_solid: np.ndarray, cell_type: np.ndarray, device) -> dict:
    return {
        "u": torch.full((nx, ny), u_in, dtype=torch.float32, device=device),
        "v": torch.zeros((nx, ny), dtype=torch.float32, device=device),
        "p": torch.zeros((nx, ny), dtype=torch.float32, device=device),
        "T": torch.full((nx, ny), ROOM_T, dtype=torch.float32, device=device),
        "T_solid": torch.tensor(T_solid, dtype=torch.float32, device=device),
        "cell_type": torch.tensor(cell_type, dtype=torch.int8, device=device),
        "t": torch.zeros((), dtype=torch.float32, device=device),
    }


def karman_vortex(nx: int = 64, ny: int = 256, re: float = 100.0, device="cuda") -> tuple[FluidConfig, dict]:
    """Channel with a cylinder at ~1/4 length; Re = u·D/ν = 100."""
    h = 1.0 / nx  # channel height 1
    D = 0.25  # cylinder diameter (in channel heights)
    u_in = 1.0
    nu = u_in * D / re
    cfg = FluidConfig(
        nx=nx,
        ny=ny,
        h=h,
        dt=0.2 * h / u_in,
        nu=nu,
        u_in=u_in,
        mg=MGConfig(n_pre=2, n_post=2),
        mg_cycles=4,
    )
    cell_type = np.zeros((nx, ny), np.int8)
    cell_type[0, :] = WALL
    cell_type[-1, :] = WALL
    cell_type[:, 0] = INFLOW
    cell_type[:, -1] = OUTFLOW
    cell_type = add_cylinder(cell_type, nx, ny, cx=nx // 2, cy=ny // 4, d=D / h)
    return cfg, _fields(nx, ny, u_in, np.full((nx, ny), ROOM_T, np.float32), cell_type, device)


def add_cylinder(cell_type: np.ndarray, nx: int, ny: int, cx: int, cy: int, d: float) -> np.ndarray:
    """Immersed cylinder obstacle (the TRS 'move the obstacle' knob)."""
    ct = np.array(cell_type, copy=True)
    ii, jj = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    mask = (ii - cx) ** 2 + (jj - cy) ** 2 <= (d / 2) ** 2
    ct[mask] = SOLID
    return ct


def operation_theatre(nx: int = 64, ny: int = 64, lamp_T: float = LAMP_T, device="cuda") -> tuple[FluidConfig, dict]:
    """Thermally coupled room: full-wall inflow (left), door outlet (right),
    lamp + two 'humans' + table as heated solids."""
    h = 4.0 / nx  # 4 m room
    u_in = 0.2
    cfg = FluidConfig(
        nx=nx,
        ny=ny,
        h=h,
        dt=0.1 * h / u_in,
        nu=1.5e-3,
        u_in=u_in,
        thermal=True,
        alpha=2.0e-3,
        beta=3.4e-3,
        T_ref=ROOM_T,
        mg=MGConfig(),
        mg_cycles=4,
    )
    ct = np.zeros((nx, ny), np.int8)
    Ts = np.full((nx, ny), ROOM_T, np.float32)
    ct[0, :] = WALL
    ct[-1, :] = WALL
    ct[:, 0] = INFLOW
    # door: lower quarter of the right wall open
    ct[:, -1] = WALL
    ct[3 * nx // 4 :, -1] = OUTFLOW
    # lamp near the ceiling centre
    lamp = (slice(nx // 8, nx // 8 + 3), slice(ny // 2 - 4, ny // 2 + 4))
    ct[lamp] = SOLID
    Ts[lamp] = lamp_T
    # operating table + patient (centre)
    table = (slice(nx // 2, nx // 2 + 4), slice(ny // 2 - 8, ny // 2 + 8))
    ct[table] = SOLID
    Ts[table] = HUMAN_T
    # two assistants
    for off in (-12, 12):
        body = (slice(nx // 2 - 6, nx // 2 + 8), slice(ny // 2 + off - 2, ny // 2 + off))
        ct[body] = SOLID
        Ts[body] = HUMAN_T
    return cfg, _fields(nx, ny, u_in, Ts, ct, device)
