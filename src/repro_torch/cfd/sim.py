"""Simulation driver: mpfluid-style stepping + the paper's I/O kernel.

Port of ``src/repro/cfd/sim.py``.  Snapshots follow the paper's file
structure (Fig. 4), written with the same TH5 code as the reference (copied
under ``repro_torch.core``), so a file crosses between the two packages
bit for bit: per step the state is stored as **row-per-d-grid 2-D
datasets** (``current_cell_data`` = the packed (u, v, p, T) cells of every
grid, ``previous_cell_data`` for the time-reversal restart of explicit
Euler, ``cell_type`` boundary conditions) plus the topology datasets
(``grid_property`` UIDs in Morton order, ``subgrid_uid``, physical
``bounding_box``).  The rows are packed on the device by the ``pack_grids``
kernel and staged to host numpy here, before ``CheckpointManager.save``.
Rollback/branching delegates to ``core.steering``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..core.checkpoint import CheckpointManager
from ..core.steering import BranchManager
from ..kernels.pack.linear import pack_grids
from .projection import FluidConfig, step
from .spacetree import TreeLayout, to_blocked, topology_arrays

FIELDS = ("u", "v", "p", "T")


@dataclass
class Simulation:
    cfg: FluidConfig
    state: dict
    manager: CheckpointManager
    n_block: int = 16
    n_ranks: int = 4

    def __post_init__(self):
        n = self.n_block
        while self.cfg.nx % n or self.cfg.ny % n:
            n //= 2
        self.layout = TreeLayout(gx=self.cfg.nx // n, gy=self.cfg.ny // n, n=n, h=self.cfg.h)
        self._prev_cells: np.ndarray | None = None

    @property
    def device(self) -> torch.device:
        return self.state["u"].device

    # -- time stepping ------------------------------------------------------------

    def run(self, n_steps: int, snapshot_every: int = 0) -> dict:
        for i in range(n_steps):
            if snapshot_every and i % snapshot_every == 0:
                self.snapshot()
            self.state = step(self.cfg, self.state)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # honest wall-clock at loop exit
        return self.state

    @property
    def step_index(self) -> int:
        return int(round(float(self.state["t"]) / self.cfg.dt))

    # -- the paper's output layout ---------------------------------------------------

    def _pack_cells(self) -> np.ndarray:
        """Blocked (G, n², n_fields) cell rows — the linear write buffer."""
        rows = [pack_grids(to_blocked(self.layout, self.state[f])) for f in FIELDS]
        return torch.stack(rows, dim=-1).cpu().numpy()  # (G, n², F)

    def snapshot(self) -> int:
        step_ = self.step_index
        cells = self._pack_cells()
        prev = self._prev_cells if self._prev_cells is not None else cells
        ct_rows = pack_grids(to_blocked(self.layout, self.state["cell_type"].to(torch.float32)))
        ct = ct_rows.cpu().numpy().astype(np.int8)
        uids, subgrid, boxes, rank_of = topology_arrays(self.layout, self.n_ranks)
        t = float(self.state["t"])  # the f32 scalar, exactly
        self.manager.save(
            step_,
            {
                "current_cell_data": cells,
                "previous_cell_data": prev,
                "cell_type": ct,
                "t": np.float64(t),
            },
            n_ranks=self.n_ranks,
            topology_override=(uids, subgrid, boxes),
            extra_attrs={"sim_time": t, "fields": list(FIELDS)},
        )
        self._prev_cells = cells
        return step_

    # -- restart / TRS -----------------------------------------------------------------

    def restore(self, step: int | None = None) -> int:
        step, snap = self.manager.restore(step)
        self._load(snap)
        return step

    def _load(self, snap: dict) -> None:
        cells = snap["current_cell_data"]  # (G, n², F)
        lay = self.layout
        dev = self.device
        for fi, f in enumerate(FIELDS):
            comp = (
                cells[:, :, fi]
                .reshape(lay.gx, lay.gy, lay.n, lay.n)
                .transpose(0, 2, 1, 3)
                .reshape(lay.gx * lay.n, lay.gy * lay.n)
            )
            self.state[f] = torch.tensor(comp, dtype=torch.float32, device=dev)
        self.state["t"] = torch.tensor(np.float32(snap["t"]), device=dev)
        self._prev_cells = np.asarray(snap["previous_cell_data"])

    def branch(self, at_step: int, child_path: str, overlay: dict | None = None, **state_edits: Any) -> "Simulation":
        """TRS: reload ``at_step``, apply steering edits, continue in a new
        branching file (paper §4)."""
        bm = BranchManager(self.manager)
        child = bm.branch(at_step, child_path, overlay=overlay)
        _, snap = bm.restore(at_step)
        sim = Simulation(
            cfg=self.cfg,
            state=dict(self.state),
            manager=child.manager,
            n_block=self.n_block,
            n_ranks=self.n_ranks,
        )
        sim._load(snap)
        for k, v in state_edits.items():  # e.g. moved obstacle, new lamp T
            sim.state[k] = v
        return sim
