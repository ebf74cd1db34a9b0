"""Block-structured space-tree domain (paper §2.2) on torch tensors.

Port of ``src/repro/cfd/spacetree.py``.  The domain is a composite
Cartesian grid partitioned into ``gx × gy`` d-grids of ``n × n`` cells, each
carrying a halo of 1.  Fields are stored *blocked*: shape (G, n+2, n+2) with
G = gx·gy d-grids ordered along the Lebesgue (Morton) space-filling curve —
the paper's rank-assignment order, which is also the row order of
checkpoint datasets.

``halo_exchange`` is the *horizontal* step of the paper's communication
phase: every d-grid receives its 4 neighbours' edge strips.  These functions
only move data and match the reference bit for bit.  Each returns a new
tensor and leaves its input untouched.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..core import uid as uidmod


@dataclass(frozen=True)
class TreeLayout:
    """Static geometry of the blocked domain."""

    gx: int  # d-grids in x (rows)
    gy: int  # d-grids in y (cols)
    n: int  # cells per d-grid side
    h: float  # cell size
    depth: int = 0  # tree depth of this (uniform) level

    @property
    def G(self) -> int:
        return self.gx * self.gy

    @property
    def shape_composite(self) -> tuple[int, int]:
        return (self.gx * self.n, self.gy * self.n)

    @property
    def shape_blocked(self) -> tuple[int, int, int]:
        return (self.G, self.n + 2, self.n + 2)

    def morton_order(self) -> np.ndarray:
        """d-grid (row-major) index → position along the Lebesgue curve."""
        ii, jj = np.meshgrid(np.arange(self.gx), np.arange(self.gy), indexing="ij")
        codes = uidmod.morton3(ii.ravel(), jj.ravel(), np.zeros(self.G, np.int64))
        return np.argsort(codes, kind="stable")

    def grid_uids(self, rank_of_grid: np.ndarray | None = None) -> np.ndarray:
        """Paper §3.1 ``grid property`` column for this level."""
        order = self.morton_order()
        ranks = (
            rank_of_grid
            if rank_of_grid is not None
            else np.zeros(self.G, np.int64)
        )
        locals_ = np.zeros(self.G, np.int64)
        counts: dict[int, int] = {}
        for g in order:
            r = int(ranks[g])
            locals_[g] = counts.get(r, 0)
            counts[r] = counts.get(r, 0) + 1
        ii, jj = np.meshgrid(np.arange(self.gx), np.arange(self.gy), indexing="ij")
        codes = uidmod.morton3(ii.ravel(), jj.ravel(), np.zeros(self.G, np.int64))
        return uidmod.pack_array(
            ranks, locals_, np.full(self.G, self.depth), codes & uidmod.MORTON_MAX
        )

    def bounding_boxes(self) -> np.ndarray:
        """(G, 4) physical (min_x, min_y, max_x, max_y) per d-grid."""
        ii, jj = np.meshgrid(np.arange(self.gx), np.arange(self.gy), indexing="ij")
        x0 = ii.ravel() * self.n * self.h
        y0 = jj.ravel() * self.n * self.h
        side = self.n * self.h
        return np.stack([x0, y0, x0 + side, y0 + side], axis=1)


def to_blocked(layout: TreeLayout, comp: torch.Tensor) -> torch.Tensor:
    """(gx·n, gy·n) composite → (G, n+2, n+2) blocked with zero halos."""
    gx, gy, n = layout.gx, layout.gy, layout.n
    t = comp.reshape(gx, n, gy, n).permute(0, 2, 1, 3).reshape(layout.G, n, n)
    return F.pad(t, (1, 1, 1, 1))


def to_composite(layout: TreeLayout, blocked: torch.Tensor) -> torch.Tensor:
    """(G, n+2, n+2) blocked → (gx·n, gy·n) composite (interiors only)."""
    gx, gy, n = layout.gx, layout.gy, layout.n
    t = blocked[:, 1:-1, 1:-1].reshape(gx, gy, n, n)
    return t.permute(0, 2, 1, 3).reshape(gx * n, gy * n)


def halo_exchange(layout: TreeLayout, blocked: torch.Tensor) -> torch.Tensor:
    """Fill the 4 edge halos of every d-grid from its neighbours (domain
    boundary halos are left untouched — boundary conditions own them)."""
    G, np2, _ = blocked.shape
    src = blocked.reshape(layout.gx, layout.gy, np2, np2)
    t = src.clone()
    # the strips are read from the input, so a corner takes the value the
    # input had there, as in the reference's functional updates
    t[1:, :, 0, :] = src[:-1, :, -2, :]  # from the north neighbour's last interior row
    t[:-1, :, -1, :] = src[1:, :, 1, :]
    t[:, 1:, :, 0] = src[:, :-1, :, -2]
    t[:, :-1, :, -1] = src[:, 1:, :, 1]
    return t.reshape(G, np2, np2)


def dirichlet_halos(layout: TreeLayout, blocked: torch.Tensor) -> torch.Tensor:
    """Domain-boundary halos ← −(adjacent interior): imposes value 0 exactly
    at the cell FACE (ghost−interior average), consistently on every
    multigrid level."""
    G, np2, _ = blocked.shape
    t = blocked.reshape(layout.gx, layout.gy, np2, np2).clone()
    # in sequence, each reading what the one before wrote, as the reference does
    t[0, :, 0, :] = -t[0, :, 1, :]
    t[-1, :, -1, :] = -t[-1, :, -2, :]
    t[:, 0, :, 0] = -t[:, 0, :, 1]
    t[:, -1, :, -1] = -t[:, -1, :, -2]
    return t.reshape(G, np2, np2)


def topology_arrays(layout: TreeLayout, n_ranks: int = 1):
    """(grid_uid, subgrid_uid, bounding_box, rank_of_grid) for snapshots —
    the paper's per-step topology datasets.  Grids are dealt to ranks in
    Morton order (contiguous SFC chunks per rank, §2.2)."""
    order = layout.morton_order()
    rank_of = np.zeros(layout.G, np.int64)
    chunk = -(-layout.G // n_ranks)
    for pos, g in enumerate(order):
        rank_of[g] = min(pos // chunk, n_ranks - 1)
    uids = layout.grid_uids(rank_of)
    subgrid = np.zeros((layout.G, 4), np.uint64)  # uniform level: no children
    boxes = layout.bounding_boxes()
    return uids, subgrid, boxes, rank_of
