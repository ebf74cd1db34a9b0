"""Hyperslab planning — the paper's reduce + exscan offset computation (§3.2).

In the paper every rank must know (a) the *total* number of grids so the
(collectively created) dataset can be sized, and (b) the cumulative number of
grids on all previous ranks so its own write region is disjoint from everyone
else's:

    "This is achieved using a global MPI reduction, summing up all grids,
     followed by an MPI prefix reduction to determine the amount added by all
     previous ranks to the global sum."

This module is the *host-side* planner (pure numpy, used by the checkpoint
writer and the benchmarks).  ``core.collective_io`` re-implements the same
plan *on-device* with ``jax.lax`` collectives under ``shard_map`` and is
tested to agree bit-for-bit.

The plans feed the zero-copy write pipeline: each planned extent becomes a
view-carrying ``WriteRequest`` (``aggregation.nd_slab_requests`` — no
payload bytes are copied), coalesced and drained with vectored ``pwritev``
by the aggregator pool.  Plans describe *logical* rows, so they serve both
dataset layouts unchanged: contiguous extents and the chunked/compressed
layout, whose variable-length post-filter extents are tracked separately by
chunk records (``docs/FORMAT.md``).  Stage map: ``docs/ARCHITECTURE.md``.

Invariants (property-tested in ``tests/test_hyperslab.py``):
  * extents are pairwise disjoint              (lock-free writes are safe)
  * extents ordered by rank                    (row index == paper ordering)
  * union of extents covers [0, total) exactly (no holes, no overhang)
  * alignment only ever *pads between* logical regions of different files —
    within one dataset, rows stay contiguous (the paper's 1:1 linear-buffer
    mapping), alignment is applied to dataset *base* offsets.

Copied from ``src/repro/core/hyperslab.py``; only the import lines differ.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Extent:
    """A byte range [offset, offset+nbytes) owned by one rank."""

    rank: int
    offset: int  # bytes from dataset data-region base
    nbytes: int

    @property
    def end(self) -> int:
        return self.offset + self.nbytes


@dataclass(frozen=True)
class SlabPlan:
    """Per-rank disjoint extents for one dataset plus its global geometry."""

    total_rows: int
    row_bytes: int
    row_starts: np.ndarray  # (nranks,) first global row index per rank
    row_counts: np.ndarray  # (nranks,) rows contributed per rank
    extents: tuple[Extent, ...]

    @property
    def total_bytes(self) -> int:
        return self.total_rows * self.row_bytes

    def extent_for(self, rank: int) -> Extent:
        return self.extents[rank]

    def row_range(self, rank: int) -> tuple[int, int]:
        s = int(self.row_starts[rank])
        return s, s + int(self.row_counts[rank])


def exclusive_prefix_sum(counts: np.ndarray) -> np.ndarray:
    """``MPI_Exscan`` equivalent: out[i] = sum(counts[:i]), out[0] = 0."""
    counts = np.asarray(counts, dtype=np.int64)
    out = np.zeros_like(counts)
    np.cumsum(counts[:-1], out=out[1:])
    return out


def plan_rows(counts_per_rank, row_bytes: int) -> SlabPlan:
    """Plan disjoint row extents for a 2-D dataset (row == grid, paper §3.1).

    ``counts_per_rank[i]`` is the number of grids rank *i* contributes.  Rank
    ordering gives the paper's "grids ordered by the respective ranks" layout,
    and the root grid (first grid of rank 0) lands at row 0 by construction.
    """
    counts = np.asarray(counts_per_rank, dtype=np.int64)
    if counts.ndim != 1:
        raise ValueError("counts_per_rank must be 1-D")
    if (counts < 0).any():
        raise ValueError("negative grid count")
    if row_bytes <= 0:
        raise ValueError("row_bytes must be positive")
    starts = exclusive_prefix_sum(counts)
    total = int(counts.sum())
    extents = tuple(
        Extent(rank=r, offset=int(starts[r]) * row_bytes, nbytes=int(counts[r]) * row_bytes)
        for r in range(len(counts))
    )
    return SlabPlan(
        total_rows=total,
        row_bytes=row_bytes,
        row_starts=starts,
        row_counts=counts,
        extents=extents,
    )


def plan_bytes(nbytes_per_rank) -> SlabPlan:
    """Plan for ragged (per-rank variable byte) contributions — MLA latent rows,
    flat VPIC-style layouts, or packed param shards of unequal size."""
    nbytes = np.asarray(nbytes_per_rank, dtype=np.int64)
    if (nbytes < 0).any():
        raise ValueError("negative byte count")
    starts = exclusive_prefix_sum(nbytes)
    extents = tuple(
        Extent(rank=r, offset=int(starts[r]), nbytes=int(nbytes[r]))
        for r in range(len(nbytes))
    )
    return SlabPlan(
        total_rows=int(nbytes.sum()),
        row_bytes=1,
        row_starts=starts,
        row_counts=nbytes,
        extents=extents,
    )


def align_up(offset: int, alignment: int) -> int:
    """Round ``offset`` up to the next multiple of ``alignment`` (power-of-two
    not required). Alignment of dataset base offsets to the file-system block
    size is the paper's §5.2 'alignment of data to the file system's block
    size' optimisation."""
    if alignment <= 1:
        return offset
    return ((offset + alignment - 1) // alignment) * alignment


def validate_plan(plan: SlabPlan) -> None:
    """Assert the lock-free invariants. Raises AssertionError on violation."""
    prev_end = 0
    for ext in plan.extents:
        assert ext.offset == prev_end, f"hole/overlap at rank {ext.rank}"
        assert ext.nbytes >= 0
        prev_end = ext.end
    assert prev_end == plan.total_bytes, "extents do not cover dataset"
    # disjointness is implied by the exact-cover check above, but double-check
    spans = sorted((e.offset, e.end) for e in plan.extents)
    for (s0, e0), (s1, _e1) in zip(spans, spans[1:]):
        assert e0 <= s1, "overlapping extents"
