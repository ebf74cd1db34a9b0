"""64-bit grid/shard UIDs — paper §3.1 ``grid property`` dataset.

The paper encodes, per grid, "the residing rank, a rank unique identifier and
its location in the structure" into a single UID.  We pack those into one
uint64 so a whole topology dataset is a flat integer column:

    [ rank : 20 bits ][ local : 20 bits ][ depth : 6 bits ][ morton : 18 bits ]

- ``rank``   owning process / mesh shard (up to ~1M ranks — 1000+ node posture)
- ``local``  rank-unique running index
- ``depth``  level in the space-tree (root = 0)
- ``morton`` Lebesgue/Morton code of the cell within its level (the paper's
  space-filling-curve position), truncated to the low 18 bits; full-precision
  location lives in the ``bounding_box`` dataset, the in-UID code is used for
  fast neighbour heuristics only.

Copied from ``src/repro/core/uid.py``; only the import lines differ.
"""

from __future__ import annotations

import numpy as np

RANK_BITS = 20
LOCAL_BITS = 20
DEPTH_BITS = 6
MORTON_BITS = 18

assert RANK_BITS + LOCAL_BITS + DEPTH_BITS + MORTON_BITS == 64

RANK_MAX = (1 << RANK_BITS) - 1
LOCAL_MAX = (1 << LOCAL_BITS) - 1
DEPTH_MAX = (1 << DEPTH_BITS) - 1
MORTON_MAX = (1 << MORTON_BITS) - 1

_RANK_SHIFT = LOCAL_BITS + DEPTH_BITS + MORTON_BITS
_LOCAL_SHIFT = DEPTH_BITS + MORTON_BITS
_DEPTH_SHIFT = MORTON_BITS


def pack(rank: int, local: int, depth: int = 0, morton: int = 0) -> int:
    """Pack the four fields into a uint64 UID (python int)."""
    if not (0 <= rank <= RANK_MAX):
        raise ValueError(f"rank {rank} out of range [0, {RANK_MAX}]")
    if not (0 <= local <= LOCAL_MAX):
        raise ValueError(f"local {local} out of range [0, {LOCAL_MAX}]")
    if not (0 <= depth <= DEPTH_MAX):
        raise ValueError(f"depth {depth} out of range [0, {DEPTH_MAX}]")
    if not (0 <= morton <= MORTON_MAX):
        raise ValueError(f"morton {morton} out of range [0, {MORTON_MAX}]")
    return (
        (rank << _RANK_SHIFT)
        | (local << _LOCAL_SHIFT)
        | (depth << _DEPTH_SHIFT)
        | morton
    )


def unpack(uid: int) -> tuple[int, int, int, int]:
    """Inverse of :func:`pack` → (rank, local, depth, morton)."""
    uid = int(uid)
    if not (0 <= uid < (1 << 64)):
        raise ValueError(f"uid {uid} is not a uint64")
    rank = (uid >> _RANK_SHIFT) & RANK_MAX
    local = (uid >> _LOCAL_SHIFT) & LOCAL_MAX
    depth = (uid >> _DEPTH_SHIFT) & DEPTH_MAX
    morton = uid & MORTON_MAX
    return rank, local, depth, morton


def rank_of(uid: int) -> int:
    return (int(uid) >> _RANK_SHIFT) & RANK_MAX


def pack_array(
    ranks: np.ndarray, locals_: np.ndarray, depths: np.ndarray, mortons: np.ndarray
) -> np.ndarray:
    """Vectorised pack → uint64 array.  Used to build ``grid_property`` columns."""
    ranks = np.asarray(ranks, dtype=np.uint64)
    locals_ = np.asarray(locals_, dtype=np.uint64)
    depths = np.asarray(depths, dtype=np.uint64)
    mortons = np.asarray(mortons, dtype=np.uint64)
    for name, arr, mx in (
        ("rank", ranks, RANK_MAX),
        ("local", locals_, LOCAL_MAX),
        ("depth", depths, DEPTH_MAX),
        ("morton", mortons, MORTON_MAX),
    ):
        if arr.size and int(arr.max()) > mx:
            raise ValueError(f"{name} field overflows {mx}")
    return (
        (ranks << np.uint64(_RANK_SHIFT))
        | (locals_ << np.uint64(_LOCAL_SHIFT))
        | (depths << np.uint64(_DEPTH_SHIFT))
        | mortons
    )


def unpack_array(uids: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    uids = np.asarray(uids, dtype=np.uint64)
    ranks = (uids >> np.uint64(_RANK_SHIFT)) & np.uint64(RANK_MAX)
    locals_ = (uids >> np.uint64(_LOCAL_SHIFT)) & np.uint64(LOCAL_MAX)
    depths = (uids >> np.uint64(_DEPTH_SHIFT)) & np.uint64(DEPTH_MAX)
    mortons = uids & np.uint64(MORTON_MAX)
    return ranks, locals_, depths, mortons


# ---------------------------------------------------------------------------
# Morton (Lebesgue) codes — the paper's space-filling-curve partitioning.
# ---------------------------------------------------------------------------

def _part1by2(x: np.ndarray) -> np.ndarray:
    """Spread the low 10 bits of x so there are two zero bits between each."""
    x = x.astype(np.uint64) & np.uint64(0x3FF)
    x = (x | (x << np.uint64(16))) & np.uint64(0x30000FF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x300F00F)
    x = (x | (x << np.uint64(4))) & np.uint64(0x30C30C3)
    x = (x | (x << np.uint64(2))) & np.uint64(0x9249249)
    return x


def morton3(i: np.ndarray, j: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Interleave 3×10-bit coordinates into a 30-bit Morton code (vectorised)."""
    i = np.asarray(i, dtype=np.uint64)
    j = np.asarray(j, dtype=np.uint64)
    k = np.asarray(k, dtype=np.uint64)
    return _part1by2(i) | (_part1by2(j) << np.uint64(1)) | (_part1by2(k) << np.uint64(2))


def _compact1by2(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64) & np.uint64(0x9249249)
    x = (x ^ (x >> np.uint64(2))) & np.uint64(0x30C30C3)
    x = (x ^ (x >> np.uint64(4))) & np.uint64(0x300F00F)
    x = (x ^ (x >> np.uint64(8))) & np.uint64(0x30000FF)
    x = (x ^ (x >> np.uint64(16))) & np.uint64(0x3FF)
    return x


def morton3_inverse(code: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    code = np.asarray(code, dtype=np.uint64)
    return (
        _compact1by2(code),
        _compact1by2(code >> np.uint64(1)),
        _compact1by2(code >> np.uint64(2)),
    )
