"""Predicate pushdown over the per-chunk statistics index.

The analytical-query workload ("cells where ``|velocity| > v0`` in region
R") needs to *skip* chunks, not read them faster.  This module holds the
three pieces that make that sound:

* :class:`ChunkStats` — the per-chunk summary (min / max / ``nan_count`` /
  ``finite_count`` per **column group**) computed at encode time and stored
  as an optional 7th element of the ``ChunkRecord`` index tuple
  (``docs/FORMAT.md``).  For lossy codecs the summary is computed on the
  *post-codec-roundtrip* values, so the stored bounds always bracket what a
  reader will actually decode.
* a tiny predicate expression language — comparisons of a column (optionally
  ``abs()``-wrapped) against a constant, combined with ``&`` / ``|`` / ``~``
  — built with :func:`col` and serialisable to JSON for the wire.
* two evaluators: :func:`evaluate_mask` (exact, per-row, numpy semantics —
  the same code path the differential oracle uses) and
  :func:`evaluate_stats` (tri-state interval evaluation against a chunk's
  stats: ``MATCH_NONE`` proves no row in the chunk can satisfy the
  predicate, so the planner may prune the chunk without decoding it).
  Numpy's row semantics are not plain real arithmetic — integer columns
  are cast to float64 (lossy past ``2**53``), ``np.abs`` overflows at a
  signed dtype's minimum, and sub-double float columns compare against
  the constant *cast down to the column dtype* — so ``evaluate_stats``
  takes the column dtype and either mirrors those semantics exactly or
  refuses to claim a proof (``MATCH_SOME``) where they could diverge
  from its interval arithmetic.

Soundness contract: stats are **advisory**.  A record is trusted only when
:meth:`ChunkStats.valid_for` accepts it against the chunk it claims to
summarise (column count, group shape, count bounds, min<=max, and a CRC
echo binding the summary to the chunk's raw payload).  Anything else —
absent, corrupt, stale-generation, or internally inconsistent — degrades
that chunk to decode-and-filter; a pruned chunk is pruned only on a proof.

Copied from ``src/repro/core/query.py``; only the import lines differ.
"""

from __future__ import annotations

import math
from bisect import bisect_right
from dataclasses import dataclass, field
from typing import Any

import numpy as np

__all__ = [
    "MATCH_ALL",
    "MATCH_NONE",
    "MATCH_SOME",
    "MAX_STAT_GROUPS",
    "And",
    "ChunkStats",
    "Cmp",
    "Col",
    "Not",
    "Or",
    "Predicate",
    "QueryResult",
    "col",
    "compute_chunk_stats",
    "evaluate_mask",
    "evaluate_stats",
    "group_starts",
    "max_column",
    "pred_from_json",
]

#: ceiling on column groups per chunk summary — bounds index growth to a
#: few dozen JSON numbers per chunk regardless of row width
MAX_STAT_GROUPS = 8

_CMP_OPS = ("<", "<=", ">", ">=", "==", "!=")


def group_starts(n_cols: int, n_groups: int) -> list[int]:
    """Start column of each group under the balanced contiguous partition
    (group ``j`` covers ``[j*C//G, (j+1)*C//G)``)."""
    return [j * n_cols // n_groups for j in range(n_groups)]


# -- the per-chunk summary record -----------------------------------------------


@dataclass(frozen=True)
class ChunkStats:
    """Column-group summaries of one chunk (see module docstring).

    ``mins`` / ``maxs`` bound the **non-NaN** values of each group (``None``
    when the group is entirely NaN, so ±inf still participates in pruning);
    ``nan_counts`` / ``finite_counts`` count NaN and finite values per
    group.  ``crc_echo`` repeats the chunk's ``raw_crc32`` so a summary
    paired with the wrong chunk (stale generation, index surgery) is
    rejected by :meth:`valid_for` instead of silently mispruning.
    """

    crc_echo: int
    n_cols: int
    mins: tuple  # per-group lower bound over non-NaN values (None = all NaN)
    maxs: tuple  # per-group upper bound over non-NaN values (None = all NaN)
    nan_counts: tuple  # per-group count of NaN values
    finite_counts: tuple  # per-group count of finite (non-NaN, non-inf) values

    def to_json(self) -> list:
        return [
            self.crc_echo,
            self.n_cols,
            list(self.mins),
            list(self.maxs),
            list(self.nan_counts),
            list(self.finite_counts),
        ]

    _INVALID_SENTINEL = (-1, -1, (), (), (), ())

    @staticmethod
    def from_json(doc: Any) -> "ChunkStats":
        """Lenient parse: structural garbage yields a record that
        :meth:`valid_for` rejects (so the planner can still *name* the
        offending chunk instead of treating it as stats-less)."""
        try:
            crc, n_cols, mins, maxs, nans, fins = doc
            return ChunkStats(
                crc_echo=int(crc),
                n_cols=int(n_cols),
                mins=tuple(None if m is None else (m if isinstance(m, (int, float)) else float(m)) for m in mins),
                maxs=tuple(None if m is None else (m if isinstance(m, (int, float)) else float(m)) for m in maxs),
                nan_counts=tuple(int(c) for c in nans),
                finite_counts=tuple(int(c) for c in fins),
            )
        except (TypeError, ValueError, OverflowError):
            # OverflowError: int(float("inf")) — stdlib json happily emits
            # Infinity tokens, which must degrade, not crash the index load
            return ChunkStats(*ChunkStats._INVALID_SENTINEL)

    def valid_for(self, n_rows: int, n_cols: int, raw_crc32: int) -> bool:
        """Full consistency check against the chunk this record is attached
        to.  False ⇒ the planner must decode-and-filter the chunk."""
        g = len(self.mins)
        if self.n_cols != n_cols or self.crc_echo != raw_crc32:
            return False
        if not 1 <= g <= n_cols or g > MAX_STAT_GROUPS:
            return False
        if not (len(self.maxs) == len(self.nan_counts) == len(self.finite_counts) == g):
            return False
        starts = group_starts(n_cols, g) + [n_cols]
        for j in range(g):
            size = (starts[j + 1] - starts[j]) * n_rows
            lo, hi = self.mins[j], self.maxs[j]
            nan, fin = self.nan_counts[j], self.finite_counts[j]
            if not (0 <= nan <= size and 0 <= fin <= size and nan + fin <= size):
                return False
            if (lo is None) != (hi is None):
                return False
            if lo is None:
                if nan != size:  # "all NaN" claim must match the NaN count
                    return False
                continue
            if isinstance(lo, float) and math.isnan(lo):
                return False
            if isinstance(hi, float) and math.isnan(hi):
                return False
            if nan >= size or lo > hi:
                return False
        return True

    def group_of(self, column: int) -> int:
        starts = group_starts(self.n_cols, len(self.mins))
        return bisect_right(starts, column) - 1


def compute_chunk_stats(
    chunk: np.ndarray, raw_crc32: int, max_groups: int = MAX_STAT_GROUPS
) -> ChunkStats | None:
    """Summarise one chunk's rows (shape ``(n_rows, *row_shape)``) into a
    :class:`ChunkStats`, or ``None`` when the dtype has no usable ordering
    (stats are optional — absent stats just means no pruning).

    Callers on a lossy encode path must pass the *decoded* chunk, not the
    source values (``codecs.encode_chunk_with_stats`` does this)."""
    try:
        a = np.asarray(chunk)
        n_rows = int(a.shape[0]) if a.ndim else 1
        if n_rows <= 0:
            return None
        cols = a.reshape(n_rows, -1)
        n_cols = cols.shape[1]
        if n_cols == 0:
            return None
        kind = cols.dtype.kind
        if kind not in "fiub" and cols.dtype.name != "bfloat16":
            return None
        g = min(n_cols, max_groups)
        starts = group_starts(n_cols, g) + [n_cols]
        mins, maxs, nans, fins = [], [], [], []
        for j in range(g):
            seg = cols[:, starts[j] : starts[j + 1]]
            if kind in "iub":  # exact integer bounds (no float rounding)
                mins.append(int(seg.min()))
                maxs.append(int(seg.max()))
                nans.append(0)
                fins.append(int(seg.size))
            else:
                nan_mask = np.isnan(seg)
                n_nan = int(np.count_nonzero(nan_mask))
                nans.append(n_nan)
                fins.append(int(np.count_nonzero(np.isfinite(seg))))
                if n_nan == seg.size:
                    mins.append(None)
                    maxs.append(None)
                else:
                    nonnan = seg[~nan_mask] if n_nan else seg
                    mins.append(float(nonnan.min()))
                    maxs.append(float(nonnan.max()))
        return ChunkStats(
            crc_echo=int(raw_crc32) & 0xFFFFFFFF,
            n_cols=n_cols,
            mins=tuple(mins),
            maxs=tuple(maxs),
            nan_counts=tuple(nans),
            finite_counts=tuple(fins),
        )
    except (TypeError, ValueError):  # exotic dtypes: stats stay absent
        return None


# -- the predicate expression language ------------------------------------------


class _PredicateBase:
    """Mixin giving every predicate node ``&`` / ``|`` / ``~``."""

    def __and__(self, other: "Predicate") -> "And":
        return And(self, _as_pred(other))

    def __or__(self, other: "Predicate") -> "Or":
        return Or(self, _as_pred(other))

    def __invert__(self) -> "Not":
        return Not(self)


@dataclass(frozen=True, eq=False)  # eq=False: == / != build Cmp leaves
class Col:
    """A column reference, optionally ``abs()``-wrapped — comparison
    operators against a scalar produce :class:`Cmp` leaves."""

    index: int
    absolute: bool = False

    def __abs__(self) -> "Col":
        return Col(self.index, absolute=True)

    def _cmp(self, op: str, value: Any) -> "Cmp":
        if isinstance(value, Col) or isinstance(value, _PredicateBase):
            raise TypeError("predicates compare a column against a scalar constant")
        return Cmp(self.index, self.absolute, op, float(value))

    def __lt__(self, v):
        return self._cmp("<", v)

    def __le__(self, v):
        return self._cmp("<=", v)

    def __gt__(self, v):
        return self._cmp(">", v)

    def __ge__(self, v):
        return self._cmp(">=", v)

    def __eq__(self, v):  # type: ignore[override]
        return self._cmp("==", v)

    def __ne__(self, v):  # type: ignore[override]
        return self._cmp("!=", v)

    def __hash__(self):
        return hash((Col, self.index, self.absolute))


def col(index: int) -> Col:
    """Entry point of the builder DSL: ``col(3) > 0.5``,
    ``abs(col(0)) <= v0``, ``(col(1) >= a) & ~(col(2) == b)``."""
    if index < 0:
        raise ValueError("column index must be >= 0")
    return Col(int(index))


#: wire spellings of the non-finite constants — RFC 8259 JSON has no
#: NaN/Infinity tokens, so ``Cmp.to_json`` encodes them as strings
_NONFINITE_SENTINELS = {"nan": math.nan, "inf": math.inf, "-inf": -math.inf}


@dataclass(frozen=True)
class Cmp(_PredicateBase):
    """Leaf: ``column <op> value`` (``abs(column)`` when ``absolute``).
    Semantics are numpy's — NaN compares False under everything but ``!=``."""

    column: int
    absolute: bool
    op: str
    value: float

    def __post_init__(self):
        if self.op not in _CMP_OPS:
            raise ValueError(f"unknown comparison op {self.op!r}")
        if self.column < 0:
            raise ValueError("column index must be >= 0")

    def to_json(self) -> list:
        v: float | str = self.value
        if math.isnan(v):
            v = "nan"
        elif math.isinf(v):
            v = "inf" if v > 0 else "-inf"
        return ["cmp", self.column, int(self.absolute), self.op, v]


@dataclass(frozen=True)
class And(_PredicateBase):
    lhs: "Predicate"
    rhs: "Predicate"

    def to_json(self) -> list:
        return ["and", self.lhs.to_json(), self.rhs.to_json()]


@dataclass(frozen=True)
class Or(_PredicateBase):
    lhs: "Predicate"
    rhs: "Predicate"

    def to_json(self) -> list:
        return ["or", self.lhs.to_json(), self.rhs.to_json()]


@dataclass(frozen=True)
class Not(_PredicateBase):
    operand: "Predicate"

    def to_json(self) -> list:
        return ["not", self.operand.to_json()]


#: the predicate node union — every tree the planner / wire accepts
Predicate = Cmp | And | Or | Not


def _as_pred(node: Any):
    if isinstance(node, (Cmp, And, Or, Not)):
        return node
    raise TypeError(f"not a predicate: {type(node).__name__}")


def pred_from_json(doc: Any):
    """Inverse of ``Predicate.to_json`` — raises ``ValueError`` on any
    malformed tree (wire decoding maps that to a typed protocol error)."""
    try:
        tag = doc[0]
        if tag == "cmp":
            _, column, absolute, op, value = doc
            if isinstance(value, str):
                if value not in _NONFINITE_SENTINELS:
                    raise ValueError(f"bad constant sentinel {value!r}")
                value = _NONFINITE_SENTINELS[value]
            return Cmp(int(column), bool(absolute), str(op), float(value))
        if tag == "and":
            return And(pred_from_json(doc[1]), pred_from_json(doc[2]))
        if tag == "or":
            return Or(pred_from_json(doc[1]), pred_from_json(doc[2]))
        if tag == "not":
            return Not(pred_from_json(doc[1]))
    except ValueError:
        raise
    except Exception as e:
        raise ValueError(f"malformed predicate: {e}") from None
    raise ValueError(f"malformed predicate: unknown node {tag!r}")


def max_column(pred: Any) -> int:
    """Largest column index referenced — planners bounds-check this against
    the dataset's row width before touching any chunk."""
    if isinstance(pred, Cmp):
        return pred.column
    if isinstance(pred, (And, Or)):
        return max(max_column(pred.lhs), max_column(pred.rhs))
    if isinstance(pred, Not):
        return max_column(pred.operand)
    raise TypeError(f"not a predicate: {type(pred).__name__}")


# -- exact evaluation (the oracle path) -----------------------------------------


def evaluate_mask(pred: Any, rows: np.ndarray) -> np.ndarray:
    """Exact per-row evaluation on a ``(n, n_cols)`` array; returns a bool
    mask of length ``n``.  Pure numpy comparison semantics — the
    differential oracle evaluates the same expressions by hand."""
    if isinstance(pred, Cmp):
        v = rows[:, pred.column]
        if pred.absolute:
            v = np.abs(v)
        with np.errstate(invalid="ignore"):
            if pred.op == "<":
                return np.asarray(v < pred.value)
            if pred.op == "<=":
                return np.asarray(v <= pred.value)
            if pred.op == ">":
                return np.asarray(v > pred.value)
            if pred.op == ">=":
                return np.asarray(v >= pred.value)
            if pred.op == "==":
                return np.asarray(v == pred.value)
            return np.asarray(v != pred.value)
    if isinstance(pred, And):
        return evaluate_mask(pred.lhs, rows) & evaluate_mask(pred.rhs, rows)
    if isinstance(pred, Or):
        return evaluate_mask(pred.lhs, rows) | evaluate_mask(pred.rhs, rows)
    if isinstance(pred, Not):
        return ~evaluate_mask(pred.operand, rows)
    raise TypeError(f"not a predicate: {type(pred).__name__}")


# -- tri-state interval evaluation (the pruning path) ---------------------------

MATCH_NONE = 0  # proof: no row in the chunk can satisfy the predicate
MATCH_SOME = 1  # unknown — decode and filter
MATCH_ALL = 2  # proof: every row satisfies (lets ~ / & / | stay exact)


def _abs_interval(lo, hi):
    if lo is None:
        return None, None
    alo = 0.0 if lo <= 0 <= hi else min(abs(lo), abs(hi))
    return alo, max(abs(lo), abs(hi))


#: magnitude at which numpy's int→float64 comparison cast starts rounding
_F64_EXACT_LIMIT = 1 << 53
#: signed-integer dtype minima, where ``np.abs`` overflows to its input
_SIGNED_INT_MINS = frozenset(-(1 << (b - 1)) for b in (8, 16, 32, 64))


def _int_bounds_unsafe(lo, hi, absolute: bool, dtype) -> bool:
    """True when exact interval arithmetic over an integer group can
    disagree with numpy's row evaluation: comparisons cast integer columns
    to float64 (lossy at ``|x| >= 2**53``), and ``np.abs`` at a signed
    dtype's minimum overflows to itself instead of negating.  Uncertain ⇒
    unsafe (the caller degrades to ``MATCH_SOME``)."""
    if abs(lo) >= _F64_EXACT_LIMIT or abs(hi) >= _F64_EXACT_LIMIT:
        return True
    if absolute and lo < 0:
        if dtype is not None and dtype.kind == "i":
            return lo <= np.iinfo(dtype).min
        return lo in _SIGNED_INT_MINS  # dtype unknown: any plausible minimum
    return False


def _effective_constant(v: float, dtype) -> float | None:
    """The float64 value numpy actually compares a column against.  Weak
    python-float constants are cast *down* to sub-double float column
    dtypes before comparing (bfloat16 comparisons run in float32), so the
    interval math must see that rounded value, not the original.  ``None``
    ⇒ the dtype's comparison semantics are unmodelled here — the caller
    must not claim a proof."""
    if dtype is None or dtype.kind in "iub":
        return v  # integer columns are cast to float64; v compares as-is
    if dtype.kind == "f":
        if dtype.itemsize >= 8:
            return v
        with np.errstate(over="ignore"):  # huge v casts to ±inf, silently
            return float(dtype.type(v))
    if dtype.name == "bfloat16":
        with np.errstate(over="ignore"):
            return float(np.float32(v))
    return None


def _cmp_tri(op: str, lo, hi, has_nan: bool, v: float) -> int:
    """Tri-state of ``x <op> v`` over an interval [lo, hi] of the chunk's
    non-NaN values (lo is None = every value NaN).  NaN operands compare
    False under everything but ``!=`` (numpy semantics) — ``has_nan``
    therefore blocks ALL claims for the ordering ops."""
    if op == "!=":
        if lo is None or v < lo or v > hi:  # NaN != v is True
            return MATCH_ALL
        if lo == hi == v and not has_nan:
            return MATCH_NONE
        return MATCH_SOME
    if lo is None:  # all NaN: every ordering / equality comparison is False
        return MATCH_NONE
    if op == ">":
        if not hi > v:
            return MATCH_NONE
        return MATCH_ALL if (lo > v and not has_nan) else MATCH_SOME
    if op == ">=":
        if not hi >= v:
            return MATCH_NONE
        return MATCH_ALL if (lo >= v and not has_nan) else MATCH_SOME
    if op == "<":
        if not lo < v:
            return MATCH_NONE
        return MATCH_ALL if (hi < v and not has_nan) else MATCH_SOME
    if op == "<=":
        if not lo <= v:
            return MATCH_NONE
        return MATCH_ALL if (hi <= v and not has_nan) else MATCH_SOME
    # op == "=="
    if v < lo or v > hi:
        return MATCH_NONE
    return MATCH_ALL if (lo == hi == v and not has_nan) else MATCH_SOME


def evaluate_stats(pred: Any, stats: ChunkStats, dtype: Any = None) -> int:
    """Tri-state evaluation of ``pred`` against one chunk's (validated)
    stats.  Group bounds are a superset interval of every member column's
    values, so ALL / NONE verdicts at group level transfer soundly to the
    column; anything uncertain collapses to ``MATCH_SOME`` (decode).

    ``dtype`` is the column dtype, used to mirror numpy's comparison
    semantics exactly (sub-double constants are rounded to the column
    dtype; unsafe integer bounds refuse proofs — see the module
    docstring).  Pass it whenever verdicts gate pruning: without it,
    float bounds are assumed to carry float64 comparison semantics, and
    integer unsafety falls back to dtype-agnostic (more conservative)
    checks."""
    if isinstance(pred, Cmp):
        g = stats.group_of(pred.column)
        lo, hi = stats.mins[g], stats.maxs[g]
        has_nan = stats.nan_counts[g] > 0
        v = pred.value
        if isinstance(v, float) and math.isnan(v):
            # x <op> NaN: False for everything but !=, True for != —
            # regardless of the data; decide without the interval
            return MATCH_ALL if pred.op == "!=" else MATCH_NONE
        if lo is not None:
            is_int = (
                dtype.kind in "iub"
                if dtype is not None
                else isinstance(lo, int) or isinstance(hi, int)
            )
            if is_int and _int_bounds_unsafe(lo, hi, pred.absolute, dtype):
                return MATCH_SOME  # numpy may diverge from interval math
            v = _effective_constant(v, dtype)
            if v is None:
                return MATCH_SOME  # unmodelled dtype: never claim a proof
        if pred.absolute:
            lo, hi = _abs_interval(lo, hi)
        return _cmp_tri(pred.op, lo, hi, has_nan, v)
    if isinstance(pred, And):
        a = evaluate_stats(pred.lhs, stats, dtype)
        b = evaluate_stats(pred.rhs, stats, dtype)
        if a == MATCH_NONE or b == MATCH_NONE:
            return MATCH_NONE
        if a == MATCH_ALL and b == MATCH_ALL:
            return MATCH_ALL
        return MATCH_SOME
    if isinstance(pred, Or):
        a = evaluate_stats(pred.lhs, stats, dtype)
        b = evaluate_stats(pred.rhs, stats, dtype)
        if a == MATCH_ALL or b == MATCH_ALL:
            return MATCH_ALL
        if a == MATCH_NONE and b == MATCH_NONE:
            return MATCH_NONE
        return MATCH_SOME
    if isinstance(pred, Not):
        inner = evaluate_stats(pred.operand, stats, dtype)
        if inner == MATCH_ALL:
            return MATCH_NONE
        if inner == MATCH_NONE:
            return MATCH_ALL
        return MATCH_SOME
    raise TypeError(f"not a predicate: {type(pred).__name__}")


# -- the query result -----------------------------------------------------------


@dataclass
class QueryResult:
    """What the planner returns: the matching rows, where they are, and an
    audit trail of how much decoding the stats index saved."""

    rows: np.ndarray  # matching rows, shape (k, *row_shape), dataset dtype
    index: np.ndarray  # absolute row indices of the matches (int64, ascending)
    mask: np.ndarray  # bool selection mask over the queried window
    row_start: int  # first row of the window the mask covers
    n_chunks: int  # chunks intersecting the window (0 for contiguous layout)
    chunks_pruned: int  # chunks skipped on a stats proof (never decoded)
    chunks_decoded: int  # chunks decoded and row-filtered
    invalid_stats: tuple[int, ...] = field(default_factory=tuple)  # offending chunk indices

    @property
    def n_rows(self) -> int:
        return int(self.mask.size)

    @property
    def n_matches(self) -> int:
        return int(self.index.size)

    @property
    def pruned_ratio(self) -> float:
        return self.chunks_pruned / self.n_chunks if self.n_chunks else 0.0

    @property
    def nbytes(self) -> int:
        return int(self.rows.nbytes + self.mask.nbytes)
