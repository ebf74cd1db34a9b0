"""TH5 — a self-describing, shadow-paged container file (the HDF5 role, §3).

No h5py exists in this environment, and the brief requires every substrate to
be built, so TH5 re-implements the slice of HDF5 semantics the paper relies
on, tuned for the paper's access pattern:

  * **data model**: groups / datasets / attributes in a rooted tree
    (``/common``, ``/simulation/<step>/...`` — Fig. 4);
  * **storage model**: each dataset is "a header followed by the actual data
    in form of a linear array" — here the header lives in a central metadata
    index and the data is either one contiguous aligned extent (a rank's
    hyperslab write is a single ``pwrite`` with **no locking**) or, since
    format v2, a **chunked layout**: fixed row-count chunks run through a
    filter codec (``codecs`` — none/zlib/int8-blockq) and land as
    variable-length extents tracked by per-chunk index records
    (offset / stored nbytes / raw nbytes / CRCs / codec id), the HDF5
    chunk-B-tree role.  Partial reads decompress only intersecting chunks
    through a small LRU cache (:class:`ChunkCache`);
  * **self-description / portability**: dtypes are stored as numpy dtype
    strings with explicit endianness (``<f4`` etc.); readers byteswap when
    the host differs — the paper's HDF5 portability argument;
  * **parallel semantics**: dataset *creation* is collective (a single
    planner allocates extents — mirrors "group structure as well as every
    dataset has to be created collectively"), *writes* are independent
    per-rank ``os.pwrite`` calls into disjoint extents;
  * **crash consistency / TRS**: the file is *shadow-paged*.  A write
    session appends data extents and a fresh JSON metadata index, then flips
    the 512-byte superblock last (CRC-protected).  A crash mid-session
    leaves the previous superblock → previous index → all previous
    snapshots intact.  This is what makes the paper's time-reversible
    steering cheap: every committed generation remains addressable.
    On top of the shadow paging, every appended chunk is *published* to a
    sidecar journal (``<path>.journal``) after its stored bytes land: a
    self-delimiting, CRC-protected commit-mark record per chunk.  A writer
    killed at an arbitrary byte offset therefore loses at most the torn
    tail — :meth:`TH5File.recover` replays the journal against the last
    committed index, CRC-validates every journaled chunk, truncates the
    torn tail and reports a :class:`RecoveryReport` instead of raising.

Layout::

    [ superblock 512 B ][ pad to block ][ data extents ... ][ index JSON ]
                                         ^ aligned to block_size (§5.2)

The superblock is rewritten in place on commit; everything else is
append-only.

The authoritative byte-level format specification (superblock, index JSON,
chunk records, codec ids, commit protocol) is ``docs/FORMAT.md``; the write
/ read data-flow map is ``docs/ARCHITECTURE.md``.

Copied from ``src/repro/core/container.py``; only the import lines differ.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
import zlib
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Iterable, Mapping, Sequence

from ..obs import metrics as _metrics

import numpy as np

from . import codecs as _codecs
from .codecs import get_codec
from .hyperslab import SlabPlan, align_up
from .query import (
    MATCH_NONE,
    ChunkStats,
    Predicate,
    QueryResult,
    evaluate_mask,
    evaluate_stats,
    max_column,
)

IOV_MAX = 1024  # conservative portable IOV_MAX (per preadv/pwritev call)

MAGIC = b"TH5\x89"
VERSION = 2  # v2 = v1 + chunked datasets (index-level only; superblock unchanged)
MIN_READ_VERSION = 1  # v1 files are a strict subset (no chunk records)
SUPERBLOCK_SIZE = 512
DEFAULT_CHUNK_CACHE_BYTES = 32 << 20
_SB_FMT = "<4sIIQQQQdI"  # magic, version, block_size, index_off, index_len, file_end, generation, created, flags
_SB_FIXED = struct.calcsize(_SB_FMT)
DEFAULT_BLOCK = 4096

JOURNAL_MAGIC = b"TH5J"
_J_HDR_FMT = "<4sII"  # magic, payload_len, crc32(payload)
_J_HDR_SIZE = struct.calcsize(_J_HDR_FMT)


def journal_path(path: str) -> str:
    """Sidecar commit-mark journal for uncommitted chunk appends."""
    return path + ".journal"

ROOT = "/"


# -- publish/commit observer bus ------------------------------------------------
#
# Process-wide, realpath-keyed observers of chunk publication and commits.
# This is the live-streaming feed: a writable TH5File notifies registered
# hooks (a) per published chunk (``on_chunk``) and (b) per committed
# generation (``on_commit``), so a broker in the same process can fan
# committed chunks out to subscribers without polling the index.  Hooks are
# observers only — they run on the WRITER's thread and must be O(1) and
# non-blocking; any exception they raise is swallowed (a misbehaving
# subscriber must never corrupt or stall the write path).

_PUBLISH_HOOKS: dict[str, list[Any]] = {}
_HOOK_LOCK = threading.Lock()


def register_publish_hook(path: str, hook: Any) -> None:
    """Register ``hook`` for chunk/commit events on ``path`` (realpath-keyed).

    ``hook`` duck-types two methods, both optional:
    ``on_chunk(name, meta, chunk_index, rec)`` — called after a chunk's
    stored payload is on disk (possibly before it is committed);
    ``on_commit(generation)`` — called after a superblock flip makes every
    published chunk durable/visible."""
    key = os.path.realpath(path)
    with _HOOK_LOCK:
        _PUBLISH_HOOKS.setdefault(key, []).append(hook)


def unregister_publish_hook(path: str, hook: Any) -> None:
    key = os.path.realpath(path)
    with _HOOK_LOCK:
        hooks = _PUBLISH_HOOKS.get(key)
        if hooks is not None and hook in hooks:
            hooks.remove(hook)
            if not hooks:
                del _PUBLISH_HOOKS[key]


def _hooks_for(key: str) -> list[Any]:
    if not _PUBLISH_HOOKS:  # common case: nobody listening, zero locking
        return []
    with _HOOK_LOCK:
        return list(_PUBLISH_HOOKS.get(key, ()))


class TH5Error(RuntimeError):
    pass


class CorruptFileError(TH5Error):
    pass


class ReadCounter:
    """Read-syscall accounting (thread-safe) — the read-side mirror of
    ``aggregation.COPY_COUNTER``; benchmarks snapshot around a gather to
    compute syscalls-per-byte.

    ``registered=True`` (the process-wide :data:`READ_COUNTER` only) backs
    the tallies with the unified metrics registry (``io.read_syscalls`` /
    ``io.read_bytes``); locally-constructed instances stay anonymous so
    per-call deltas and resets never touch the process totals."""

    def __init__(self, registered: bool = False) -> None:
        self._lock = threading.Lock()
        if registered:
            self._syscalls = _metrics.REGISTRY.counter(_metrics.M_READ_SYSCALLS)
            self._bytes = _metrics.REGISTRY.counter(_metrics.M_READ_BYTES)
        else:
            self._syscalls = _metrics.Counter()
            self._bytes = _metrics.Counter()

    @property
    def n_syscalls(self) -> int:
        return int(self._syscalls.value)

    @property
    def bytes_read(self) -> int:
        return int(self._bytes.value)

    def add(self, nbytes: int, syscalls: int) -> None:
        with self._lock:
            self._syscalls.inc(int(syscalls))
            self._bytes.inc(int(nbytes))

    def reset(self) -> None:
        with self._lock:
            self._syscalls._reset()
            self._bytes._reset()

    def snapshot(self) -> tuple[int, int]:
        with self._lock:
            return int(self._syscalls.value), int(self._bytes.value)


READ_COUNTER = ReadCounter(registered=True)


def _advance(bufs: list[memoryview], skip: int) -> list[memoryview]:
    """Drop the first ``skip`` bytes from a buffer list (short-I/O resume)."""
    if skip == 0:
        return bufs
    out = []
    for b in bufs:
        if skip >= len(b):
            skip -= len(b)
            continue
        out.append(b[skip:] if skip else b)
        skip = 0
    return out


_byte_view = _codecs._byte_view  # writable flat byte view of a contiguous array


def preadv_full(fd: int, views: Sequence[memoryview], offset: int) -> tuple[int, int]:
    """Vectored scatter-read of one contiguous file range into many
    destination buffers (``os.preadv``), resuming short reads and chunking at
    IOV_MAX.  Returns (bytes_read, syscalls); raises on EOF mid-range."""
    total, calls = 0, 0
    for i in range(0, len(views), IOV_MAX):
        chunk = list(views[i : i + IOV_MAX])
        want = sum(len(v) for v in chunk)
        got = 0
        while got < want:  # preadv may be short
            n = os.preadv(fd, _advance(chunk, got), offset + total + got)
            calls += 1
            if n <= 0:
                raise CorruptFileError(
                    f"preadv hit EOF at offset {offset + total + got} "
                    f"({want - got} bytes missing)"
                )
            got += n
        total += want
    return total, calls


def _norm(path: str) -> str:
    if not path.startswith("/"):
        path = "/" + path
    while "//" in path:
        path = path.replace("//", "/")
    if len(path) > 1 and path.endswith("/"):
        path = path[:-1]
    return path


def _parents(path: str) -> list[str]:
    parts = [p for p in path.split("/") if p]
    out, cur = ["/"], ""
    for p in parts[:-1]:
        cur += "/" + p
        out.append(cur)
    return out


@dataclass
class ChunkRecord:
    """One chunk-index entry of a chunked dataset (format v2).

    Serialised compactly as the 6-tuple
    ``[offset, nbytes, raw_nbytes, raw_crc32, stored_crc32, codec_id]``,
    optionally extended by a 7th element — the chunk-statistics summary for
    predicate pushdown (``query.ChunkStats``; absent on files written
    before the stats index existed).  Byte layout and semantics are
    specified in ``docs/FORMAT.md``.
    """

    offset: int  # absolute file offset of the stored (post-filter) payload
    nbytes: int  # stored payload size — variable per chunk after filtering
    raw_nbytes: int  # pre-filter size (== chunk rows × row_bytes)
    raw_crc32: int  # CRC32 of the pre-filter bytes (verified for lossless codecs)
    stored_crc32: int  # CRC32 of the stored payload (verified for every codec)
    codec_id: int  # per-chunk: encoders fall back to 0 on incompressible data
    stats: ChunkStats | None = None  # optional pushdown summary (advisory, validated on use)

    def to_json(self) -> list:
        doc: list = [
            self.offset,
            self.nbytes,
            self.raw_nbytes,
            self.raw_crc32,
            self.stored_crc32,
            self.codec_id,
        ]
        if self.stats is not None:  # stats-less records stay byte-identical to v2.0
            doc.append(self.stats.to_json())
        return doc

    @staticmethod
    def from_json(v: Sequence) -> "ChunkRecord":
        """Version-tolerant decode: 6-element (pre-stats) and 7-element
        forms both load; elements past the 7th are ignored so still-newer
        writers stay readable.  A malformed stats element is kept as an
        invalid :class:`~repro.core.query.ChunkStats` (rejected by
        ``valid_for``) so query planners can name the offending chunk."""
        rec = ChunkRecord(*(int(x) for x in v[:6]))
        if len(v) > 6 and v[6] is not None:
            rec.stats = ChunkStats.from_json(v[6])
        return rec


@dataclass
class RecoveryReport:
    """What :meth:`TH5File.recover` found and salvaged.

    ``recover`` never raises on *partial* state (a torn journal tail, a
    half-written final chunk) — it truncates and reports here instead.  It
    still raises :class:`CorruptFileError` when the committed state itself
    (superblock / committed index) is unreadable, since there is nothing
    consistent to fall back to.
    """

    path: str  # container path the recovery ran against
    clean: bool  # True = no journal / empty journal: nothing to replay
    committed_generation: int  # generation of the last shadow-paged commit
    generation: int  # generation after recovery (== committed when clean)
    journal_records: int  # well-formed journal records scanned
    torn_journal: bool  # journal ended in a torn / CRC-failing record
    recovered_datasets: int  # uncommitted dataset shells re-added to the index
    recovered_chunks: int  # journaled chunks whose payload CRC-validated
    recovered_bytes: int  # stored payload bytes across recovered chunks
    truncated_chunks: int  # journaled chunks dropped (torn tail)
    scan_s: float  # wall-clock spent scanning + CRC-validating


@dataclass
class DatasetMeta:
    """The dataset 'header' — kept in the central index (self-description)."""

    dtype: str  # numpy dtype string with explicit byte order, e.g. "<f4"
    shape: tuple[int, ...]
    offset: int  # absolute file offset of the linear data array (0 if chunked)
    nbytes: int  # logical (pre-filter) payload size
    attrs: dict[str, Any] = field(default_factory=dict)
    crc32: int | None = None  # optional payload checksum (checkpoints: on)
    generation: int = 0
    codec: str = "none"  # filter spec the dataset was created with
    chunk_rows: int | None = None  # rows per chunk; None = contiguous layout
    chunks: list[ChunkRecord] | None = None  # chunk index, in chunk order

    def to_json(self) -> dict[str, Any]:
        doc = {
            "dtype": self.dtype,
            "shape": list(self.shape),
            "offset": self.offset,
            "nbytes": self.nbytes,
            "attrs": self.attrs,
            "crc32": self.crc32,
            "generation": self.generation,
        }
        if self.chunk_rows is not None:  # v1 JSON stays byte-identical otherwise
            doc["codec"] = self.codec
            doc["chunk_rows"] = self.chunk_rows
            doc["chunks"] = [c.to_json() for c in (self.chunks or [])]
        return doc

    @staticmethod
    def from_json(d: Mapping[str, Any]) -> "DatasetMeta":
        chunk_rows = d.get("chunk_rows")
        return DatasetMeta(
            dtype=d["dtype"],
            shape=tuple(d["shape"]),
            offset=int(d["offset"]),
            nbytes=int(d["nbytes"]),
            attrs=dict(d.get("attrs", {})),
            crc32=d.get("crc32"),
            generation=int(d.get("generation", 0)),
            codec=str(d.get("codec", "none")),
            chunk_rows=int(chunk_rows) if chunk_rows is not None else None,
            chunks=(
                [ChunkRecord.from_json(v) for v in d.get("chunks", [])]
                if chunk_rows is not None
                else None
            ),
        )

    @property
    def is_chunked(self) -> bool:
        return self.chunk_rows is not None

    @property
    def n_rows(self) -> int:
        return int(self.shape[0]) if self.shape else 1

    @property
    def n_chunks_expected(self) -> int:
        if self.chunk_rows is None:
            return 0
        return -(-self.n_rows // self.chunk_rows) if self.n_rows else 0

    @property
    def stored_nbytes(self) -> int:
        """Bytes on disk (post-filter) — equals ``nbytes`` when contiguous."""
        if self.chunks is None:
            return self.nbytes
        return sum(c.nbytes for c in self.chunks)

    def chunk_row_range(self, ci: int) -> tuple[int, int]:
        if self.chunk_rows is None:
            raise TH5Error("not a chunked dataset")
        lo = ci * self.chunk_rows
        return lo, min(lo + self.chunk_rows, self.n_rows)

    @property
    def np_dtype(self) -> np.dtype:
        try:
            return np.dtype(self.dtype)
        except TypeError:
            import ml_dtypes  # registers bfloat16/float8 names  # noqa: F401

            return np.dtype(self.dtype)

    @property
    def row_bytes(self) -> int:
        if len(self.shape) == 0:
            return self.np_dtype.itemsize
        per_row = int(np.prod(self.shape[1:], dtype=np.int64)) if len(self.shape) > 1 else 1
        return per_row * self.np_dtype.itemsize


@dataclass
class _Index:
    groups: dict[str, dict[str, Any]] = field(default_factory=dict)  # path -> attrs
    datasets: dict[str, DatasetMeta] = field(default_factory=dict)
    generation: int = 0
    lineage: dict[str, Any] = field(default_factory=dict)  # TRS parent info

    def to_bytes(self) -> bytes:
        doc = {
            "groups": self.groups,
            "datasets": {k: v.to_json() for k, v in self.datasets.items()},
            "generation": self.generation,
            "lineage": self.lineage,
        }
        payload = json.dumps(doc, separators=(",", ":")).encode("utf-8")
        crc = zlib.crc32(payload) & 0xFFFFFFFF
        return struct.pack("<I", crc) + payload

    @staticmethod
    def from_bytes(raw: bytes) -> "_Index":
        if len(raw) < 4:
            raise CorruptFileError("index truncated")
        (crc,) = struct.unpack_from("<I", raw, 0)
        payload = raw[4:]
        if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
            raise CorruptFileError("index CRC mismatch")
        doc = json.loads(payload.decode("utf-8"))
        idx = _Index(
            groups={_norm(k): v for k, v in doc.get("groups", {}).items()},
            datasets={
                _norm(k): DatasetMeta.from_json(v) for k, v in doc.get("datasets", {}).items()
            },
            generation=int(doc.get("generation", 0)),
            lineage=dict(doc.get("lineage", {})),
        )
        for k, m in idx.datasets.items():
            m.path = k  # runtime-only back-pointer (chunk-cache keys); not serialised
        return idx


def _pack_superblock(
    block_size: int, index_off: int, index_len: int, file_end: int, generation: int, created: float
) -> bytes:
    body = struct.pack(
        _SB_FMT, MAGIC, VERSION, block_size, index_off, index_len, file_end, generation, created, 0
    )
    crc = zlib.crc32(body) & 0xFFFFFFFF
    blob = body + struct.pack("<I", crc)
    return blob + b"\x00" * (SUPERBLOCK_SIZE - len(blob))


def _unpack_superblock(raw: bytes) -> tuple[int, int, int, int, int, float]:
    if len(raw) < _SB_FIXED + 4:
        raise CorruptFileError("superblock truncated")
    body = raw[:_SB_FIXED]
    (crc_stored,) = struct.unpack_from("<I", raw, _SB_FIXED)
    if (zlib.crc32(body) & 0xFFFFFFFF) != crc_stored:
        raise CorruptFileError("superblock CRC mismatch")
    magic, version, block_size, index_off, index_len, file_end, generation, created, _flags = (
        struct.unpack(_SB_FMT, body)
    )
    if magic != MAGIC:
        raise CorruptFileError(f"bad magic {magic!r}")
    if not (MIN_READ_VERSION <= version <= VERSION):
        raise CorruptFileError(f"unsupported version {version}")
    return block_size, index_off, index_len, file_end, generation, created


class ChunkCache:
    """Small LRU cache of *decoded* chunks (thread-safe).

    Keyed by ``(dataset_path, chunk_index)``; holds the native-dtype row
    arrays produced by the filter pipeline so sliding-window / LOD playback
    over a compressed dataset decompresses each chunk once, not once per
    window.  Contiguous-row reads of ``none``-codec chunks bypass the cache
    entirely — they scatter straight into the caller's buffer (zero-copy)
    and the page cache already holds the bytes.
    """

    def __init__(self, capacity_bytes: int = DEFAULT_CHUNK_CACHE_BYTES):
        self.capacity_bytes = int(capacity_bytes)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple[str, int], np.ndarray]" = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # process-wide mirrors (cache.* in the unified registry): every
        # cache instance adds into the same counters, while the per-
        # instance ints above stay this cache's local truth (stats())
        self._m_hits = _metrics.REGISTRY.counter(_metrics.M_CACHE_HITS)
        self._m_misses = _metrics.REGISTRY.counter(_metrics.M_CACHE_MISSES)
        self._m_evictions = _metrics.REGISTRY.counter(_metrics.M_CACHE_EVICTIONS)

    def contains(self, key: tuple[str, int]) -> bool:
        """Presence probe that mutates NOTHING — no LRU promotion, no
        hit/miss counters.  The service layer uses it to attribute shared-
        cache hits to individual clients without perturbing the cache; the
        answer is advisory under concurrency (an entry may be evicted
        between the probe and the read)."""
        with self._lock:
            return key in self._entries

    def get(self, key: tuple[str, int]) -> np.ndarray | None:
        with self._lock:
            arr = self._entries.get(key)
            if arr is None:
                self.misses += 1
            else:
                self._entries.move_to_end(key)
                self.hits += 1
        # registry mirror outside the cache lock (counters self-lock)
        if arr is None:
            self._m_misses.inc()
            return None
        self._m_hits.inc()
        return arr

    def put(self, key: tuple[str, int], arr: np.ndarray) -> None:
        if arr.nbytes > self.capacity_bytes:
            return
        evicted = 0
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._entries[key] = arr
            self._bytes += arr.nbytes
            while self._bytes > self.capacity_bytes and self._entries:
                _, victim = self._entries.popitem(last=False)
                self._bytes -= victim.nbytes
                self.evictions += 1
                evicted += 1
        if evicted:
            self._m_evictions.inc(evicted)

    def invalidate(self, path_prefix: str) -> None:
        """Drop cached chunks of datasets at/under ``path_prefix``."""
        with self._lock:
            doomed = [
                k
                for k in self._entries
                if k[0] == path_prefix or k[0].startswith(path_prefix + "/")
            ]
            for k in doomed:
                self._bytes -= self._entries.pop(k).nbytes

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0

    def stats(self) -> dict[str, int | float]:
        with self._lock:
            total = self.hits + self.misses
            return {
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "entries": len(self._entries),
                "bytes": self._bytes,
                "hit_rate": self.hits / total if total else 0.0,
            }


class TH5File:
    """A TH5 container.  Thread-safe for concurrent slab writes (no locks on
    the data path — extents are disjoint; only allocation takes a mutex,
    mirroring the collective create / independent write split)."""

    def __init__(self, path: str, fd: int, mode: str, block_size: int, index: _Index, file_end: int, created: float):
        self.path = path
        self._fd = fd
        self.mode = mode
        self.block_size = block_size
        self._index = index
        self._file_end = file_end
        self._created = created
        self._alloc_lock = threading.Lock()
        self._dirty = False
        self._closed = False
        # crash-consistent chunk publication (sidecar journal; docs/FORMAT.md
        # "Recovery invariants").  ``journaling`` may be switched off for
        # throwaway files; ``journal_sync`` adds the strict fsync ordering
        # (data fsync before each commit-mark) needed for whole-OS-crash
        # consistency — off by default, process-kill is the threat model.
        self.journaling = True
        self.journal_sync = False
        self._journal_fd: int | None = None
        self._journal_off = 0
        self._journal_lock = threading.Lock()
        self._journaled_datasets: set[str] = set()
        self._hook_key = os.path.realpath(path)  # publish/commit observer bus key
        self.chunk_cache = ChunkCache()
        # read-side decode pipeline (aggregation.DecodePipeline), created
        # lazily on the first chunked read; per-read + cumulative FilterStats
        self._decode_pipe = None
        self._read_stats_lock = threading.Lock()
        self.read_stats = None  # cumulative aggregation.FilterStats
        self.last_read_stats = None  # the most recent gather's FilterStats

    # -- lifecycle -----------------------------------------------------------

    @classmethod
    def create(cls, path: str, block_size: int = DEFAULT_BLOCK, lineage: Mapping[str, Any] | None = None) -> "TH5File":
        fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_TRUNC, 0o644)
        created = float(os.fstat(fd).st_ctime)
        index = _Index(groups={ROOT: {}}, lineage=dict(lineage or {}))
        file_end = align_up(SUPERBLOCK_SIZE, block_size)
        f = cls(path, fd, "r+", block_size, index, file_end, created)
        f._commit()  # generation 0: empty tree, valid superblock from the start
        return f

    @classmethod
    def open(cls, path: str, mode: str = "r") -> "TH5File":
        flags = os.O_RDONLY if mode == "r" else os.O_RDWR
        fd = os.open(path, flags)
        try:
            raw = os.pread(fd, SUPERBLOCK_SIZE, 0)
            block_size, idx_off, idx_len, file_end, generation, created = _unpack_superblock(raw)
            idx_raw = os.pread(fd, idx_len, idx_off)
            if len(idx_raw) != idx_len:
                raise CorruptFileError("index truncated (short read)")
            index = _Index.from_bytes(idx_raw)
            if index.generation != generation:
                raise CorruptFileError("index/superblock generation mismatch")
        except Exception:
            os.close(fd)
            raise
        return cls(path, fd, mode, block_size, index, file_end, created)

    @classmethod
    def recover(cls, path: str) -> tuple["TH5File", RecoveryReport]:
        """Open ``path`` writable and salvage uncommitted-but-published
        chunks from the sidecar journal.

        The committed shadow-paged state is loaded first (a corrupt
        superblock or committed index still raises
        :class:`CorruptFileError` — there is no consistent fallback).  The
        journal is then scanned record by record; scanning stops at the
        first torn / CRC-failing record.  Records from a different
        generation than the committed superblock are stale (a crash landed
        between the superblock flip and the journal truncate) and are
        skipped.  Each applicable chunk record is replayed only if its
        stored payload is fully inside the file AND matches
        ``stored_crc32`` — the first failure marks the torn tail and every
        later chunk record is dropped (journal order is publication order,
        so nothing after the tear is trustworthy).  Anything salvaged is
        committed as a fresh generation; the journal is reset either way.
        Never raises on partial state — the outcome is the returned
        :class:`RecoveryReport`.
        """
        t0 = time.perf_counter()
        f = cls.open(path, mode="r+")
        jpath = journal_path(path)
        try:
            with open(jpath, "rb") as fh:
                raw = fh.read()
        except FileNotFoundError:
            raw = b""

        records: list[dict] = []
        torn_journal = False
        pos = 0
        while pos + _J_HDR_SIZE <= len(raw):
            magic, plen, crc = struct.unpack_from(_J_HDR_FMT, raw, pos)
            body = raw[pos + _J_HDR_SIZE : pos + _J_HDR_SIZE + plen]
            if magic != JOURNAL_MAGIC or len(body) < plen:
                torn_journal = True
                break
            if (zlib.crc32(body) & 0xFFFFFFFF) != crc:
                torn_journal = True
                break
            try:
                records.append(json.loads(body.decode("utf-8")))
            except (ValueError, UnicodeDecodeError):
                torn_journal = True
                break
            pos += _J_HDR_SIZE + plen
        if pos != len(raw) and not torn_journal:
            torn_journal = True  # trailing partial header

        committed_gen = f._index.generation
        applicable = [r for r in records if r.get("gen") == committed_gen]
        fsize = os.fstat(f._fd).st_size
        recovered_datasets = recovered_chunks = truncated = 0
        recovered_bytes = 0
        torn = False  # first bad chunk record seen: drop everything after it
        for doc in applicable:
            op = doc.get("op")
            if torn:
                if op == "chunk":
                    truncated += 1
                continue
            if op == "dataset":
                name = _norm(str(doc["name"]))
                if name not in f._index.datasets:
                    meta = DatasetMeta.from_json(doc["meta"])
                    meta.path = name
                    for parent in _parents(name):
                        f._index.groups.setdefault(parent, {})
                    f._index.datasets[name] = meta
                    recovered_datasets += 1
            elif op == "chunk":
                name = _norm(str(doc["name"]))
                meta = f._index.datasets.get(name)
                if meta is None or meta.chunks is None or len(meta.chunks) >= meta.n_chunks_expected:
                    torn = True
                    truncated += 1
                    continue
                rec = ChunkRecord.from_json(doc["rec"])
                ok = 0 <= rec.offset and rec.offset + rec.nbytes <= fsize
                if ok:
                    stored = os.pread(f._fd, rec.nbytes, rec.offset)
                    ok = (
                        len(stored) == rec.nbytes
                        and (zlib.crc32(stored) & 0xFFFFFFFF) == rec.stored_crc32
                    )
                if not ok:
                    torn = True
                    truncated += 1
                    continue
                meta.chunks.append(rec)
                recovered_chunks += 1
                recovered_bytes += rec.nbytes
                with f._alloc_lock:
                    f._file_end = max(f._file_end, rec.offset + rec.nbytes)

        clean = not records and not torn_journal
        if not clean:
            f._dirty = True
            f._commit()  # publish the salvaged tree as a fresh generation
        # reset the sidecar: everything salvageable is now committed
        try:
            os.unlink(jpath)
        except OSError:
            pass
        report = RecoveryReport(
            path=path,
            clean=clean,
            committed_generation=committed_gen,
            generation=f._index.generation,
            journal_records=len(records),
            torn_journal=torn_journal,
            recovered_datasets=recovered_datasets,
            recovered_chunks=recovered_chunks,
            recovered_bytes=recovered_bytes,
            truncated_chunks=truncated,
            scan_s=time.perf_counter() - t0,
        )
        f.last_recovery = report
        return f, report

    def close(self) -> None:
        if self._closed:
            return
        if self._decode_pipe is not None:
            self._decode_pipe.close()
            self._decode_pipe = None
        if self._dirty and self.mode != "r":
            self._commit()
        if self._journal_fd is not None:
            empty = self._journal_off == 0
            os.close(self._journal_fd)
            self._journal_fd = None
            if empty:  # clean close: don't leave a zero-byte sidecar behind
                try:
                    os.unlink(journal_path(self.path))
                except OSError:
                    pass
        os.close(self._fd)
        self._closed = True

    def __enter__(self) -> "TH5File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def fd(self) -> int:
        """Raw fd for external slab writers (other threads / processes)."""
        return self._fd

    @property
    def generation(self) -> int:
        return self._index.generation

    @property
    def lineage(self) -> dict[str, Any]:
        return dict(self._index.lineage)

    # -- tree ----------------------------------------------------------------

    def create_group(self, path: str, attrs: Mapping[str, Any] | None = None) -> None:
        self._check_writable()
        path = _norm(path)
        for parent in _parents(path):
            self._index.groups.setdefault(parent, {})
        g = self._index.groups.setdefault(path, {})
        if attrs:
            g.update(attrs)
        self._dirty = True

    def groups(self) -> list[str]:
        return sorted(self._index.groups)

    def datasets(self) -> list[str]:
        return sorted(self._index.datasets)

    def group_attrs(self, path: str) -> dict[str, Any]:
        path = _norm(path)
        if path not in self._index.groups:
            raise KeyError(path)
        return dict(self._index.groups[path])

    def set_group_attrs(self, path: str, attrs: Mapping[str, Any]) -> None:
        self._check_writable()
        path = _norm(path)
        if path not in self._index.groups:
            raise KeyError(path)
        self._index.groups[path].update(attrs)
        self._dirty = True

    def children(self, path: str) -> list[str]:
        path = _norm(path)
        prefix = path if path.endswith("/") else path + "/"
        out = set()
        for p in list(self._index.groups) + list(self._index.datasets):
            if p.startswith(prefix):
                out.add(prefix + p[len(prefix) :].split("/")[0])
        return sorted(out)

    def exists(self, path: str) -> bool:
        path = _norm(path)
        return path in self._index.groups or path in self._index.datasets

    def drop_subtree(self, path: str) -> None:
        """Remove a group subtree from the *index* (data extents stay on
        disk — shadow paging; prior committed generations are unaffected)."""
        self._check_writable()
        path = _norm(path)
        prefix = path + "/"
        for d in [k for k in self._index.datasets if k == path or k.startswith(prefix)]:
            del self._index.datasets[d]
        for g in [k for k in self._index.groups if k == path or k.startswith(prefix)]:
            del self._index.groups[g]
        self.chunk_cache.invalidate(path)  # a rewrite must never serve stale chunks
        self._dirty = True

    def meta(self, name: str) -> DatasetMeta:
        name = _norm(name)
        try:
            return self._index.datasets[name]
        except KeyError:
            raise KeyError(f"no dataset {name!r} in {self.path}") from None

    def _name_of(self, meta: DatasetMeta) -> str:
        """Dataset path for chunk-cache keys when callers pass a meta.
        O(1): every indexed meta carries a runtime ``path`` back-pointer
        (set at create / index load); the scan is a last-resort fallback."""
        path = getattr(meta, "path", None)
        if path is not None:
            return path
        for k, v in self._index.datasets.items():
            if v is meta:
                return k
        return f"<anon@{id(meta):x}>"

    # -- dataset allocation (the 'collective create') --------------------------

    def alloc_extent(self, nbytes: int, align: bool = False) -> int:
        """Claim ``nbytes`` of append-only file space (the only lock on the
        write path).  Chunked writers call this per post-filter chunk, so
        consecutive appends from one pipeline are contiguous on disk."""
        with self._alloc_lock:
            off = align_up(self._file_end, self.block_size) if align else self._file_end
            self._file_end = off + nbytes
        return off

    def create_dataset(
        self,
        name: str,
        shape: Sequence[int],
        dtype: Any,
        attrs: Mapping[str, Any] | None = None,
        align: bool = True,
    ) -> DatasetMeta:
        """Allocate a dataset extent.  Collective in the paper's sense: exactly
        one planner (rank 0 / the host driver) calls this; the returned offsets
        are then broadcast to all writers."""
        self._check_writable()
        name = _norm(name)
        if name in self._index.datasets:
            raise TH5Error(f"dataset exists: {name}")
        dt = np.dtype(dtype)
        # force explicit byte order in the stored string (portability, §3);
        # extension dtypes (bfloat16 via ml_dtypes) stringify as opaque
        # '<V2' — store the registered NAME so readers reconstruct them
        dt_str = dt.name if dt.str.lstrip("<>=|").startswith("V") else dt.str
        shape = tuple(int(s) for s in shape)
        nbytes = int(np.prod(shape, dtype=np.int64)) * dt.itemsize if shape else dt.itemsize
        off = self.alloc_extent(nbytes, align=align)
        meta = DatasetMeta(
            dtype=dt_str,
            shape=shape,
            offset=off,
            nbytes=nbytes,
            attrs=dict(attrs or {}),
            generation=self._index.generation + 1,
        )
        for parent in _parents(name):
            self._index.groups.setdefault(parent, {})
        meta.path = name  # runtime-only back-pointer; not serialised
        self._index.datasets[name] = meta
        self._dirty = True
        return meta

    def create_slab_dataset(
        self, name: str, plan: SlabPlan, dtype: Any, cols: int | None = None, attrs: Mapping[str, Any] | None = None
    ) -> DatasetMeta:
        """Create the 2-D row-per-grid dataset for a :class:`SlabPlan`."""
        dt = np.dtype(dtype)
        if cols is None:
            if plan.row_bytes % dt.itemsize:
                raise TH5Error("row_bytes not a multiple of dtype size")
            cols = plan.row_bytes // dt.itemsize
        shape = (plan.total_rows, cols) if cols > 1 else (plan.total_rows,)
        a = dict(attrs or {})
        a.setdefault("row_starts", [int(x) for x in plan.row_starts])
        a.setdefault("row_counts", [int(x) for x in plan.row_counts])
        return self.create_dataset(name, shape, dt, attrs=a)

    # -- chunked datasets (format v2) ------------------------------------------

    def create_chunked_dataset(
        self,
        name: str,
        shape: Sequence[int],
        dtype: Any,
        chunk_rows: int,
        codec: str = "zlib",
        attrs: Mapping[str, Any] | None = None,
    ) -> DatasetMeta:
        """Create a chunked dataset: no extent is allocated up front — chunk
        extents are variable-length (post-filter) and appended as written,
        each tracked by a :class:`ChunkRecord` in the index."""
        self._check_writable()
        name = _norm(name)
        if name in self._index.datasets:
            raise TH5Error(f"dataset exists: {name}")
        shape = tuple(int(s) for s in shape)
        if not shape:
            raise TH5Error("chunked datasets need at least one dimension")
        chunk_rows = int(chunk_rows)
        if chunk_rows < 1:
            raise TH5Error("chunk_rows must be >= 1")
        get_codec(codec)  # validate the spec early
        dt = np.dtype(dtype)
        dt_str = dt.name if dt.str.lstrip("<>=|").startswith("V") else dt.str
        nbytes = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        meta = DatasetMeta(
            dtype=dt_str,
            shape=shape,
            offset=0,
            nbytes=nbytes,
            attrs=dict(attrs or {}),
            generation=self._index.generation + 1,
            codec=str(codec),
            chunk_rows=chunk_rows,
            chunks=[],
        )
        for parent in _parents(name):
            self._index.groups.setdefault(parent, {})
        meta.path = name  # runtime-only back-pointer; not serialised
        self._index.datasets[name] = meta
        self._dirty = True
        return meta

    def alloc_chunk(
        self,
        meta: DatasetMeta,
        nbytes: int,
        *,
        raw_nbytes: int,
        raw_crc32: int,
        stored_crc32: int,
        codec_id: int,
        stats: ChunkStats | None = None,
    ) -> ChunkRecord:
        """Allocate + record the next chunk extent WITHOUT writing the
        payload — the overlapped pipeline (``aggregation.ChunkPipeline``)
        issues its own vectored writes against the returned offsets."""
        self._check_writable()
        if meta.chunks is None:
            raise TH5Error("not a chunked dataset")
        if len(meta.chunks) >= meta.n_chunks_expected:
            raise TH5Error("dataset already fully written")
        rec = ChunkRecord(
            offset=self.alloc_extent(nbytes),
            nbytes=int(nbytes),
            raw_nbytes=int(raw_nbytes),
            raw_crc32=int(raw_crc32),
            stored_crc32=int(stored_crc32),
            codec_id=int(codec_id),
            stats=stats,
        )
        meta.chunks.append(rec)
        self._dirty = True
        return rec

    def append_chunk(
        self,
        name_or_meta: str | DatasetMeta,
        payload: bytes | memoryview,
        *,
        raw_nbytes: int,
        raw_crc32: int,
        stored_crc32: int,
        codec_id: int,
        stats: ChunkStats | None = None,
    ) -> ChunkRecord:
        """Write the next chunk's stored payload (``payload`` must be bytes
        or a flat byte view) and record it in the chunk index."""
        meta = name_or_meta if isinstance(name_or_meta, DatasetMeta) else self.meta(name_or_meta)
        n = payload.nbytes if isinstance(payload, memoryview) else len(payload)
        rec = self.alloc_chunk(
            meta,
            n,
            raw_nbytes=raw_nbytes,
            raw_crc32=raw_crc32,
            stored_crc32=stored_crc32,
            codec_id=codec_id,
            stats=stats,
        )
        pwrite_full(self._fd, payload, rec.offset)
        self.publish_chunk(meta, rec)
        return rec

    # -- crash-consistent publication (sidecar journal) ------------------------

    def _journal_ensure_fd(self) -> int:
        """Open (and reset) the sidecar journal lazily on first publication.

        A plain re-open of the container discards any uncommitted state by
        shadow-paging rules, so stale records from a crashed writer are
        truncated here — :meth:`recover` is the opt-in salvage path and runs
        *before* the file is written to again."""
        fd = self._journal_fd
        if fd is None:
            fd = os.open(journal_path(self.path), os.O_RDWR | os.O_CREAT, 0o644)
            os.ftruncate(fd, 0)
            self._journal_fd = fd
            self._journal_off = 0
        return fd

    def _journal_append(self, doc: Mapping[str, Any]) -> None:
        payload = json.dumps(doc, separators=(",", ":")).encode("utf-8")
        rec = (
            struct.pack(_J_HDR_FMT, JOURNAL_MAGIC, len(payload), zlib.crc32(payload) & 0xFFFFFFFF)
            + payload
        )
        if self.journal_sync:
            os.fsync(self._fd)  # stored bytes durable BEFORE their commit-mark
        with self._journal_lock:
            fd = self._journal_ensure_fd()
            off = self._journal_off
            self._journal_off = off + len(rec)
        pwrite_full(fd, rec, off)
        if self.journal_sync:
            os.fsync(fd)

    def publish_chunk(self, meta: DatasetMeta, rec: ChunkRecord) -> None:
        """Journal the commit-mark for one written chunk.

        Ordering contract (docs/FORMAT.md "Recovery invariants"): the stored
        payload must already be on disk (or at least issued — the record's
        ``stored_crc32`` is re-validated against the file at recovery time,
        so a mark that outruns its payload is detected, not trusted).
        :meth:`append_chunk` / :meth:`write_chunked` call this internally;
        external writers that drain payloads themselves against
        :meth:`alloc_chunk` offsets (``aggregation.ChunkPipeline``) call it
        once per record *after* the payload write completes.

        Registered publish hooks (:func:`register_publish_hook`) are
        notified regardless of ``journaling`` — the live-subscription feed
        and the crash journal are independent consumers of the same
        publication event."""
        if self.mode == "r":
            return
        name = self._name_of(meta)
        hooks = _hooks_for(self._hook_key)
        if hooks:
            # chunk_index by reverse identity scan: O(1) for the in-order
            # common case, still correct when a pipeline publishes records
            # out of append order
            ci = len(meta.chunks) - 1
            if meta.chunks[ci] is not rec:
                for i in range(len(meta.chunks) - 2, -1, -1):
                    if meta.chunks[i] is rec:
                        ci = i
                        break
            for h in hooks:
                try:
                    h.on_chunk(name, meta, ci, rec)
                except Exception:  # observers must never break the writer
                    pass
        if not self.journaling:
            return
        gen = self._index.generation
        if name not in self._journaled_datasets:
            shell = meta.to_json()
            shell["chunks"] = []  # chunk records are journaled individually
            self._journal_append({"op": "dataset", "gen": gen, "name": name, "meta": shell})
            self._journaled_datasets.add(name)
        self._journal_append({"op": "chunk", "gen": gen, "name": name, "rec": rec.to_json()})

    def write_chunked(self, name_or_meta: str | DatasetMeta, array: np.ndarray) -> int:
        """Synchronous whole-array chunked write (encode → append, one chunk
        at a time).  The overlapped encode-while-writing variant is
        ``aggregation.ChunkPipeline.write``; both produce identical files.
        Returns raw (pre-filter) bytes consumed."""
        meta = name_or_meta if isinstance(name_or_meta, DatasetMeta) else self.meta(name_or_meta)
        if meta.chunks is None:
            raise TH5Error("not a chunked dataset")
        arr = np.ascontiguousarray(array, dtype=meta.np_dtype)
        if arr.shape != meta.shape:
            raise TH5Error(f"shape mismatch: {arr.shape} != {meta.shape}")
        codec = get_codec(meta.codec)
        if meta.chunks and len(meta.chunks) >= meta.n_chunks_expected:
            raise TH5Error("dataset already fully written")
        total = 0
        for ci in range(len(meta.chunks), meta.n_chunks_expected):
            lo, hi = meta.chunk_row_range(ci)
            payload, raw_n, raw_crc, stored_crc, cid, stats = _codecs.encode_chunk_with_stats(
                codec, arr[lo:hi]
            )
            self.append_chunk(
                meta,
                payload,
                raw_nbytes=raw_n,
                raw_crc32=raw_crc,
                stored_crc32=stored_crc,
                codec_id=cid,
                stats=stats,
            )
            total += raw_n
        return total

    # -- the lock-free data path ----------------------------------------------

    def write_slab(self, name_or_meta: str | DatasetMeta, byte_offset: int, data: np.ndarray | bytes) -> int:
        """Independent write of one rank's hyperslab.  Thread-safe, lock-free:
        pwrite at (dataset base + byte_offset).  Returns bytes written."""
        self._check_writable()
        meta = name_or_meta if isinstance(name_or_meta, DatasetMeta) else self.meta(name_or_meta)
        if meta.is_chunked:
            raise TH5Error("write_slab on a chunked dataset — use write_chunked / ChunkPipeline")
        buf = data.tobytes() if isinstance(data, np.ndarray) else bytes(data)
        if byte_offset < 0 or byte_offset + len(buf) > meta.nbytes:
            raise TH5Error(
                f"slab [{byte_offset}, {byte_offset + len(buf)}) outside dataset of {meta.nbytes} B"
            )
        return pwrite_full(self._fd, buf, meta.offset + byte_offset)

    def write_rows(self, name_or_meta: str | DatasetMeta, row_start: int, array: np.ndarray) -> int:
        meta = name_or_meta if isinstance(name_or_meta, DatasetMeta) else self.meta(name_or_meta)
        arr = np.ascontiguousarray(array, dtype=meta.np_dtype)
        return self.write_slab(meta, row_start * meta.row_bytes, arr)

    def write_full(self, name_or_meta: str | DatasetMeta, array: np.ndarray, checksum: bool = False) -> int:
        meta = name_or_meta if isinstance(name_or_meta, DatasetMeta) else self.meta(name_or_meta)
        arr = np.ascontiguousarray(array, dtype=meta.np_dtype)
        if arr.nbytes != meta.nbytes:
            raise TH5Error(f"size mismatch: {arr.nbytes} != {meta.nbytes}")
        n = self.write_slab(meta, 0, arr)
        if checksum:
            meta.crc32 = zlib.crc32(arr.tobytes()) & 0xFFFFFFFF
            self._dirty = True
        return n

    def seal_checksum(self, name: str) -> int:
        """Compute+store the payload CRC after all slabs landed (checkpoints)."""
        self._check_writable()
        meta = self.meta(name)
        if meta.is_chunked:
            raise TH5Error("chunked datasets carry per-chunk CRCs; seal_checksum is contiguous-only")
        raw = os.pread(self._fd, meta.nbytes, meta.offset)
        meta.crc32 = zlib.crc32(raw) & 0xFFFFFFFF
        self._dirty = True
        return meta.crc32

    # -- reads -----------------------------------------------------------------

    @staticmethod
    def _is_native(dt: np.dtype) -> bool:
        return dt.byteorder in ("|", "=") or dt.isnative

    def _decode_pipeline(self):
        """The file's decode pipeline (``aggregation.DecodePipeline``),
        created lazily — every chunked read routes through it.  Init is
        guarded by ``_read_stats_lock`` so concurrent first reads share one
        pipeline (and one decode pool).  The deferred import breaks the
        container→aggregation cycle (aggregation imports this module at its
        top level)."""
        pipe = self._decode_pipe
        if pipe is None:
            from .aggregation import DecodePipeline  # deferred: circular import

            with self._read_stats_lock:
                pipe = self._decode_pipe
                if pipe is None:
                    pipe = self._decode_pipe = DecodePipeline(self)
        return pipe

    def set_decode_config(self, config, *, batch_fetch: bool = True) -> None:
        """Swap the decode pipeline's :class:`~repro.core.aggregation.
        AggregationConfig` (pool width = ``n_aggregators``).  Closes any
        existing pool, so the caller must be quiescent: a chunked read in
        flight on another thread would lose its pool mid-gather.
        ``batch_fetch=False`` disables the adjacent-chunk preadv batching
        (the benchmarks' unbatched baseline)."""
        from .aggregation import DecodePipeline  # deferred: circular import

        with self._read_stats_lock:
            old, self._decode_pipe = (
                self._decode_pipe,
                DecodePipeline(self, config, batch_fetch=batch_fetch),
            )
        if old is not None:
            old.close()

    def _gather_rows_chunked(
        self,
        name: str,
        meta: DatasetMeta,
        row_start: int,
        n_rows: int,
        out: np.ndarray,
        verify: bool = False,
    ) -> int:
        """Fill ``out`` with rows [row_start, row_start+n_rows) of a chunked
        dataset, decoding ONLY the intersecting chunks — via the overlapped
        :class:`~repro.core.aggregation.DecodePipeline` (chunk k+1's preadv
        in flight while chunk k inflates).  ``none``-codec chunks
        scatter-read straight into the destination rows (zero intermediate
        copies, like the contiguous path)."""
        return self._decode_pipeline().gather_rows(
            name, meta, row_start, n_rows, out, verify=verify
        )

    def query(
        self,
        name: str,
        predicate: Predicate,
        *,
        row_start: int = 0,
        n_rows: int | None = None,
        verify: bool = False,
    ) -> QueryResult:
        """Predicate-pushdown query: matching rows + selection mask over the
        window ``[row_start, row_start + n_rows)``.

        The planner intersects ``predicate`` against each intersecting
        chunk's stats summary and decodes **only** chunks the stats cannot
        rule out (via the shared :class:`DecodePipeline` / chunk cache).  A
        chunk is pruned only on a :data:`~repro.core.query.MATCH_NONE`
        proof from a record that passed
        :meth:`~repro.core.query.ChunkStats.valid_for`; absent, corrupt, or
        inconsistent stats degrade that chunk to decode-and-filter (the
        offending chunks are named in ``QueryResult.invalid_stats``).
        Results are bit-identical to ``read()[row_start:end][mask]`` where
        ``mask`` is the brute-force numpy evaluation of the predicate."""
        meta = self.meta(name)
        n_total = meta.n_rows
        if n_rows is None:
            n_rows = n_total - row_start
        if row_start < 0 or n_rows < 0 or row_start + n_rows > n_total:
            raise TH5Error("row range out of bounds")
        row_shape = tuple(meta.shape[1:])
        n_cols = 1
        for d in row_shape:
            n_cols *= int(d)
        if max_column(predicate) >= n_cols:
            raise TH5Error(
                f"predicate column {max_column(predicate)} out of range "
                f"(dataset has {n_cols} columns per row)"
            )
        native = meta.np_dtype.newbyteorder("=")
        row_end = row_start + n_rows
        empty_rows = np.empty((0,) + row_shape, dtype=native)

        if not meta.is_chunked:
            # contiguous layout: no stats index, no pruning — one window
            # read, exact filter
            mask = np.zeros(n_rows, dtype=bool)
            if n_rows:
                window = self.read_rows(name, row_start, n_rows, verify=verify)
                mask = evaluate_mask(predicate, window.reshape(n_rows, -1))
                rows = np.ascontiguousarray(window[mask])
            else:
                rows = empty_rows
            index = row_start + np.flatnonzero(mask).astype(np.int64)
            return QueryResult(
                rows=rows, index=index, mask=mask, row_start=row_start,
                n_chunks=0, chunks_pruned=0, chunks_decoded=0,
            )

        mask = np.zeros(n_rows, dtype=bool)
        pruned = 0
        invalid: list[int] = []
        survivors: list[int] = []
        if n_rows:
            c0 = row_start // meta.chunk_rows
            c1 = (row_end - 1) // meta.chunk_rows + 1
        else:
            c0 = c1 = 0
        for ci in range(c0, c1):
            if ci >= len(meta.chunks or ()):
                raise CorruptFileError(f"chunk {ci} of {name} missing (incomplete write)")
            rec = meta.chunks[ci]
            trusted = None
            if rec.stats is not None:
                lo, hi = meta.chunk_row_range(ci)
                if rec.stats.valid_for(hi - lo, n_cols, rec.raw_crc32):
                    trusted = rec.stats
                else:
                    invalid.append(ci)  # degrade-to-filter, but say which chunk
            if trusted is not None and evaluate_stats(predicate, trusted, native) == MATCH_NONE:
                pruned += 1  # proof: no row in ci can match — never fetched
                continue
            survivors.append(ci)
        decoded = (
            self._decode_pipeline().decode_chunks(name, meta, survivors, verify=verify)
            if survivors
            else {}
        )
        parts: list[np.ndarray] = []
        for ci in survivors:
            lo, hi = meta.chunk_row_range(ci)
            a, b = max(lo, row_start), min(hi, row_end)
            chunk_rows = decoded[ci][a - lo : b - lo]
            m = evaluate_mask(predicate, chunk_rows.reshape(b - a, -1))
            mask[a - row_start : b - row_start] = m
            if m.any():
                parts.append(np.ascontiguousarray(chunk_rows[m], dtype=native))
        rows = np.concatenate(parts, axis=0) if parts else empty_rows
        index = row_start + np.flatnonzero(mask).astype(np.int64)
        return QueryResult(
            rows=rows,
            index=index,
            mask=mask,
            row_start=row_start,
            n_chunks=c1 - c0,
            chunks_pruned=pruned,
            chunks_decoded=len(survivors),
            invalid_stats=tuple(invalid),
        )

    def read(self, name: str, verify: bool = False) -> np.ndarray:
        meta = self.meta(name)
        dt = meta.np_dtype
        if meta.is_chunked:
            out = np.empty(meta.shape, dtype=dt.newbyteorder("="))
            self._gather_rows_chunked(name, meta, 0, meta.n_rows, out, verify=verify)
            return out
        if self._is_native(dt):
            # vectored read straight into the result array — no intermediate
            # bytes object between the page cache and the caller's buffer
            out = np.empty(meta.shape, dtype=dt)
            try:
                n, calls = preadv_full(self._fd, [_byte_view(out)], meta.offset)
            except CorruptFileError:
                raise CorruptFileError(f"short read on {name}") from None
            READ_COUNTER.add(n, calls)
            if verify and meta.crc32 is not None:
                if (zlib.crc32(_byte_view(out)) & 0xFFFFFFFF) != meta.crc32:
                    raise CorruptFileError(f"payload CRC mismatch on {name}")
            return out
        # foreign-endian fallback: read raw, byteswap to native
        raw = os.pread(self._fd, meta.nbytes, meta.offset)
        READ_COUNTER.add(len(raw), 1)
        if len(raw) != meta.nbytes:
            raise CorruptFileError(f"short read on {name}")
        if verify and meta.crc32 is not None:
            if (zlib.crc32(raw) & 0xFFFFFFFF) != meta.crc32:
                raise CorruptFileError(f"payload CRC mismatch on {name}")
        arr = np.frombuffer(raw, dtype=dt)
        arr = arr.astype(arr.dtype.newbyteorder("="))
        return arr.reshape(meta.shape)

    def read_rows_into(
        self,
        name_or_meta: str | DatasetMeta,
        row_start: int,
        n_rows: int,
        out: np.ndarray,
        verify: bool = False,
    ) -> int:
        """Vectored read of contiguous rows into a preallocated buffer
        (``os.preadv`` — zero intermediate copies).  Returns bytes read.

        ``verify=True`` checks integrity like :meth:`read` does: per-chunk
        CRCs on chunked datasets (cache hits bypassed — verified reads
        never launder unverified decodes).  A contiguous dataset carries
        only a whole-payload CRC, so a *partial* verified read re-reads
        the full payload to check it — correct but O(dataset); chunked
        layouts are the scalable verified-read path."""
        meta = name_or_meta if isinstance(name_or_meta, DatasetMeta) else self.meta(name_or_meta)
        nrows_total = meta.shape[0] if meta.shape else 1
        if row_start < 0 or row_start + n_rows > nrows_total:
            raise TH5Error("row range out of bounds")
        want = n_rows * meta.row_bytes
        if out.nbytes != want:
            raise TH5Error(f"out buffer is {out.nbytes} B, need {want}")
        if not out.flags.c_contiguous or not out.flags.writeable:
            raise TH5Error("out buffer must be C-contiguous and writable")
        if meta.is_chunked:
            name = name_or_meta if isinstance(name_or_meta, str) else self._name_of(meta)
            return self._gather_rows_chunked(name, meta, row_start, n_rows, out, verify=verify)
        if verify and meta.crc32 is not None:
            name = name_or_meta if isinstance(name_or_meta, str) else self._name_of(meta)
            raw = os.pread(self._fd, meta.nbytes, meta.offset)
            READ_COUNTER.add(len(raw), 1)
            if len(raw) != meta.nbytes:
                raise CorruptFileError(f"short read on {name}")
            if (zlib.crc32(raw) & 0xFFFFFFFF) != meta.crc32:
                raise CorruptFileError(f"payload CRC mismatch on {name}")
            off = row_start * meta.row_bytes
            _byte_view(out)[:] = memoryview(raw)[off : off + want]
            return want
        n, calls = preadv_full(
            self._fd, [_byte_view(out)], meta.offset + row_start * meta.row_bytes
        )
        READ_COUNTER.add(n, calls)
        return n

    def read_rows(self, name: str, row_start: int, n_rows: int, verify: bool = False) -> np.ndarray:
        """Partial read of contiguous rows — one hyperslab.  On a chunked
        dataset only the intersecting chunks are read and decoded.  For
        ``verify`` semantics (and its cost on contiguous datasets) see
        :meth:`read_rows_into`."""
        meta = self.meta(name)
        dt = meta.np_dtype
        if self._is_native(dt) or meta.is_chunked:
            out = np.empty((n_rows,) + tuple(meta.shape[1:]), dtype=dt.newbyteorder("="))
            self.read_rows_into(meta, row_start, n_rows, out, verify=verify)
            return out
        if verify and meta.crc32 is not None:
            # foreign-endian contiguous: whole-payload CRC, then slice
            return np.ascontiguousarray(self.read(name, verify=True)[row_start : row_start + n_rows])
        nrows_total = meta.shape[0] if meta.shape else 1
        if row_start < 0 or row_start + n_rows > nrows_total:
            raise TH5Error("row range out of bounds")
        raw = os.pread(self._fd, n_rows * meta.row_bytes, meta.offset + row_start * meta.row_bytes)
        READ_COUNTER.add(len(raw), 1)
        arr = np.frombuffer(raw, dtype=dt)
        arr = arr.astype(arr.dtype.newbyteorder("="))
        return arr.reshape((n_rows,) + tuple(meta.shape[1:]))

    def read_row_indices(self, name: str, indices: Iterable[int]) -> np.ndarray:
        """Gather arbitrary rows (sliding-window reads) with vectored
        scatter-reads: contiguous row runs in the file become ONE ``preadv``
        that lands each row directly in its (possibly non-adjacent) slot of
        the output array — one syscall per run, zero staging copies."""
        meta = self.meta(name)
        idx = np.asarray(list(indices), dtype=np.int64)
        dt = meta.np_dtype
        out = np.empty((len(idx),) + tuple(meta.shape[1:]), dtype=dt.newbyteorder("="))
        if len(idx) == 0:
            return out
        nrows_total = meta.shape[0] if meta.shape else 1
        if idx.min() < 0 or idx.max() >= nrows_total:
            raise TH5Error("row range out of bounds")
        if meta.is_chunked:
            # gather by chunk: each intersecting chunk is read+decoded once
            # (LRU-cached) through the overlapped DecodePipeline — chunk
            # k+1's preadv runs while chunk k inflates — then its requested
            # rows fan out to their slots; sliding-window playback over a
            # compressed file never inflates the full dataset
            cr = meta.chunk_rows or 1
            cis = idx // cr
            decoded = self._decode_pipeline().decode_chunks(name, meta, np.unique(cis))
            if len(idx) > 1 and bool(np.all(idx[1:] > idx[:-1])):
                # strictly ascending selection (every window/LOD replay):
                # each chunk's slots form a CONTIGUOUS output span, and a
                # stride-1 run inside a chunk becomes one big slice copy
                # (~memcpy speed) instead of a fancy-indexed scatter — the
                # hot multi-client serve path (duplicate rows fall through
                # to the general scatter below)
                pos = 0
                for ci in np.unique(cis):
                    dec = decoded[int(ci)]
                    end = int(np.searchsorted(cis, ci, side="right"))
                    rel = idx[pos:end] - int(ci) * cr
                    k = end - pos
                    if k and int(rel[-1]) - int(rel[0]) + 1 == k:
                        out[pos:end] = dec[int(rel[0]) : int(rel[0]) + k]
                    else:
                        out[pos:end] = dec[rel]
                    pos = end
                return out
            for ci, dec in decoded.items():
                sel = cis == ci
                out[sel] = dec[idx[sel] - ci * cr]
            return out
        order = np.argsort(idx, kind="stable")
        sorted_idx = idx[order]
        scatter = self._is_native(dt)
        run_start = 0
        pos = 0
        while run_start < len(sorted_idx):
            run_end = run_start + 1
            while run_end < len(sorted_idx) and sorted_idx[run_end] == sorted_idx[run_end - 1] + 1:
                run_end += 1
            n = run_end - run_start
            if scatter:
                views = [_byte_view(out[j : j + 1]) for j in order[pos : pos + n]]
                got, calls = preadv_full(
                    self._fd, views, meta.offset + int(sorted_idx[run_start]) * meta.row_bytes
                )
                READ_COUNTER.add(got, calls)
            else:
                out[order[pos : pos + n]] = self.read_rows(name, int(sorted_idx[run_start]), n)
            pos += n
            run_start = run_end
        return out

    # -- commit (the shadow-page flip) ------------------------------------------

    def commit(self) -> int:
        """Durably publish the current tree: append index, flip superblock.
        Returns the new generation."""
        self._check_writable()
        return self._commit()

    def _commit(self) -> int:
        self._index.generation += 1
        blob = self._index.to_bytes()
        with self._alloc_lock:
            idx_off = align_up(self._file_end, self.block_size)
            self._file_end = idx_off + len(blob)
        pwrite_full(self._fd, blob, idx_off)
        os.fsync(self._fd)  # order: data+index durable before the flip
        sb = _pack_superblock(
            self.block_size, idx_off, len(blob), self._file_end, self._index.generation, self._created
        )
        pwrite_full(self._fd, sb, 0)
        os.fsync(self._fd)
        self._dirty = False
        # the committed index supersedes every journaled commit-mark: reset
        # the sidecar so the next interval starts empty (a crash between the
        # superblock flip and this truncate is harmless — stale records carry
        # the pre-commit generation and are skipped by recover())
        with self._journal_lock:
            if self._journal_fd is not None:
                os.ftruncate(self._journal_fd, 0)
                self._journal_off = 0
            else:
                try:  # stale sidecar from a crashed predecessor session
                    os.unlink(journal_path(self.path))
                except OSError:
                    pass
            self._journaled_datasets.clear()
        for h in _hooks_for(self._hook_key):
            try:
                h.on_commit(self._index.generation)
            except Exception:  # observers must never break the writer
                pass
        return self._index.generation

    def _check_writable(self) -> None:
        if self._closed:
            raise TH5Error("file closed")
        if self.mode == "r":
            raise TH5Error("file opened read-only")


def pwrite_full(fd: int, buf: bytes, offset: int) -> int:
    """pwrite loop (pwrite may be short on some filesystems)."""
    mv = memoryview(buf)
    total = 0
    while total < len(mv):
        n = os.pwrite(fd, mv[total:], offset + total)
        if n <= 0:
            raise OSError("pwrite returned %d" % n)
        total += n
    return total


def open_slab_writer(path: str) -> int:
    """Open an existing TH5 file for raw slab writes from a separate process
    (the multi-process bandwidth benchmarks).  Returns a raw fd; the caller
    pwrite()s into extents allocated by the planner process and must NOT
    touch the superblock/index."""
    return os.open(path, os.O_RDWR)
