"""Collective buffering — the paper's decisive optimisation (§5.2).

On JuQueen only 16 of 1024 nodes have I/O links; MPI-IO's collective
buffering routes all data through *aggregator* nodes sitting on those links:

    "Collective buffering utilises a subset of the computing nodes as
     aggregators, which collect data from the different processes and manage
     the file accesses. ... Data is collected over the very fast intra-rack
     network while the I/O links are utilised to their full extent."

TPU adaptation: every TPU host owns the PCIe/NIC path for its local devices;
"aggregation over the fast network" becomes (a) on-device gathers along mesh
axes onto aggregator shards (see ``collective_io.gather_to_aggregators``)
and (b) the host-side coalescing implemented here: N logical ranks hand
their disjoint extents to A aggregators; each aggregator merges adjacent
extents into maximal contiguous runs and issues few, large ``pwritev`` calls
instead of many small ones.  Because the hyperslab planner orders extents by
rank, a contiguous rank-group's extents always coalesce into exactly one run
per dataset — the best case the paper engineered for.

The hot path is **zero-copy**: requests carry array *views* (stride-aware
slices of the caller's buffer) and ``pwritev`` vectors straight out of them;
``COPY_COUNTER`` accounts for every payload byte that is ever duplicated so
benchmarks can assert copies-per-byte == 0 on the coalesced path.

Everything is lock-free: extents are disjoint by construction
(``hyperslab.validate_plan``), so concurrent aggregator threads never
overlap — the paper's "safe to disable the file locking".

Since format v2 the aggregators also run the **filter pipeline** for chunked
datasets (:class:`ChunkPipeline`): chunk encoding happens *in the aggregator
pool, overlapped with the file writes* — compression of chunk k+1 proceeds
while chunk k drains to disk (the Jin et al. deeply-integrated-compression
pipeline), and the file-domain bucketing below is size-aware, so
variable-length post-filter chunks balance across aggregators exactly like
fixed-size slabs.  See ``docs/ARCHITECTURE.md`` for the full stage map.

Copied from ``src/repro/core/aggregation.py``; only the import lines differ.
"""

from __future__ import annotations

import os
import threading
import time
import zlib
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Sequence

from ..obs.metrics import (
    Counter as _Counter,
    M_COPY_BYTES as _M_COPY_BYTES,
    M_COPY_COUNT as _M_COPY_COUNT,
    M_DECODE_CHUNKS,
    M_DECODE_FETCH_SECONDS,
    M_DECODE_INFLATE_SECONDS,
    M_DECODE_RAW_BYTES,
    M_ENCODE_CHUNKS,
    M_ENCODE_RAW_BYTES,
    M_ENCODE_SECONDS,
    M_WRITE_SECONDS,
    REGISTRY as _REG,
)
from ..obs.trace import (
    SPAN_DECODE_FETCH,
    SPAN_DECODE_GATHER,
    SPAN_DECODE_INFLATE,
    SPAN_ENCODE_CHUNK,
    TRACER,
)

import numpy as np

from .codecs import CODEC_NONE, codec_by_id, encode_chunk, encode_chunk_with_stats, get_codec
from .query import compute_chunk_stats
from .container import (
    IOV_MAX,
    READ_COUNTER,
    CorruptFileError,
    DatasetMeta,
    TH5Error,
    TH5File,
    _advance,
    _byte_view,
    preadv_full,
    pwrite_full,
)


class CopyCounter:
    """Payload-copy accounting (thread-safe).

    Every time a request payload is materialised as a new bytes object (or a
    non-contiguous run is compacted) the copy is recorded here.  The
    benchmarks snapshot around a write to compute copies-per-byte; the
    zero-copy coalesced path must report a delta of exactly zero.

    ``registered=True`` (the process-wide :data:`COPY_COUNTER` only) backs
    the two tallies with the unified metrics registry
    (:data:`~repro.obs.metrics.M_COPY_COUNT` /
    :data:`~repro.obs.metrics.M_COPY_BYTES`), so ``REGISTRY.collect()``
    sees them; the *local* instances the write paths create for per-call
    deltas stay anonymous — their adds and resets never touch the global
    metrics (and a local reset can't clobber the process totals).
    """

    def __init__(self, registered: bool = False) -> None:
        self._lock = threading.Lock()
        if registered:
            self._copies = _REG.counter(_M_COPY_COUNT)
            self._bytes = _REG.counter(_M_COPY_BYTES)
        else:
            self._copies = _Counter()
            self._bytes = _Counter()

    @property
    def n_copies(self) -> int:
        return int(self._copies.value)

    @property
    def bytes_copied(self) -> int:
        return int(self._bytes.value)

    def add(self, nbytes: int) -> None:
        with self._lock:
            self._copies.inc()
            self._bytes.inc(int(nbytes))

    def reset(self) -> None:
        with self._lock:
            self._copies._reset()
            self._bytes._reset()

    def snapshot(self) -> tuple[int, int]:
        with self._lock:
            return int(self._copies.value), int(self._bytes.value)


COPY_COUNTER = CopyCounter(registered=True)

_IOV_MAX = IOV_MAX  # re-exported; monkeypatched by the short-write tests


@dataclass(frozen=True)
class WriteRequest:
    """One rank's contribution: absolute file offset + payload.

    ``data`` may be bytes, an ndarray *view* into the caller's buffer, or a
    memoryview — the vectored writer never copies any of them as long as the
    underlying memory is contiguous.
    """

    offset: int
    data: bytes | np.ndarray | memoryview

    def payload(self) -> bytes:
        """Materialise the payload as bytes.  This is always a copy for
        array/memoryview payloads — kept for tests/analysis; the write path
        uses :func:`_as_view` instead."""
        d = self.data
        if isinstance(d, np.ndarray):
            COPY_COUNTER.add(d.nbytes)
            return d.tobytes()
        if isinstance(d, memoryview):
            COPY_COUNTER.add(d.nbytes)
            return bytes(d)
        return bytes(d)

    @property
    def nbytes(self) -> int:
        d = self.data
        return d.nbytes if isinstance(d, (np.ndarray, memoryview)) else len(d)


@dataclass
class WriteStats:
    n_requests: int = 0
    n_syscalls: int = 0
    bytes_written: int = 0
    wall_s: float = 0.0
    n_aggregators: int = 0
    coalesced_runs: int = 0
    n_copies: int = 0
    bytes_copied: int = 0

    @property
    def bandwidth_bps(self) -> float:
        return self.bytes_written / self.wall_s if self.wall_s > 0 else float("inf")

    @property
    def copies_per_byte(self) -> float:
        return self.bytes_copied / self.bytes_written if self.bytes_written else 0.0

    @property
    def syscalls_per_mb(self) -> float:
        return self.n_syscalls / (self.bytes_written / 1e6) if self.bytes_written else 0.0


@dataclass(frozen=True)
class AggregationConfig:
    """``n_aggregators``: how many writer threads touch the file (the paper's
    aggregator count — 16/1024 nodes on JuQueen).  ``coalesce``: merge
    adjacent extents into single pwrites.  ``buffer_bytes``: aggregator
    staging-buffer cap; runs larger than this are split (MPI-IO's cb_buffer_size)."""

    n_aggregators: int = 4
    coalesce: bool = True
    buffer_bytes: int = 16 << 20
    file_domains: bool = True

    def __post_init__(self) -> None:
        if self.n_aggregators < 1:
            raise ValueError("need >= 1 aggregator")
        if self.buffer_bytes < 1:
            raise ValueError("buffer_bytes must be positive")


def assign_aggregators(n_ranks: int, n_aggregators: int) -> np.ndarray:
    """Contiguous rank→aggregator map (rank r → r // group).  Contiguity is
    what makes coalescing maximal, matching the paper's 'natural choice' of
    the nodes wired to the I/O drawers."""
    n_aggregators = min(n_aggregators, max(n_ranks, 1))
    group = -(-n_ranks // n_aggregators)  # ceil
    return np.arange(n_ranks) // group


def assign_file_domains(
    reqs: Sequence[WriteRequest], n_aggregators: int
) -> list[list[WriteRequest]]:
    """MPI-IO-style file domains: each aggregator owns one contiguous byte
    band of the file, so runs coalesce maximally regardless of which rank a
    request came from.  Rank bucketing (``assign_aggregators``) fragments
    inner-dim (TP-style) shardings — every rank's per-row slivers stay
    separated by the other ranks' columns; domain bucketing stitches them
    back into whole-row runs.  Requests are sorted by offset and split at
    request boundaries into ≤ ``n_aggregators`` balanced-byte domains.
    Balancing is by *bytes*, not request count, so the variable-length
    post-filter chunks a :class:`ChunkPipeline` produces (a 10:1-compressed
    chunk next to an incompressible raw one) spread as evenly as fixed-size
    slabs."""
    ordered = sorted(reqs, key=lambda r: r.offset)
    total = sum(r.nbytes for r in ordered)
    if not ordered or total == 0:
        return [list(ordered)] if ordered else []
    per_domain = -(-total // n_aggregators)  # ceil
    domains: list[list[WriteRequest]] = []
    cur: list[WriteRequest] = []
    cur_bytes = 0
    for r in ordered:
        if cur and cur_bytes + r.nbytes > per_domain and len(domains) < n_aggregators - 1:
            domains.append(cur)
            cur, cur_bytes = [], 0
        cur.append(r)
        cur_bytes += r.nbytes
    if cur:
        domains.append(cur)
    return domains


def coalesce_runs(
    reqs: Sequence[WriteRequest], buffer_bytes: int
) -> list[tuple[int, list[WriteRequest]]]:
    """Group byte-adjacent requests into maximal runs capped at buffer_bytes.
    Returns (run_offset, [requests]) — payloads are NOT copied; the writer
    issues one vectored ``pwritev`` per run (the zero-copy analogue of
    MPI-IO's cb buffer fill)."""
    if not reqs:
        return []
    ordered = sorted(reqs, key=lambda r: r.offset)
    runs: list[tuple[int, list[WriteRequest]]] = []
    cur_off = ordered[0].offset
    cur: list[WriteRequest] = [ordered[0]]
    cur_len = ordered[0].nbytes
    for r in ordered[1:]:
        contiguous = r.offset == cur_off + cur_len
        if contiguous and cur_len + r.nbytes <= buffer_bytes:
            cur.append(r)
            cur_len += r.nbytes
        else:
            runs.append((cur_off, cur))
            cur_off, cur, cur_len = r.offset, [r], r.nbytes
    runs.append((cur_off, cur))
    return runs


def coalesce_requests(reqs: Sequence[WriteRequest], buffer_bytes: int) -> list[WriteRequest]:
    """Copying variant of :func:`coalesce_runs` (kept for tests/analysis)."""
    return [
        WriteRequest(off, b"".join(r.payload() for r in rs))
        for off, rs in coalesce_runs(reqs, buffer_bytes)
    ]


def _as_view(r: WriteRequest, counter: CopyCounter | None = None) -> memoryview:
    d = r.data
    if isinstance(d, np.ndarray):
        if d.size == 0:
            return memoryview(b"")  # cast('B') rejects zeros in shape
        if not d.flags.c_contiguous:
            COPY_COUNTER.add(d.nbytes)  # compaction copy — only stride-broken runs
            if counter is not None:
                counter.add(d.nbytes)
            d = np.ascontiguousarray(d)
        try:
            return memoryview(d).cast("B")
        except (ValueError, TypeError):
            # ml_dtypes (bfloat16 etc.) lack buffer-protocol support:
            # reinterpret as bytes — no copy, same layout
            return memoryview(d.view(np.uint8)).cast("B")
    mv = memoryview(d)
    return mv if mv.format == "B" and mv.ndim == 1 else mv.cast("B")


def pwritev_run(
    fd: int, offset: int, reqs: list[WriteRequest], counter: CopyCounter | None = None
) -> tuple[int, int]:
    """Write one coalesced run with vectored I/O (no payload copies).
    Returns (bytes_written, syscalls)."""
    bufs = [_as_view(r, counter) for r in reqs]
    total, calls = 0, 0
    for i in range(0, len(bufs), _IOV_MAX):
        chunk = bufs[i : i + _IOV_MAX]
        want = sum(len(b) for b in chunk)
        wrote = 0
        while wrote < want:  # pwritev may be short
            n = os.pwritev(fd, _advance(chunk, wrote), offset + total + wrote)
            calls += 1
            if n <= 0:
                raise OSError("pwritev returned %d" % n)
            wrote += n
        total += want
    return total, calls


class CollectiveWriter:
    """Executes a set of per-rank write requests with collective buffering.

    The aggregator worker pool is **persistent**: created once on first use
    and reused across steps (the paper's fixed aggregator set), so the
    steady-state write path pays no thread spawn/teardown.  Use as a context
    manager or call :meth:`close` to release the threads; an unclosed writer
    releases them on garbage collection.

    ``independent`` mode (aggregation off) issues one pwrite per request from
    a pool as wide as the rank count — the paper's contended baseline.
    """

    def __init__(self, fd: int, config: AggregationConfig | None = None):
        self.fd = fd
        self.config = config or AggregationConfig()
        self._pool: ThreadPoolExecutor | None = None
        self._pool_width = 0
        self._submit_pool: ThreadPoolExecutor | None = None

    # -- persistent worker pool ------------------------------------------------

    def _get_pool(self, width: int) -> ThreadPoolExecutor:
        if self._pool is None or self._pool_width < width:
            if self._pool is not None:
                self._pool.shutdown(wait=True)
            self._pool = ThreadPoolExecutor(max_workers=width, thread_name_prefix="aggregator")
            self._pool_width = width
        return self._pool

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
            self._pool_width = 0
        if self._submit_pool is not None:
            self._submit_pool.shutdown(wait=True)
            self._submit_pool = None

    def __enter__(self) -> "CollectiveWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self) -> None:  # best-effort thread release
        try:
            if self._pool is not None:
                self._pool.shutdown(wait=False)
            if self._submit_pool is not None:
                self._submit_pool.shutdown(wait=False)
        except Exception:
            pass

    # -- write paths -----------------------------------------------------------

    def write_collective(self, requests_per_rank: Sequence[Sequence[WriteRequest]]) -> WriteStats:
        cfg = self.config
        n_ranks = len(requests_per_rank)
        stats = WriteStats(
            n_requests=sum(len(r) for r in requests_per_rank),
            n_aggregators=min(cfg.n_aggregators, max(n_ranks, 1)),
        )
        if cfg.file_domains:
            flat = [r for reqs in requests_per_rank for r in reqs]
            buckets = assign_file_domains(flat, min(cfg.n_aggregators, max(n_ranks, 1)))
        else:
            amap = assign_aggregators(n_ranks, cfg.n_aggregators)
            by_agg: dict[int, list[WriteRequest]] = {}
            for rank, reqs in enumerate(requests_per_rank):
                by_agg.setdefault(int(amap[rank]), []).extend(reqs)
            buckets = list(by_agg.values())
        stats.n_aggregators = len(buckets)

        lock = threading.Lock()
        # per-call counter: attribute only THIS write's compaction copies to
        # its stats (a concurrent caller may be planning step n+1 against the
        # global COPY_COUNTER while this write drains — see submit_collective)
        local_copies = CopyCounter()

        def run_aggregator(reqs: list[WriteRequest]) -> None:
            wrote, calls, n_runs = 0, 0, 0
            if cfg.coalesce:
                for off, run in coalesce_runs(reqs, cfg.buffer_bytes):
                    b, c = pwritev_run(self.fd, off, run, local_copies)
                    wrote += b
                    calls += c
                    n_runs += 1
            else:
                for r in reqs:
                    wrote += pwrite_full(self.fd, _as_view(r, local_copies), r.offset)
                    calls += 1
                    n_runs += 1
            with lock:
                stats.n_syscalls += calls
                stats.bytes_written += wrote
                stats.coalesced_runs += n_runs

        t0 = time.perf_counter()
        if len(buckets) == 1:
            run_aggregator(buckets[0])
        elif buckets:
            pool = self._get_pool(len(buckets))
            futs = [pool.submit(run_aggregator, reqs) for reqs in buckets]
            for f in futs:
                f.result()
        stats.wall_s = time.perf_counter() - t0
        stats.n_copies, stats.bytes_copied = local_copies.snapshot()
        return stats

    def submit_collective(
        self, requests_per_rank: Sequence[Sequence[WriteRequest]]
    ) -> "Future[WriteStats]":
        """Asynchronous :meth:`write_collective` — the double-buffer half of
        the paper's §5.2 'asynchronous I/O'.  The caller packs/stages step
        n+1 while the returned future drains step n to disk.  The caller must
        keep the request payloads alive (and unmodified) until the future
        resolves; a dedicated submission thread avoids deadlocking the
        aggregator pool."""
        if self._submit_pool is None:
            self._submit_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="aggregator-submit"
            )
        return self._submit_pool.submit(self.write_collective, requests_per_rank)

    def write_independent(self, requests_per_rank: Sequence[Sequence[WriteRequest]]) -> WriteStats:
        """No aggregation: every rank writes its own (possibly tiny) extents.
        This is the baseline the paper's Fig. 8 improves on."""
        n_ranks = len(requests_per_rank)
        stats = WriteStats(n_requests=sum(len(r) for r in requests_per_rank), n_aggregators=n_ranks)
        lock = threading.Lock()
        local_copies = CopyCounter()

        def run_rank(reqs: Sequence[WriteRequest]) -> None:
            wrote, calls = 0, 0
            for r in reqs:
                wrote += pwrite_full(self.fd, _as_view(r, local_copies), r.offset)
                calls += 1
            with lock:
                stats.n_syscalls += calls
                stats.bytes_written += wrote

        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=max(1, min(n_ranks, 64))) as pool:
            futs = [pool.submit(run_rank, reqs) for reqs in requests_per_rank if reqs]
            for f in futs:
                f.result()
        stats.wall_s = time.perf_counter() - t0
        stats.n_copies, stats.bytes_copied = local_copies.snapshot()
        return stats


def _run_payload(sub: np.ndarray) -> np.ndarray | bytes:
    """Zero-copy when the run is contiguous in the caller's buffer; only a
    stride-broken run (layout mismatch) is compacted, and that copy is
    accounted."""
    if sub.flags.c_contiguous:
        return sub
    COPY_COUNTER.add(sub.nbytes)
    return sub.tobytes()


def nd_slab_requests(
    base_offset: int,
    global_shape: Sequence[int],
    itemsize: int,
    index: Sequence[slice],
    array: np.ndarray,
) -> list[WriteRequest]:
    """Decompose an N-D hyperslab (a shard's hyperrectangle in a row-major
    dataset) into contiguous byte runs — what HDF5 does under the hood for a
    hyperslab write.  A dim-0-contiguous shard yields exactly one request;
    TP-style inner-dim shards yield one request per outer row, which is where
    aggregation coalesces across ranks.

    Requests carry stride-aware *views* of ``array`` — no payload bytes are
    copied as long as each run is contiguous in the source buffer (true for
    any C-contiguous shard, and for inner-dim slices of a larger array whose
    rows are individually contiguous)."""
    global_shape = tuple(int(s) for s in global_shape)
    arr = np.asarray(array)
    starts = [s.start or 0 for s in index]
    stops = [s.stop if s.stop is not None else dim for s, dim in zip(index, global_shape)]
    shard_shape = tuple(b - a for a, b in zip(starts, stops))
    if shard_shape != arr.shape:
        raise ValueError(f"index shape {shard_shape} != array shape {arr.shape}")
    # find the innermost suffix of dims that the shard spans fully → run length
    ndim = len(global_shape)
    suffix = ndim
    while suffix > 0 and shard_shape[suffix - 1] == global_shape[suffix - 1]:
        suffix -= 1
    # dims [suffix:] are fully spanned; dim suffix-1 (if any) is partial but
    # contiguous within a run
    strides = np.ones(ndim, dtype=np.int64)
    for d in range(ndim - 2, -1, -1):
        strides[d] = strides[d + 1] * global_shape[d + 1]
    if suffix == 0:
        return [WriteRequest(base_offset, _run_payload(arr))]
    outer_dims = shard_shape[: suffix - 1]
    base = base_offset + int(sum(starts[d] * int(strides[d]) for d in range(ndim))) * itemsize
    if not outer_dims:
        return [WriteRequest(base, _run_payload(arr))]
    # vectorised affine offsets: off(idx) = base + Σ idx[d]·strides[d]·itemsize
    offs = np.zeros(outer_dims, dtype=np.int64)
    for d in range(len(outer_dims)):
        shape = [1] * len(outer_dims)
        shape[d] = outer_dims[d]
        offs += (np.arange(outer_dims[d], dtype=np.int64) * int(strides[d])).reshape(shape)
    off_list = (offs.reshape(-1) * itemsize + base).tolist()
    run_elems = int(np.prod(shard_shape[suffix - 1 :], dtype=np.int64))
    run_bytes = run_elems * itemsize
    if arr.flags.c_contiguous:
        # one byte view over the whole shard; every run is a zero-copy slice
        try:
            mv = memoryview(arr).cast("B")
        except (ValueError, TypeError):
            mv = memoryview(arr.view(np.uint8)).cast("B")
        return [
            WriteRequest(off, mv[i * run_bytes : (i + 1) * run_bytes])
            for i, off in enumerate(off_list)
        ]
    return [
        WriteRequest(off, _run_payload(arr[idx]))
        for off, idx in zip(off_list, np.ndindex(*outer_dims))
    ]


# -- the overlapped filter (codec) pipeline ------------------------------------


@dataclass
class FilterStats:
    """Accounting for one chunked-dataset pass through the filter pipeline,
    in either direction.

    Writes (:class:`ChunkPipeline`): ``encode_s`` is summed across codec
    workers and ``write_s`` across drain pwrites.  Reads
    (:class:`DecodePipeline`): ``encode_s`` holds the summed inflate/decode
    worker time and ``write_s`` the summed preadv fetch time (the
    :attr:`decode_s` / :attr:`fetch_s` aliases).  Either way
    ``overlap_ratio = (encode_s + write_s) / wall_s`` exceeds 1.0 exactly
    when codec work genuinely overlapped the disk I/O (the Jin-style
    pipeline working as intended).
    """

    n_chunks: int = 0
    raw_bytes: int = 0
    stored_bytes: int = 0
    encode_s: float = 0.0  # summed codec-worker time (parallel wall)
    write_s: float = 0.0  # summed drain-side write time
    wall_s: float = 0.0
    n_syscalls: int = 0

    @property
    def ratio(self) -> float:
        """Compression ratio raw:stored (1.0 = incompressible / none)."""
        return self.raw_bytes / self.stored_bytes if self.stored_bytes else 1.0

    @property
    def effective_bandwidth_bps(self) -> float:
        """Raw (pre-filter) bytes per second of wall time — the number an
        application sees: logical bytes checkpointed per second."""
        return self.raw_bytes / self.wall_s if self.wall_s > 0 else float("inf")

    @property
    def overlap_ratio(self) -> float:
        return (self.encode_s + self.write_s) / self.wall_s if self.wall_s > 0 else 0.0

    # read-side aliases (DecodePipeline fills the same slots)
    @property
    def decode_s(self) -> float:
        return self.encode_s

    @property
    def fetch_s(self) -> float:
        return self.write_s

    def merge(self, other: "FilterStats") -> "FilterStats":
        self.n_chunks += other.n_chunks
        self.raw_bytes += other.raw_bytes
        self.stored_bytes += other.stored_bytes
        self.encode_s += other.encode_s
        self.write_s += other.write_s
        self.wall_s += other.wall_s
        self.n_syscalls += other.n_syscalls
        return self


def _publish_encode_stats(stats: FilterStats) -> None:
    """Mirror one write pass into the unified registry (encode.* names).
    The FilterStats object stays the per-call truth; the registry view is
    cumulative across the process."""
    if not stats.n_chunks:
        return
    _REG.counter(M_ENCODE_CHUNKS).inc(stats.n_chunks)
    _REG.counter(M_ENCODE_RAW_BYTES).inc(stats.raw_bytes)
    _REG.counter(M_ENCODE_SECONDS).inc(stats.encode_s)
    _REG.counter(M_WRITE_SECONDS).inc(stats.write_s)


class ChunkPipeline:
    """Overlapped chunk filter pipeline (Jin et al.: compression deeply
    integrated with the parallel write, not bolted on).

    The persistent codec pool (the aggregators wearing their filter hat)
    encodes chunks ahead while the drain loop appends each finished chunk's
    variable-length payload to the file — compression of chunk k+1 runs
    while chunk k drains to disk.  zlib/CRC/numpy all release the GIL, so
    the overlap is real thread parallelism.

    The ``none`` codec takes a separate zero-copy route: chunk extents are
    allocated up front (sizes are known), the per-chunk ``WriteRequest``
    views are bucketed into size-aware file domains, and the pool issues
    vectored ``pwritev`` per domain — ``COPY_COUNTER`` stays at zero, the
    PR-1 invariant.
    """

    def __init__(self, f: TH5File, config: AggregationConfig | None = None):
        self.file = f
        self.config = config or AggregationConfig()
        self._pool: ThreadPoolExecutor | None = None

    def _get_pool(self) -> ThreadPoolExecutor:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=max(2, self.config.n_aggregators),
                thread_name_prefix="chunk-codec",
            )
        return self._pool

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def __enter__(self) -> "ChunkPipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self) -> None:  # best-effort thread release
        try:
            if self._pool is not None:
                self._pool.shutdown(wait=False)
        except Exception:
            pass

    def write(self, name_or_meta: str | DatasetMeta, array: np.ndarray) -> FilterStats:
        f = self.file
        meta = name_or_meta if isinstance(name_or_meta, DatasetMeta) else f.meta(name_or_meta)
        if meta.chunks is None:
            raise TH5Error("ChunkPipeline.write needs a chunked dataset")
        arr = np.asarray(array)
        if tuple(arr.shape) != tuple(meta.shape):
            raise TH5Error(f"shape mismatch: {arr.shape} != {meta.shape}")
        if arr.dtype != meta.np_dtype:
            arr = arr.astype(meta.np_dtype)
        if not arr.flags.c_contiguous:
            COPY_COUNTER.add(arr.nbytes)  # compaction copy, accounted like _as_view
            arr = np.ascontiguousarray(arr)
        codec = get_codec(meta.codec)
        stats = FilterStats()
        t_start = time.perf_counter()
        first = len(meta.chunks)  # resume-safe: skip already-written chunks
        chunk_ranges = [meta.chunk_row_range(ci) for ci in range(first, meta.n_chunks_expected)]
        if not chunk_ranges:
            stats.wall_s = time.perf_counter() - t_start
            return stats
        if codec.codec_id == CODEC_NONE:
            self._write_none(meta, arr, chunk_ranges, stats)
        else:
            pool = self._get_pool()
            # explicit trace handoff: capture the submitting thread's
            # context HERE — pool workers have no ambient context of their
            # own, so each encode closure records against this parent
            tctx = TRACER.current_context()

            def enc(lo: int, hi: int):
                # stats ride the pool worker too: summarising (and, for a
                # lossy codec, the decode-roundtrip the summary needs)
                # overlaps the drain exactly like the encode itself
                t0 = time.perf_counter()
                out = encode_chunk_with_stats(codec, arr[lo:hi])
                t1 = time.perf_counter()
                if tctx is not None:
                    TRACER.record(
                        SPAN_ENCODE_CHUNK, tctx, t0, t1, {"rows": hi - lo}
                    )
                return out, t1 - t0

            # bounded in-flight window: keep the codec workers busy without
            # staging the whole encoded dataset ahead of a disk-bound drain —
            # peak held payloads stay O(window × chunk size)
            window = 2 * max(2, self.config.n_aggregators)
            pending = deque(
                pool.submit(enc, lo, hi) for lo, hi in chunk_ranges[:window]
            )
            next_up = window
            while pending:  # in-order drain; later encodes overlap these writes
                fut = pending.popleft()
                if next_up < len(chunk_ranges):  # refill before blocking
                    pending.append(pool.submit(enc, *chunk_ranges[next_up]))
                    next_up += 1
                (payload, raw_n, raw_crc, stored_crc, cid, cstats), dt = fut.result()
                stats.encode_s += dt
                t0 = time.perf_counter()
                f.append_chunk(
                    meta,
                    payload,
                    raw_nbytes=raw_n,
                    raw_crc32=raw_crc,
                    stored_crc32=stored_crc,
                    codec_id=cid,
                    stats=cstats,
                )
                stats.write_s += time.perf_counter() - t0
                stats.n_syscalls += 1
                stats.n_chunks += 1
                stats.raw_bytes += raw_n
                stats.stored_bytes += payload.nbytes if isinstance(payload, memoryview) else len(payload)
        stats.wall_s = time.perf_counter() - t_start
        _publish_encode_stats(stats)
        return stats

    def _write_none(self, meta, arr, chunk_ranges, stats: FilterStats) -> None:
        """Zero-copy raw-chunk route: allocate every extent up front, bucket
        the view-carrying requests into file domains, drain with vectored
        writes from the pool."""
        f = self.file
        rb = meta.row_bytes
        reqs: list[WriteRequest] = []
        recs = []
        t0 = time.perf_counter()
        for lo, hi in chunk_ranges:
            chunk = arr[lo:hi]
            view = _byte_view(chunk)
            crc = zlib.crc32(view) & 0xFFFFFFFF
            rec = f.alloc_chunk(
                meta,
                (hi - lo) * rb,
                raw_nbytes=(hi - lo) * rb,
                raw_crc32=crc,
                stored_crc32=crc,
                codec_id=CODEC_NONE,
                stats=compute_chunk_stats(chunk, crc),
            )
            reqs.append(WriteRequest(rec.offset, chunk))
            recs.append(rec)
            stats.n_chunks += 1
            stats.raw_bytes += rec.raw_nbytes
            stats.stored_bytes += rec.nbytes
        stats.encode_s += time.perf_counter() - t0  # CRC framing pass
        cfg = self.config
        domains = assign_file_domains(reqs, cfg.n_aggregators) if cfg.file_domains else [reqs]
        lock = threading.Lock()

        def drain(domain: list[WriteRequest]) -> None:
            t1 = time.perf_counter()
            wrote = calls = 0
            for off, run in coalesce_runs(domain, cfg.buffer_bytes):
                b, c = pwritev_run(f.fd, off, run)
                wrote += b
                calls += c
            dt = time.perf_counter() - t1
            with lock:
                stats.n_syscalls += calls
                stats.write_s += dt

        if len(domains) <= 1:
            for d in domains:
                drain(d)
        else:
            pool = self._get_pool()
            for fut in [pool.submit(drain, d) for d in domains]:
                fut.result()
        # publish only after every domain's vectored drain completed — the
        # commit-mark must never outrun payload bytes (recovery invariant)
        for rec in recs:
            f.publish_chunk(meta, rec)


# -- the overlapped decode (read-side filter) pipeline --------------------------


class DecodePipeline:
    """Read-side mirror of :class:`ChunkPipeline` (the paper's "fast (random)
    access when retrieving the data for visual processing", made real).

    Cold multi-chunk reads used to decode intersecting chunks serially:
    pread chunk k, inflate chunk k, pread chunk k+1, ...  This pipeline
    preadv-fetches chunk k+1's stored bytes on the calling thread *while*
    chunk k inflates in a persistent worker pool, with a bounded in-flight
    window (same shape as the write pipeline, arrows reversed).  zlib /
    CRC / numpy release the GIL, so the overlap is real thread parallelism.

    Chunks appended by one write pipeline are **contiguous on disk**
    (``alloc_extent`` is append-only), so the fetch half additionally
    batches disk-adjacent chunk records into ONE vectored ``preadv`` per
    HALF in-flight window (``batch_fetch``, default on): a cold
    full-window read costs ~two read syscalls per window instead of one
    per chunk, while two batches stay in flight so fetch still overlaps
    decode; batches are also capped at ``config.buffer_bytes``.  On an EOF
    mid-batch the fetch falls back to per-chunk reads so the error still
    names the offending chunk.

    Fast paths are preserved exactly:

      * chunk-cache hits never touch the pool (and ``verify=True`` still
        bypasses cache *hits* — a verified read must never launder a decode
        populated by an unverified one);
      * ``none``-codec chunks on a native-dtype, unverified gather keep the
        PR-2 zero-copy route — a vectored ``preadv`` straight into the
        caller's destination rows, ``COPY_COUNTER`` delta 0;
      * a single decode-needed chunk is inflated inline (no pool hop).

    Every gather publishes a read-side :class:`FilterStats`
    (``decode_s`` / ``fetch_s`` / ``overlap_ratio``) to
    ``TH5File.last_read_stats`` and merges it into the cumulative
    ``TH5File.read_stats``.  Thread-safe: concurrent gathers share the pool
    and the (thread-safe) chunk cache; each call's destination rows are
    disjoint slices owned by that call.
    """

    def __init__(
        self, f: TH5File, config: AggregationConfig | None = None, *, batch_fetch: bool = True
    ):
        self.file = f
        self.config = config or AggregationConfig()
        self.batch_fetch = bool(batch_fetch)
        self._pool: ThreadPoolExecutor | None = None
        self._pool_lock = threading.Lock()

    def _get_pool(self) -> ThreadPoolExecutor:
        with self._pool_lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=max(2, self.config.n_aggregators),
                    thread_name_prefix="chunk-decode",
                )
            return self._pool

    def close(self) -> None:
        with self._pool_lock:
            if self._pool is not None:
                self._pool.shutdown(wait=True)
                self._pool = None

    def __enter__(self) -> "DecodePipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self) -> None:  # best-effort thread release
        try:
            if self._pool is not None:
                self._pool.shutdown(wait=False)
        except Exception:
            pass

    # -- building blocks -------------------------------------------------------

    def _record(self, name: str, meta: DatasetMeta, ci: int):
        if meta.chunks is None or ci >= len(meta.chunks):
            raise CorruptFileError(f"chunk {ci} of {name} missing (incomplete write)")
        return meta.chunks[ci]

    def _fetch(self, name: str, ci: int, rec) -> tuple[np.ndarray, int]:
        """Read chunk ``ci``'s stored payload (caller thread — the I/O half
        of the pipeline).  ``preadv_full`` resumes short reads; EOF inside
        the extent (truncated file) names the offending chunk.  Returns
        ``(payload, syscalls)``."""
        buf = np.empty(rec.nbytes, dtype=np.uint8)
        calls = 0
        if rec.nbytes:
            try:
                n, calls = preadv_full(self.file.fd, [_byte_view(buf)], rec.offset)
            except CorruptFileError as e:
                raise CorruptFileError(f"short read on chunk {ci} of {name}: {e}") from None
            READ_COUNTER.add(n, calls)
        return buf, calls

    def _fetch_batch(
        self, name: str, batch: list[tuple[int, Any]]
    ) -> tuple[list[np.ndarray], int]:
        """Read the stored payloads of ``batch`` (disk-adjacent chunk
        records, ascending) with ONE vectored ``preadv`` scattering into one
        destination buffer per chunk.  Falls back to per-chunk fetches on an
        EOF mid-range so the resulting error names the offending chunk, not
        the batch.  Returns ``(payloads, syscalls)``."""
        if len(batch) == 1:
            ci, rec = batch[0]
            blob, calls = self._fetch(name, ci, rec)
            return [blob], calls
        bufs = [np.empty(rec.nbytes, dtype=np.uint8) for _, rec in batch]
        views = [_byte_view(b) for b in bufs if b.nbytes]
        try:
            n, calls = preadv_full(self.file.fd, views, batch[0][1].offset)
        except CorruptFileError:
            calls = 0
            for i, (ci, rec) in enumerate(batch):
                bufs[i], c = self._fetch(name, ci, rec)  # raises naming ci
                calls += c
            return bufs, calls
        READ_COUNTER.add(n, calls)
        return bufs, calls

    def _inflate(
        self, name: str, meta: DatasetMeta, ci: int, rec, blob: np.ndarray, verify: bool
    ) -> np.ndarray:
        """Decode one fetched payload (pool worker — the CPU half).  CRC
        failures name the chunk; the decoded rows are cached."""
        if verify and (zlib.crc32(blob) & 0xFFFFFFFF) != rec.stored_crc32:
            raise CorruptFileError(f"stored CRC mismatch on chunk {ci} of {name}")
        codec = codec_by_id(rec.codec_id)
        dt = meta.np_dtype
        flat = codec.decode(blob, dt, rec.raw_nbytes // dt.itemsize)
        if verify and codec.lossless:
            if (zlib.crc32(_byte_view(np.ascontiguousarray(flat))) & 0xFFFFFFFF) != rec.raw_crc32:
                raise CorruptFileError(f"payload CRC mismatch on chunk {ci} of {name}")
        lo, hi = meta.chunk_row_range(ci)
        out = flat.reshape((hi - lo,) + tuple(meta.shape[1:]))
        self.file.chunk_cache.put((name, ci), out)
        return out

    def _publish(self, stats: FilterStats) -> None:
        f = self.file
        with f._read_stats_lock:
            f.last_read_stats = stats
            if f.read_stats is None:
                f.read_stats = FilterStats()
            f.read_stats.merge(stats)
        # the same pass, in the unified registry (decode.* names): the
        # per-file FilterStats stays the local truth, the registry holds
        # the process-cumulative view
        if stats.n_chunks:
            _REG.counter(M_DECODE_CHUNKS).inc(stats.n_chunks)
            _REG.counter(M_DECODE_RAW_BYTES).inc(stats.raw_bytes)
            _REG.counter(M_DECODE_FETCH_SECONDS).inc(stats.write_s)
            _REG.counter(M_DECODE_INFLATE_SECONDS).inc(stats.encode_s)

    def _run(
        self,
        name: str,
        meta: DatasetMeta,
        jobs: list[tuple[int, Any]],
        verify: bool,
        stats: FilterStats,
        consume,
    ) -> None:
        """Drive fetch→inflate over ``jobs`` (list of (ci, rec)), calling
        ``consume(ci, decoded_rows)`` in chunk order.  Two or more jobs run
        overlapped: the next fetch proceeds on this thread while earlier
        chunks inflate in the pool.  With ``batch_fetch`` (default), runs of
        disk-adjacent records are fetched by ONE vectored ``preadv`` each —
        up to half an in-flight window per syscall (half, so the next
        batch's fetch overlaps the previous batch's inflates)."""

        def account(rec, calls):
            stats.n_chunks += 1
            stats.raw_bytes += rec.raw_nbytes
            stats.stored_bytes += rec.nbytes
            stats.n_syscalls += calls

        # explicit trace handoff: the gather's ambient context, captured on
        # the submitting thread — inflate closures record against it from
        # the pool (retroactively, off timestamps they take anyway)
        tctx = TRACER.current_context()

        if len(jobs) == 1:
            ci, rec = jobs[0]
            t0 = time.perf_counter()
            blob, calls = self._fetch(name, ci, rec)
            t1 = time.perf_counter()
            dec = self._inflate(name, meta, ci, rec, blob, verify)
            t2 = time.perf_counter()
            stats.write_s += t1 - t0
            stats.encode_s += t2 - t1
            if tctx is not None:
                TRACER.record(SPAN_DECODE_FETCH, tctx, t0, t1, {"chunks": 1})
                TRACER.record(SPAN_DECODE_INFLATE, tctx, t1, t2, {"chunk": ci})
            account(rec, calls)
            consume(ci, dec)
            return

        pool = self._get_pool()
        window = 2 * max(2, self.config.n_aggregators)  # bounded in-flight payloads

        # group jobs into fetch batches: consecutive records that are
        # byte-adjacent on disk (the append-only allocator guarantees this
        # for chunks written by one pipeline), capped at HALF the in-flight
        # window — a full-window batch would force the drain loop to retire
        # every pending inflate before the next preadv, serialising fetch
        # against decode; half keeps two batches in flight (double
        # buffering) while still cutting syscalls — and at buffer_bytes
        # (cb_buffer_size)
        batch_cap = max(1, window // 2)
        batches: list[list[tuple[int, Any]]] = []
        if self.batch_fetch:
            cur = [jobs[0]]
            cur_bytes = jobs[0][1].nbytes
            for job in jobs[1:]:
                prev = cur[-1][1]
                rec = job[1]
                if (
                    rec.offset == prev.offset + prev.nbytes
                    and len(cur) < batch_cap
                    and cur_bytes + rec.nbytes <= self.config.buffer_bytes
                ):
                    cur.append(job)
                    cur_bytes += rec.nbytes
                else:
                    batches.append(cur)
                    cur, cur_bytes = [job], rec.nbytes
            batches.append(cur)
        else:
            batches = [[j] for j in jobs]

        def inflate_timed(ci, rec, blob):
            # runs on a pool worker: tctx crossed the pool boundary by
            # closure capture, not thread-local inheritance
            t0 = time.perf_counter()
            dec = self._inflate(name, meta, ci, rec, blob, verify)
            t1 = time.perf_counter()
            if tctx is not None:
                TRACER.record(SPAN_DECODE_INFLATE, tctx, t0, t1, {"chunk": ci})
            return dec, t1 - t0

        pending: deque = deque()  # (ci, Future) in chunk order

        def drain_one() -> None:
            ci, fut = pending.popleft()
            dec, dt = fut.result()  # re-raises CorruptFileError naming the chunk
            stats.encode_s += dt
            consume(ci, dec)

        try:
            for batch in batches:
                while pending and len(pending) + len(batch) > window:
                    drain_one()
                t0 = time.perf_counter()
                blobs, calls = self._fetch_batch(name, batch)  # overlaps inflates
                t1 = time.perf_counter()
                stats.write_s += t1 - t0
                if tctx is not None:
                    TRACER.record(SPAN_DECODE_FETCH, tctx, t0, t1, {"chunks": len(batch)})
                for (ci, rec), blob in zip(batch, blobs):
                    pending.append((ci, pool.submit(inflate_timed, ci, rec, blob)))
                    account(rec, 0)
                stats.n_syscalls += calls
            while pending:
                drain_one()
        finally:
            # error path: cancel what hasn't started, then retrieve the rest —
            # an already-running worker's exception (e.g. a second corrupt
            # chunk) must not surface as an unretrieved-future warning at GC
            while pending:
                _, fut = pending.popleft()
                if not fut.cancel():  # already running/done: wait + retrieve
                    try:
                        fut.result()
                    except Exception:
                        pass  # the first failure is already propagating

    # -- public entry points ----------------------------------------------------

    def gather_rows(
        self,
        name: str,
        meta: DatasetMeta,
        row_start: int,
        n_rows: int,
        out: np.ndarray,
        verify: bool = False,
    ) -> int:
        """Fill ``out`` with rows [row_start, row_start+n_rows) of a chunked
        dataset, decoding ONLY the intersecting chunks — cold multi-chunk
        windows overlap preadv with inflate.  Returns bytes gathered."""
        if n_rows == 0:
            return 0
        f = self.file
        rb = meta.row_bytes
        cr = meta.chunk_rows or 1
        dt = meta.np_dtype
        native = TH5File._is_native(dt)
        out2 = out.reshape((n_rows, -1))  # view (out is C-contiguous)
        stats = FilterStats()
        gspan = TRACER.span(SPAN_DECODE_GATHER)  # NOOP unless this request is traced
        t_start = time.perf_counter()
        raw = hits = 0

        def dst_for(ci: int) -> tuple[np.ndarray, int, int, int]:
            clo, chi = meta.chunk_row_range(ci)
            s, e = max(row_start, clo), min(row_start + n_rows, chi)
            return out2[s - row_start : e - row_start], s, e, clo

        jobs: list[tuple[int, Any]] = []
        try:
            with TRACER.use(gspan):
                for ci in range(row_start // cr, (row_start + n_rows - 1) // cr + 1):
                    dst, s, e, clo = dst_for(ci)
                    rec = self._record(name, meta, ci)
                    if rec.codec_id == CODEC_NONE and native and not verify:
                        # raw chunk: vectored read directly into the result rows
                        # (zero intermediate copies — the PR-2 fast path, untouched)
                        n, calls = preadv_full(f.fd, [_byte_view(dst)], rec.offset + (s - clo) * rb)
                        READ_COUNTER.add(n, calls)
                        stats.n_syscalls += calls
                        raw += 1
                        continue
                    if not verify:
                        hit = f.chunk_cache.get((name, ci))
                        if hit is not None:
                            _byte_view(dst)[:] = _byte_view(
                                np.ascontiguousarray(hit[s - clo : e - clo])
                            )
                            hits += 1
                            continue
                    jobs.append((ci, rec))

                if jobs:
                    def consume(ci: int, dec: np.ndarray) -> None:
                        dst, s, e, clo = dst_for(ci)
                        # byte-level copy: dtype-agnostic (out may be a raw byte buffer)
                        _byte_view(dst)[:] = _byte_view(np.ascontiguousarray(dec[s - clo : e - clo]))

                    self._run(name, meta, jobs, verify, stats, consume)
        finally:
            if gspan.trace_id:
                gspan.tag("dataset", name).tag("rows", n_rows).tag("cache_hits", hits)
                gspan.tag("cache_misses", len(jobs)).tag("raw_chunks", raw)
            gspan.end()
        stats.wall_s = time.perf_counter() - t_start
        self._publish(stats)
        return n_rows * rb

    def decode_chunks(
        self, name: str, meta: DatasetMeta, cis: Sequence[int], verify: bool = False
    ) -> dict[int, np.ndarray]:
        """Decode the given chunk indices (deduplicated, in order), fetching
        chunk k+1 while chunk k inflates.  Returns {ci: decoded rows};
        callers must not mutate the arrays (they are cache entries)."""
        f = self.file
        out: dict[int, np.ndarray] = {}
        stats = FilterStats()
        gspan = TRACER.span(SPAN_DECODE_GATHER)
        t_start = time.perf_counter()
        jobs: list[tuple[int, Any]] = []
        hits = 0
        try:
            with TRACER.use(gspan):
                for ci in dict.fromkeys(int(c) for c in cis):
                    if not verify:
                        hit = f.chunk_cache.get((name, ci))
                        if hit is not None:
                            out[ci] = hit
                            hits += 1
                            continue
                    jobs.append((ci, self._record(name, meta, ci)))
                if jobs:
                    self._run(name, meta, jobs, verify, stats, out.__setitem__)
        finally:
            if gspan.trace_id:
                gspan.tag("dataset", name).tag("cache_hits", hits)
                gspan.tag("cache_misses", len(jobs))
            gspan.end()
        stats.wall_s = time.perf_counter() - t_start
        self._publish(stats)
        return out
