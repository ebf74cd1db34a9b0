"""Snapshot layout + checkpoint manager (paper §3.1 'output' / 'checkpointing').

One TH5 file per run — the paper's **shared-file approach** ("each
participating process reads and writes to a single file").  Every snapshot
appends a ``/simulation/step_<n>`` group holding

  * ``state/<leaf-path>`` — one 2-D/N-D dataset per state leaf, written as
    disjoint per-rank hyperslabs planned by reduce+exscan;
  * ``topology/grid_property`` — one packed UID per (leaf × rank-chunk)
    "grid", rank-ordered, root chunk at row 0 (paper's ordering invariant);
  * ``topology/bounding_box`` — global row ranges per chunk, the offline
    metadata that makes restart **not** re-run domain decomposition and lets
    a restore target a *different* rank count (elasticity);

plus a ``/common`` group written once with run-constant attributes.  Commits
are shadow-paged (see ``container``), so every written step remains
addressable → offline sliding window + time-reversible steering.

Copied from ``src/repro/core/checkpoint.py``; only the import lines differ.
"""

from __future__ import annotations

import fnmatch
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Sequence

import numpy as np

from . import tree_ser, uid
from .aggregation import (
    AggregationConfig,
    ChunkPipeline,
    CollectiveWriter,
    FilterStats,
    WriteRequest,
    WriteStats,
)
from .container import CorruptFileError, TH5File
from .hyperslab import plan_rows, validate_plan

STEP_FMT = "step_%08d"
SIM = "/simulation"
COMMON = "/common"


def _step_group(step: int) -> str:
    return f"{SIM}/{STEP_FMT % step}"


def split_rows(n_rows: int, n_ranks: int) -> np.ndarray:
    """Balanced contiguous row split (ranks beyond n_rows contribute 0)."""
    base, rem = divmod(n_rows, n_ranks)
    return np.array([base + (1 if r < rem else 0) for r in range(n_ranks)], dtype=np.int64)


@dataclass(frozen=True)
class CodecPolicy:
    """Per-dataset filter policy for snapshots (paper workload reality: not
    every tensor tolerates loss).

    ``rules`` are ``(fnmatch pattern on the leaf path, codec spec)`` pairs,
    first match wins; unmatched leaves use ``default``.  The canonical split
    is *lossless for optimizer state, lossy for field snapshots*::

        CodecPolicy(default="zlib", rules=(("fields/*", "int8-blockq"),))

    Guard rails: leaves below ``min_chunk_bytes`` (or 0-d) stay on the
    contiguous zero-copy path, and a lossy codec on a non-float leaf falls
    back to ``lossless_fallback`` (quantising step counters corrupts them).
    ``chunk_rows=None`` sizes chunks to ~``target_chunk_bytes`` each.

    Dtype heuristic (``auto_shuffle``, on by default): a ``zlib`` leaf whose
    dtype is f32/f64 upgrades to ``shuffle+zlib`` — the HDF5 byte-shuffle
    pre-filter groups exponent/high-mantissa bytes into runs and lifts the
    deflate ratio well above plain zlib on field data (measured in
    ``benchmarks/io_bandwidth.py``'s ``read`` section).  Integer and
    sub-4-byte leaves keep plain zlib (shuffle buys little there).
    """

    default: str = "none"
    rules: tuple[tuple[str, str], ...] = ()
    chunk_rows: int | None = None
    target_chunk_bytes: int = 1 << 20
    min_chunk_bytes: int = 1 << 16
    lossless_fallback: str = "zlib"
    auto_shuffle: bool = True

    def codec_for(self, leaf_path: str) -> str:
        for pattern, codec in self.rules:
            if fnmatch.fnmatchcase(leaf_path, pattern):
                return codec
        return self.default

    def resolve(self, leaf_path: str, arr: np.ndarray) -> str:
        """The codec actually used for this leaf, after the guard rails."""
        codec = self.codec_for(leaf_path)
        if codec == "none":
            return "none"
        if arr.ndim == 0 or not arr.shape or arr.nbytes < self.min_chunk_bytes:
            return "none"
        is_float = arr.dtype.kind == "f" or arr.dtype.name.startswith(("bfloat16", "float8"))
        if codec.partition(":")[0] == "int8-blockq" and not is_float:
            codec = self.lossless_fallback
        name, _, param = codec.partition(":")
        if (
            self.auto_shuffle
            and name == "zlib"
            and arr.dtype.kind == "f"
            and arr.dtype.itemsize >= 4
        ):
            return "shuffle+zlib" + (f":{param}" if param else "")
        return codec

    def chunk_rows_for(self, n_rows: int, row_bytes: int) -> int:
        if self.chunk_rows is not None:
            return max(1, min(int(self.chunk_rows), max(n_rows, 1)))
        return max(1, min(n_rows, self.target_chunk_bytes // max(row_bytes, 1)))


def _default_policy(cls) -> "CodecPolicy":
    """``CodecPolicy.default()`` — the measured per-dtype / per-leaf-name
    default table (ROADMAP open item, first slice).  Attach it once to the
    :class:`CheckpointManager` instead of passing a policy at every ``save``
    call site.

    The rules encode the numbers committed in ``BENCH_io.json`` /
    ``benchmarks/lm_checkpoint.py``:

    * field snapshots (a ``fields`` component anywhere in the leaf path —
      both the tree_ser dotted form ``fields.u`` and the dataset-path form
      ``fields/u``) tolerate the stored-scale-bounded loss →
      ``int8-blockq`` (3.94:1 at ~585 MB/s effective);
      :meth:`CodecPolicy.resolve` already demotes non-float fields to the
      lossless fallback;
    * everything else (params, optimizer moments, counters) must stay
      bit-exact → ``zlib``, which ``resolve``'s dtype heuristic upgrades to
      ``shuffle+zlib`` for f32/f64 leaves (1.88:1 → ~2.45:1) and keeps
      plain for integer / sub-4-byte dtypes;
    * leaves under ``min_chunk_bytes`` stay on the contiguous zero-copy
      path (chunk framing would cost more than it saves).
    """
    return cls(
        default="zlib",
        rules=(
            ("fields[./]*", "int8-blockq"),
            ("*[./]fields[./]*", "int8-blockq"),
        ),
    )


# attached after the class body: `default` is already the name of the policy's
# fallback-codec *field*, so a method of the same name inside the body would
# shadow the dataclass field default.  Instance lookup (`self.default`) still
# resolves to the field because __init__ writes an instance attribute.
CodecPolicy.default = classmethod(_default_policy)  # type: ignore[assignment]


@dataclass
class SaveResult:
    step: int
    generation: int
    bytes_data: int
    wall_s: float
    write_stats: WriteStats
    n_leaves: int
    filter_stats: FilterStats = field(default_factory=FilterStats)

    @property
    def bandwidth_bps(self) -> float:
        return self.bytes_data / self.wall_s if self.wall_s else float("inf")

    @property
    def compression_ratio(self) -> float:
        return self.filter_stats.ratio


class CheckpointManager:
    """Write/read training (or CFD) snapshots into one TH5 run file."""

    def __init__(
        self,
        path: str,
        *,
        create: bool | None = None,
        common: Mapping[str, Any] | None = None,
        block_size: int = 4096,
        lineage: Mapping[str, Any] | None = None,
        codec_policy: CodecPolicy | None = None,
    ):
        exists = os.path.exists(path)
        if create is None:
            create = not exists
        if create:
            self.file = TH5File.create(path, block_size=block_size, lineage=lineage)
            self.file.create_group(COMMON, attrs=dict(common or {}))
            self.file.create_group(SIM)
            self.file.commit()
        else:
            self.file = TH5File.open(path, mode="r+")
        self.path = path
        # manager-level filter policy: `save` falls back to this when no
        # per-call policy is given, so call sites set it ONCE (e.g.
        # `CodecPolicy.default()`) instead of threading it everywhere;
        # None keeps every leaf on the contiguous zero-copy path
        self.codec_policy = codec_policy
        self._io_lock = threading.Lock()  # serialises *sessions*, not slabs
        # static-topology fast path: row-split plans depend only on
        # (n_rows, row_bytes, n_ranks), so steady-state steps skip the
        # reduce+exscan + validation entirely
        self._plan_cache: dict[tuple[int, int, int], Any] = {}
        self._plan_hits = 0
        self._plan_misses = 0
        # persistent collective writers (one per aggregation config) so the
        # aggregator thread pool survives across steps
        self._writers: dict[AggregationConfig, CollectiveWriter] = {}
        # persistent filter pipelines (chunked/compressed leaves) — same
        # lifetime policy as the writers
        self._pipelines: dict[AggregationConfig, ChunkPipeline] = {}

    def _plan_for(self, n_rows: int, row_bytes: int, n_ranks: int):
        key = (n_rows, row_bytes, n_ranks)
        plan = self._plan_cache.get(key)
        if plan is None:
            plan = plan_rows(split_rows(n_rows, n_ranks), row_bytes)
            validate_plan(plan)  # lock-free safety invariant
            self._plan_cache[key] = plan
            self._plan_misses += 1
        else:
            self._plan_hits += 1
        return plan

    def plan_cache_info(self) -> dict[str, int]:
        return {
            "hits": self._plan_hits,
            "misses": self._plan_misses,
            "entries": len(self._plan_cache),
        }

    def _writer_for(self, aggregation: AggregationConfig | None) -> CollectiveWriter:
        cfg = aggregation or AggregationConfig()
        w = self._writers.get(cfg)
        if w is None or w.fd != self.file.fd:
            if w is not None:
                w.close()
            w = CollectiveWriter(self.file.fd, cfg)
            self._writers[cfg] = w
        return w

    def _pipeline_for(self, aggregation: AggregationConfig | None) -> ChunkPipeline:
        cfg = aggregation or AggregationConfig()
        p = self._pipelines.get(cfg)
        if p is None or p.file is not self.file:
            if p is not None:
                p.close()
            p = ChunkPipeline(self.file, cfg)
            self._pipelines[cfg] = p
        return p

    # -- introspection ---------------------------------------------------------

    def common(self) -> dict[str, Any]:
        return self.file.group_attrs(COMMON)

    def steps(self) -> list[int]:
        out = []
        for child in self.file.children(SIM):
            name = child.rsplit("/", 1)[-1]
            if name.startswith("step_"):
                out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    # -- write path ------------------------------------------------------------

    def save(
        self,
        step: int,
        state: Any,
        *,
        n_ranks: int = 1,
        aggregation: AggregationConfig | None = None,
        independent: bool = False,
        checksum: bool = True,
        extra_attrs: Mapping[str, Any] | None = None,
        extra_datasets: Mapping[str, np.ndarray] | None = None,
        topology_override: tuple | None = None,
        overwrite: bool = False,
        codec_policy: CodecPolicy | None = None,
    ) -> SaveResult:
        """Snapshot ``state`` as ``/simulation/step_<step>``.

        ``n_ranks`` models the SPMD writer count: every leaf's rows are split
        contiguously over ranks (reduce+exscan plan) and written as disjoint
        hyperslabs through the collective-buffering writer.

        ``codec_policy`` routes selected leaves through the chunked filter
        pipeline instead (compressed, variable-length chunks written by the
        aggregators overlapped with encoding); leaves resolved to ``none``
        keep the zero-copy contiguous path.  ``None`` falls back to the
        manager's own ``codec_policy`` (e.g. ``CodecPolicy.default()``
        passed once at construction).
        """
        if codec_policy is None:
            codec_policy = self.codec_policy
        t0 = time.perf_counter()
        skeleton, leaves = tree_ser.flatten_state(state)
        group = _step_group(step)
        with self._io_lock:
            if self.file.exists(group):
                if not overwrite:
                    raise ValueError(f"step {step} already written")
                # TRS replay over the same file: shadow paging makes dropping
                # the old step group from the index safe (old extents become
                # dead space; prior generations still reference them)
                self.file.drop_subtree(group)
            self.file.create_group(
                group,
                attrs={
                    "step": int(step),
                    "skeleton": skeleton,
                    "n_ranks": int(n_ranks),
                    "wall_time": time.time(),
                    **dict(extra_attrs or {}),
                },
            )
            # ---- collective creation: one planner allocates all extents ----
            metas: dict[str, Any] = {}
            plans: dict[str, Any] = {}
            chunked: dict[str, str] = {}  # leaf path -> resolved codec
            total_bytes = 0
            for path, arr in leaves.items():
                arr = np.asarray(arr, order="C")  # NB: ascontiguousarray would 0-d → (1,)
                leaves[path] = arr
                name = f"{group}/state/{path}"
                codec = codec_policy.resolve(path, arr) if codec_policy else "none"
                n_rows = arr.shape[0] if arr.ndim else 1
                row_bytes = arr.nbytes // max(n_rows, 1)
                if codec != "none":
                    meta = self.file.create_chunked_dataset(
                        name,
                        arr.shape,
                        arr.dtype,
                        chunk_rows=codec_policy.chunk_rows_for(n_rows, row_bytes),
                        codec=codec,
                    )
                    chunked[path] = codec
                else:
                    meta = self.file.create_dataset(name, arr.shape, arr.dtype)
                plan = self._plan_for(n_rows, meta.row_bytes, n_ranks)
                metas[path], plans[path] = meta, plan
                total_bytes += arr.nbytes

            # ---- independent writes into disjoint extents ----
            reqs: list[list[WriteRequest]] = [[] for _ in range(n_ranks)]
            for path, arr in leaves.items():
                if path in chunked:
                    continue  # filtered leaves go through the chunk pipeline
                meta, plan = metas[path], plans[path]
                flat = arr.reshape((plan.total_rows if arr.ndim else 1, -1))
                for r in range(n_ranks):
                    lo, hi = plan.row_range(r)
                    if hi > lo:
                        reqs[r].append(
                            WriteRequest(meta.offset + plan.extents[r].offset, flat[lo:hi])
                        )
            writer = self._writer_for(aggregation)
            stats = (
                writer.write_independent(reqs) if independent else writer.write_collective(reqs)
            )

            # ---- chunked leaves: encode in the aggregators, overlapped ----
            fstats = FilterStats()
            if chunked:
                pipe = self._pipeline_for(aggregation)
                for path in chunked:
                    fstats.merge(pipe.write(metas[path], leaves[path]))

            # ---- topology datasets (paper Fig. 4) ----
            if topology_override is not None:
                uids, subgrid, boxes = topology_override
                for nm, arr, dt in (
                    ("grid_property", np.asarray(uids, np.uint64), "<u8"),
                    ("subgrid_uid", np.asarray(subgrid, np.uint64), "<u8"),
                    ("bounding_box", np.asarray(boxes, np.float64), "<f8"),
                ):
                    meta = self.file.create_dataset(f"{group}/topology/{nm}", arr.shape, dt)
                    self.file.write_full(meta, arr, checksum=True)
            else:
                self._write_topology(group, metas, plans, n_ranks)

            for name, arr in dict(extra_datasets or {}).items():
                arr = np.ascontiguousarray(arr)
                meta = self.file.create_dataset(f"{group}/{name}", arr.shape, arr.dtype)
                self.file.write_full(meta, arr, checksum=checksum)

            if checksum:
                for path in leaves:
                    if path not in chunked:  # chunked leaves carry per-chunk CRCs
                        self.file.seal_checksum(f"{group}/state/{path}")
            gen = self.file.commit()  # shadow flip: snapshot becomes durable
        return SaveResult(
            step=step,
            generation=gen,
            bytes_data=total_bytes,
            wall_s=time.perf_counter() - t0,
            write_stats=stats,
            n_leaves=len(leaves),
            filter_stats=fstats,
        )

    def _write_topology(self, group: str, metas: dict, plans: dict, n_ranks: int) -> None:
        uids, boxes, names = [], [], []
        # rank-major ordering: all of rank 0's chunks first → root chunk row 0
        for rank in range(n_ranks):
            local = 0
            for li, (path, plan) in enumerate(sorted(plans.items())):
                lo, hi = plan.row_range(rank)
                if hi <= lo and not (rank == 0 and plan.total_rows == 0):
                    continue
                uids.append(uid.pack(rank, local, depth=0, morton=li % (uid.MORTON_MAX + 1)))
                boxes.append((li, lo, hi))
                names.append(path)
                local += 1
        uids_arr = np.asarray(uids, dtype=np.uint64)
        boxes_arr = np.asarray(boxes, dtype=np.int64).reshape(len(boxes), 3)
        gp = self.file.create_dataset(f"{group}/topology/grid_property", uids_arr.shape, "<u8")
        bb = self.file.create_dataset(
            f"{group}/topology/bounding_box",
            boxes_arr.shape,
            "<i8",
            attrs={"leaf_order": sorted(plans)},
        )
        self.file.write_full(gp, uids_arr, checksum=True)
        self.file.write_full(bb, boxes_arr, checksum=True)

    # -- read path ---------------------------------------------------------------

    def restore(self, step: int | None = None, verify: bool = True) -> tuple[int, Any]:
        """Load a full snapshot → (step, state).  ``step=None`` = newest valid."""
        if step is None:
            step = self.latest_valid(verify=verify)
            if step is None:
                raise FileNotFoundError(f"no valid snapshot in {self.path}")
        group = _step_group(step)
        attrs = self.file.group_attrs(group)
        skeleton = attrs["skeleton"]
        leaves = {
            p: self.file.read(f"{group}/state/{p}", verify=verify)
            for p in tree_ser.leaf_paths(skeleton)
        }
        return step, tree_ser.unflatten_state(skeleton, leaves)

    def restore_leaf_shard(
        self, step: int, leaf_path: str, rank: int, n_ranks: int, verify: bool = False
    ) -> np.ndarray:
        """Elastic restore: read only the rows rank ``rank``-of-``n_ranks``
        owns under a *new* decomposition (paper: restart 'prepared on a
        smaller machine', snapshot carries topology so no re-decomposition)."""
        group = _step_group(step)
        meta = self.file.meta(f"{group}/state/{leaf_path}")
        n_rows = meta.shape[0] if meta.shape else 1
        plan = self._plan_for(n_rows, meta.row_bytes, n_ranks)
        lo, hi = plan.row_range(rank)
        return self.file.read_rows(f"{group}/state/{leaf_path}", lo, hi - lo)

    def latest_valid(self, verify: bool = True) -> int | None:
        """Newest snapshot whose payload checksums validate — the auto-resume
        entry point.  Torn/unclean writes never appear here at all because
        uncommitted sessions are invisible (shadow paging)."""
        for step in reversed(self.steps()):
            if not verify:
                return step
            try:
                group = _step_group(step)
                skeleton = self.file.group_attrs(group)["skeleton"]
                for p in tree_ser.leaf_paths(skeleton):
                    self.file.read(f"{group}/state/{p}", verify=True)
                return step
            except (CorruptFileError, KeyError):
                continue
        return None

    def topology(self, step: int) -> tuple[np.ndarray, np.ndarray, list[str]]:
        group = _step_group(step)
        gp = self.file.read(f"{group}/topology/grid_property")
        bb = self.file.read(f"{group}/topology/bounding_box")
        order = self.file.meta(f"{group}/topology/bounding_box").attrs["leaf_order"]
        return gp, bb, list(order)

    def close(self) -> None:
        for w in self._writers.values():
            w.close()
        self._writers.clear()
        for p in self._pipelines.values():
            p.close()
        self._pipelines.clear()
        self.file.close()

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class AsyncCheckpointer:
    """Overlap snapshots with compute (paper §1: during the dump 'all
    processes ... have to wait' — we remove that wait).

    ``save`` stages device arrays to host synchronously (cheap, and required
    before the step buffer is donated/overwritten) and runs the pwrite +
    commit on a background thread.  At most one snapshot is in flight.

    **Double-buffered mode** (default, paper §5.2 "asynchronous I/O"): the
    device→host staging of step *n+1* overlaps the disk write of step *n* —
    two staging buffers are alive at the peak (the in-flight one and the one
    being filled).  ``double_buffer=False`` restores the seed behaviour of
    joining the in-flight write *before* staging (single buffer, no
    stage/write overlap)."""

    def __init__(self, manager: CheckpointManager, *, double_buffer: bool = True):
        self.manager = manager
        self.double_buffer = double_buffer
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._last_result: SaveResult | None = None

    def save(self, step: int, state: Any, **kw) -> None:
        if self.double_buffer:
            staged = _stage_to_host(state)  # overlaps the in-flight write
            self.wait()
        else:
            self.wait()
            staged = _stage_to_host(state)

        def run() -> None:
            try:
                self._last_result = self.manager.save(step, staged, **kw)
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=run, name=f"ckpt-save-{step}", daemon=True)
        self._thread.start()

    def wait(self) -> SaveResult | None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        return self._last_result


def _stage_to_host(tree: Any) -> Any:
    def stage(x):
        if hasattr(x, "addressable_data") or type(x).__module__.startswith("jax"):
            return np.asarray(x)
        if isinstance(x, np.ndarray):
            return x.copy()
        return x

    if isinstance(tree, dict):
        return {k: _stage_to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        t = type(tree)
        return t(_stage_to_host(v) for v in tree)
    return stage(tree)
