"""Unified metrics plane: one registry of named counters/gauges/histograms.

Before this module, the stack's accounting was scattered: ``COPY_COUNTER``
(aggregation), ``READ_COUNTER`` (container), ``FilterStats`` merge dicts
(codec pipelines), per-instance ``ChunkCache`` hit/miss ints, and the
broker's ``ServiceStats`` — five shapes, five locking schemes, no single
place to read "the process".  The registry gives every one of them a
dotted name in ONE thread-safe table; the existing snapshot dataclasses
stay as *views* (they still work; they now also feed the registry).

Instruments:

* :class:`Counter` — monotonically increasing float/int (``inc``).
* :class:`Gauge` — set-to-current-value (``set``/``inc``/``dec``).
* :class:`Histogram` — count/sum/min/max of observations (``observe``);
  enough for rates and means without binning policy baked in.

Two sourcing modes:

* direct: code holds the instrument and calls ``inc``/``observe``.
* collected: a component that already keeps state under its own lock
  (the broker) registers a *collector* callback; ``collect()`` invokes it
  at read time and merges the values it reports.  Collector callbacks run
  OUTSIDE the registry lock (the list is copied first), so a collector
  may take its component's lock without deadlock risk.

Metric names live in the ``M_*`` constants below and are drift-checked
against ``docs/OBSERVABILITY.md`` by ``tools/check_docs.py``.

Copied from ``src/repro/obs/metrics.py``; only the import lines differ.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Iterable

# -- metric name registry (documented in docs/OBSERVABILITY.md) ------------

M_COPY_COUNT = "io.copies"  # buffer copies on the write path
M_COPY_BYTES = "io.copied_bytes"  # bytes moved by those copies
M_READ_SYSCALLS = "io.read_syscalls"  # preadv/read calls on the read path
M_READ_BYTES = "io.read_bytes"  # bytes fetched by those calls
M_CACHE_HITS = "cache.hits"  # decoded-chunk cache hits (all caches)
M_CACHE_MISSES = "cache.misses"  # decoded-chunk cache misses
M_CACHE_EVICTIONS = "cache.evictions"  # LRU evictions
M_DECODE_CHUNKS = "decode.chunks"  # chunks decoded (filter pipeline)
M_DECODE_RAW_BYTES = "decode.raw_bytes"  # decoded output bytes
M_DECODE_FETCH_SECONDS = "decode.fetch_seconds"  # time in storage fetch
M_DECODE_INFLATE_SECONDS = "decode.inflate_seconds"  # time in codec decode
M_ENCODE_CHUNKS = "encode.chunks"  # chunks encoded (write pipeline)
M_ENCODE_RAW_BYTES = "encode.raw_bytes"  # pre-encode input bytes
M_ENCODE_SECONDS = "encode.encode_seconds"  # time in codec encode
M_WRITE_SECONDS = "encode.write_seconds"  # time in store writes
M_SLOW_REQUESTS = "service.slow_requests"  # broker slow-log trips

# broker collector names (reported by DataService's registered collector;
# several brokers in one process sum — see MetricsRegistry.collect)
M_SVC_QUEUE_DEPTH = "service.queue_depth"  # admitted, unstarted (gauge)
M_SVC_INFLIGHT = "service.inflight"  # executing right now (gauge)
M_SVC_ADMITTED = "service.admitted"  # admission accepts
M_SVC_REJECTED = "service.rejected"  # admission rejections (backpressure)
M_SVC_COMPLETED = "service.completed"  # requests finished OK
M_SVC_FAILED = "service.failed"  # requests finished in error / shed
M_SVC_BYTES_SERVED = "service.bytes_served"  # logical response bytes
M_SVC_SUBSCRIBERS = "service.subscribers"  # live push subscriptions (gauge)
M_SVC_PUSHED_CHUNKS = "service.pushed_chunks"  # fan-out chunks delivered
M_SVC_PUSHED_BYTES = "service.pushed_bytes"  # fan-out bytes delivered
M_SVC_DROPPED_CHUNKS = "service.dropped_chunks"  # drop-oldest skips


class Counter:
    """Monotonic counter.  ``inc`` only; negative increments are refused
    so a counter can never run backwards (resets go through ``_reset``,
    used by the unregistered per-call instances in aggregation)."""

    __slots__ = ("name", "_value", "_lock")
    kind = "counter"

    def __init__(self, name: str = ""):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counter increments must be >= 0")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _reset(self) -> None:
        with self._lock:
            self._value = 0.0


class Gauge:
    """Point-in-time value: ``set`` wins, ``inc``/``dec`` adjust."""

    __slots__ = ("name", "_value", "_lock")
    kind = "gauge"

    def __init__(self, name: str = ""):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """count/sum/min/max of observations — rates and means without a
    binning policy.  Exposed in Prometheus text as ``_count``/``_sum``
    (plus min/max as annotated gauges)."""

    __slots__ = ("name", "count", "sum", "min", "max", "_lock")
    kind = "histogram"

    def __init__(self, name: str = ""):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    @property
    def mean(self) -> float:
        with self._lock:
            return self.sum / self.count if self.count else 0.0

    def snapshot(self) -> dict[str, float]:
        with self._lock:
            return {
                "count": float(self.count),
                "sum": self.sum,
                "min": self.min if self.count else 0.0,
                "max": self.max if self.count else 0.0,
            }


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Get-or-create table of instruments keyed by dotted name, plus
    collector callbacks for components that keep state under their own
    locks.  ``collect()`` returns one flat ``{name: value}`` mapping
    (histograms expand to ``name.count``/``.sum``/``.min``/``.max``);
    collector-reported values for a name already present are SUMMED
    (several brokers in one process add up, same as several caches)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, Any] = {}
        self._collectors: list[Callable[[], dict[str, float]]] = []

    def _get(self, name: str, kind: str):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = _KINDS[kind](name)
                self._metrics[name] = m
            elif m.kind != kind:
                raise TypeError(f"metric {name!r} already registered as {m.kind}, not {kind}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, "counter")

    def gauge(self, name: str) -> Gauge:
        return self._get(name, "gauge")

    def histogram(self, name: str) -> Histogram:
        return self._get(name, "histogram")

    def get(self, name: str):
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._metrics)

    # -- collectors ----------------------------------------------------------

    def register_collector(self, fn: Callable[[], dict[str, float]]) -> None:
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def unregister_collector(self, fn: Callable[[], dict[str, float]]) -> None:
        with self._lock:
            try:
                self._collectors.remove(fn)
            except ValueError:
                pass

    # -- reading -------------------------------------------------------------

    def collect(self) -> dict[str, float]:
        with self._lock:
            metrics = list(self._metrics.values())
            collectors = list(self._collectors)
        out: dict[str, float] = {}
        for m in metrics:
            if m.kind == "histogram":
                for k, v in m.snapshot().items():
                    out[f"{m.name}.{k}"] = v
            else:
                out[m.name] = m.value
        # collectors run unlocked: they may take their component's lock
        for fn in collectors:
            for name, value in fn().items():
                out[name] = out.get(name, 0.0) + float(value)
        return out

    def instruments(self) -> Iterable[Any]:
        with self._lock:
            return list(self._metrics.values())

    def reset(self) -> None:
        """Drop every instrument and collector (tests only)."""
        with self._lock:
            self._metrics.clear()
            self._collectors.clear()


#: The process-wide registry all layers share.
REGISTRY = MetricsRegistry()
