"""Spans + tracer: monotonic-clock request tracing with pool handoff.

Design constraints, in order:

* **near-zero cost when disabled** — the hot paths (broker submit, decode
  gather, wire send) call :meth:`Tracer.span`/:meth:`Tracer.start_trace`
  unconditionally; with tracing off both return the singleton
  :data:`NOOP_SPAN` after ONE attribute check and allocate nothing.  The
  disabled-path allocation count is asserted by ``tests/test_obs.py``.
* **explicit context handoff** — worker pools (codec/decode executors, the
  broker worker threads, subscription pumps) never inherit ambient state:
  the submitting side captures a :class:`SpanContext` and the worker
  either passes it to :meth:`Tracer.record` (retroactive spans built from
  timestamps it already takes) or installs it with :meth:`Tracer.use`.
* **deterministic sampling** — 1-in-``sample_every`` root traces by a
  plain counter, no RNG / wall clock: a replayed workload samples the
  same requests.  Child spans inherit the decision through the context
  (an unsampled root hands out no context, so children no-op).
* **monotonic clock** — all timestamps are ``time.perf_counter`` seconds;
  they are directly comparable with the broker's existing ``t_submit`` /
  ``t_start`` accounting, which is how the queue/schedule/execute phases
  become spans without a single extra clock read on the hot path.

Finished spans land in a bounded ring (oldest dropped) and are pulled by
:func:`repro.obs.export.write_chrome_trace` / ``Tracer.drain``.  One trace
= every span sharing a ``trace_id``; the wire protocol carries
``(trace_id, parent_span_id)`` in frame metadata so a remote request's
client, broker and decode spans stitch into one tree.

Copied from ``src/repro/obs/trace.py``; only the import lines differ.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from typing import Any, NamedTuple

_clock = time.perf_counter

# -- span-name taxonomy (documented in docs/OBSERVABILITY.md; the SPAN_*
# constants below are drift-checked against that doc by tools/check_docs.py)

SPAN_CLIENT_REQUEST = "client.request"  # remote client round-trip (root)
SPAN_BROKER_REQUEST = "broker.request"  # in-process submit (root)
SPAN_QUEUE_WAIT = "broker.queue_wait"  # admission → worker pop
SPAN_SCHEDULE = "broker.schedule"  # worker pop → execute start
SPAN_EXECUTE = "broker.execute"  # request execution (cache tags ride here)
SPAN_WIRE_SEND = "wire.send"  # response framing + socket handoff
SPAN_DECODE_GATHER = "decode.gather"  # one gather/decode_chunks call
SPAN_DECODE_FETCH = "decode.fetch"  # one (batched) preadv of stored chunks
SPAN_DECODE_INFLATE = "decode.inflate"  # one chunk's CRC + codec decode
SPAN_ENCODE_CHUNK = "encode.chunk"  # one chunk's codec encode (write side)
SPAN_PUSH_DELIVER = "push.deliver"  # one subscription push (root)


class SpanContext(NamedTuple):
    """The (trace_id, span_id) pair that crosses thread/pool/wire
    boundaries.  Only sampled traces ever hand one out — holding a context
    IS the sampling decision."""

    trace_id: int
    span_id: int


class Span:
    """One finished-or-running span.  ``t0``/``t1`` are ``perf_counter``
    seconds; ``tags`` is lazily allocated; ``thread`` is the ident of the
    thread that *recorded* the span (pool handoff is visible as a thread
    change under one trace)."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "t0", "t1", "tags", "thread", "_tracer")

    def __init__(self, tracer: "Tracer", name: str, trace_id: int, span_id: int, parent_id: int):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0 = _clock()
        self.t1: float | None = None
        self.tags: dict[str, Any] | None = None
        self.thread = threading.get_ident()

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    @property
    def duration_s(self) -> float:
        return (self.t1 if self.t1 is not None else _clock()) - self.t0

    def tag(self, key: str, value: Any) -> "Span":
        if self.tags is None:
            self.tags = {}
        self.tags[key] = value
        return self

    def end(self) -> None:
        if self.t1 is None:  # idempotent: recorded exactly once
            self.t1 = _clock()
            self._tracer._finish(self)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.end()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"Span({self.name!r}, trace={self.trace_id:#x}, id={self.span_id},"
            f" parent={self.parent_id}, dur={self.duration_s * 1e3:.3f}ms)"
        )


class _NoopSpan:
    """The disabled/unsampled path: one shared instance, every method a
    no-op, ``trace_id`` 0 (falsy — callers guard tag/meta work on it)."""

    __slots__ = ()
    trace_id = 0
    span_id = 0
    parent_id = 0
    name = ""
    t0 = 0.0
    t1 = 0.0
    tags = None
    thread = 0

    @property
    def context(self) -> None:
        return None

    @property
    def duration_s(self) -> float:
        return 0.0

    def tag(self, key: str, value: Any) -> "_NoopSpan":
        return self

    def end(self) -> None:
        pass

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


#: Singleton returned by every tracer entry point while disabled (or for
#: unsampled traces): the hot path allocates nothing.
NOOP_SPAN = _NoopSpan()


class _Scope:
    """``with tracer.use(ctx):`` — installs ``ctx`` as the thread's current
    context and restores the previous one on exit."""

    __slots__ = ("_tracer", "_ctx", "_prev")

    def __init__(self, tracer: "Tracer", ctx: SpanContext | None):
        self._tracer = tracer
        self._ctx = ctx

    def __enter__(self) -> SpanContext | None:
        local = self._tracer._local
        self._prev = getattr(local, "ctx", None)
        local.ctx = self._ctx
        return self._ctx

    def __exit__(self, *exc) -> None:
        self._tracer._local.ctx = self._prev


class _NoopScope:
    """Shared scope for the disabled path — ``use()`` allocates nothing."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        pass


_NOOP_SCOPE = _NoopScope()


class Tracer:
    """Process-wide span factory + bounded finished-span ring.

    ``enabled`` gates everything (default off — production cost is one
    attribute check per call site).  ``sample_every=N`` keeps 1 in N root
    traces, deterministically (counter, not RNG).  ``capacity`` bounds the
    ring of finished spans (oldest evicted)."""

    def __init__(self, *, enabled: bool = False, sample_every: int = 1, capacity: int = 65536):
        self.enabled = bool(enabled)
        self.sample_every = max(1, int(sample_every))
        self._spans: deque[Span] = deque(maxlen=int(capacity))
        self._lock = threading.Lock()
        self._local = threading.local()
        self._trace_seq = itertools.count()
        self._span_seq = itertools.count(1)
        # per-process base keeps trace ids from colliding across processes
        # sharing one trace file (client + broker in separate processes)
        self._base = (os.getpid() & 0xFFFF) << 40

    # -- configuration -------------------------------------------------------

    def configure(
        self,
        *,
        enabled: bool | None = None,
        sample_every: int | None = None,
        capacity: int | None = None,
    ) -> "Tracer":
        if capacity is not None:
            with self._lock:
                self._spans = deque(self._spans, maxlen=int(capacity))
        if sample_every is not None:
            self.sample_every = max(1, int(sample_every))
        if enabled is not None:
            self.enabled = bool(enabled)  # last: flips the hot-path gate
        return self

    def reset(self) -> None:
        """Drop buffered spans and restart the sampling counter (tests)."""
        with self._lock:
            self._spans.clear()
        self._trace_seq = itertools.count()
        self._local = threading.local()

    # -- span creation -------------------------------------------------------

    def start_trace(self, name: str):
        """Begin a new root span — the only place the sampling decision is
        made.  Returns :data:`NOOP_SPAN` when disabled or unsampled."""
        if not self.enabled:
            return NOOP_SPAN
        n = next(self._trace_seq)
        if n % self.sample_every:
            return NOOP_SPAN
        trace_id = self._base | (n + 1)
        return Span(self, name, trace_id, next(self._span_seq), 0)

    def span(self, name: str, parent=None):
        """Child span under ``parent`` (a :class:`Span`, a
        :class:`SpanContext`, or ``None`` = the thread's current context).
        No parent context ⇒ :data:`NOOP_SPAN`: children never out-sample
        their root."""
        if not self.enabled:
            return NOOP_SPAN
        if parent is None:
            parent = getattr(self._local, "ctx", None)
            if parent is None:
                return NOOP_SPAN
        tid = parent.trace_id
        if not tid:
            return NOOP_SPAN
        return Span(self, name, tid, next(self._span_seq), parent.span_id)

    def record(
        self,
        name: str,
        parent,
        t0: float,
        t1: float,
        tags: dict[str, Any] | None = None,
    ) -> None:
        """Retroactive span from timestamps the caller already holds (the
        broker's ``t_submit``/``t_start``; pool workers' timed closures).
        ``parent`` as in :meth:`span`; no-op without a sampled context."""
        if not self.enabled or parent is None:
            return
        tid = parent.trace_id
        if not tid:
            return
        sp = Span.__new__(Span)
        sp._tracer = self
        sp.name = name
        sp.trace_id = tid
        sp.span_id = next(self._span_seq)
        sp.parent_id = parent.span_id
        sp.t0 = float(t0)
        sp.t1 = float(t1)
        sp.tags = tags
        sp.thread = threading.get_ident()
        self._finish(sp)

    def adopt(self, trace_id: int, parent_span_id: int) -> SpanContext | None:
        """Context for a trace that started elsewhere (wire ingress).  The
        remote sampler already decided — adopt unconditionally while
        enabled."""
        if not self.enabled or not trace_id:
            return None
        return SpanContext(int(trace_id), int(parent_span_id))

    # -- ambient context -----------------------------------------------------

    def use(self, ctx):
        """Install ``ctx`` (Span / SpanContext / None) as the thread's
        current context for the ``with`` body — the implicit parent of
        :meth:`span` calls with no explicit parent.  Disabled tracer or
        NOOP span: returns a shared no-op scope, allocating nothing."""
        if not self.enabled or ctx is None or ctx is NOOP_SPAN:
            return _NOOP_SCOPE
        if not isinstance(ctx, SpanContext):
            ctx = ctx.context  # Span
        return _Scope(self, ctx)

    def current_context(self) -> SpanContext | None:
        if not self.enabled:
            return None
        return getattr(self._local, "ctx", None)

    # -- the finished-span ring ----------------------------------------------

    def _finish(self, span: Span) -> None:
        self._spans.append(span)  # deque append: atomic, bounded

    def __len__(self) -> int:
        return len(self._spans)

    def snapshot(self) -> list[Span]:
        """Copy of the buffered finished spans (oldest first)."""
        with self._lock:
            return list(self._spans)

    def drain(self) -> list[Span]:
        """Pop every buffered finished span (oldest first)."""
        with self._lock:
            out = list(self._spans)
            self._spans.clear()
        return out

    def spans_for(self, trace_id: int) -> list[Span]:
        """Buffered spans of ONE trace, in finish order (non-destructive)."""
        with self._lock:
            return [s for s in self._spans if s.trace_id == trace_id]


#: The process-wide tracer every layer shares.  Enable with
#: ``TRACER.configure(enabled=True)`` (benchmarks: the ``--trace`` flag).
TRACER = Tracer()


def get_tracer() -> Tracer:
    return TRACER
