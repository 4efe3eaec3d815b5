"""Low-overhead runtime span tracing + metrics registry.

The runtime half of the observability story (the static half is the JAX package's
analyzers): a thread-safe ring-buffer :class:`TraceRecorder` that the
steady-state paths — ``Runner.run``/``run_superstep``, ``DistributedStep``
dispatch and PS pull/push, the resilient control plane, the prefetcher,
sharded checkpoints — instrument with nested **spans** (wall-clock
intervals on a per-thread track) and **counters** (monotonic totals:
dispatches, wire bytes, retries, dropped batches).

Cost model, enforced by tests (``tests/test_telemetry.py``):

- **disabled** (``ADT_TRACE=0``, the default): ``span()`` returns a
  shared no-op context manager after one module-attribute check —
  sub-microsecond enter/exit, no allocation, no lock. Counters are still
  collected (a dict add under a lock, ~100ns — the registry is the
  always-on metrics surface `metrics_text()` exposes).
- **enabled** (``ADT_TRACE=1``): completed spans append to a bounded
  ``deque`` (oldest dropped first, drop count kept); timestamps are
  ``time.perf_counter_ns()`` (monotonic).
- **sampled** (``ADT_TRACE=sampled``): record one span out of every
  ``ADT_TRACE_SAMPLE`` — the always-on production setting.

Span ids are per-recorder monotonic ints carried on a thread-local stack,
so logs can correlate with traces (``utils/logging.py`` JSON mode embeds
``current_span_id()``) and children record their parent. Export formats
live in the JAX package's ``telemetry/export.py`` (not yet ported).
"""
import collections
import contextlib
import itertools
import os
import threading
import time
from typing import Dict, List, Optional

from autodist_tpu_torch import const

# ------------------------------------------------------------- span records


class SpanEvent:
    """One completed span. ``ts_ns``/``dur_ns`` are perf_counter_ns
    wall-clock; ``tid`` is a small per-recorder thread index (thread
    names ride in the recorder's thread table)."""

    __slots__ = ("name", "cat", "ts_ns", "dur_ns", "tid", "span_id",
                 "parent_id", "args")

    def __init__(self, name, cat, ts_ns, dur_ns, tid, span_id, parent_id,
                 args):
        self.name = name
        self.cat = cat
        self.ts_ns = ts_ns
        self.dur_ns = dur_ns
        self.tid = tid
        self.span_id = span_id
        self.parent_id = parent_id
        self.args = args

    def __repr__(self):
        return ("SpanEvent(%s/%s id=%d dur=%.3fms)"
                % (self.cat, self.name, self.span_id, self.dur_ns / 1e6))


class _Span:
    """Live (entered) span — the enabled-path context manager."""

    __slots__ = ("_rec", "name", "cat", "args", "_t0", "id", "_parent")

    def __init__(self, rec, name, cat, args):
        self._rec = rec
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self):
        rec = self._rec
        self.id = next(rec._ids)
        stack = rec._span_stack()
        self._parent = stack[-1] if stack else 0
        stack.append(self.id)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter_ns()
        rec = self._rec
        stack = rec._span_stack()
        if stack and stack[-1] == self.id:
            stack.pop()
        rec._append(SpanEvent(self.name, self.cat, self._t0, t1 - self._t0,
                              rec._tid(), self.id, self._parent, self.args))
        return False


class _NoopSpan:
    """Disabled-path context manager: one shared instance, trivial
    enter/exit — the <1µs overhead guarantee."""

    __slots__ = ()
    id = 0

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NOOP = _NoopSpan()


# ---------------------------------------------------------------- recorder


# counters pre-registered at zero so `metrics_text()` exposes the full
# registry surface even before the corresponding path first runs —
# scrapers see a stable key set, not one that grows as code paths fire
DEFAULT_COUNTERS = (
    "runner.steps", "runner.supersteps", "runner.d2h_bytes",
    "runner.readbacks",
    "dstep.dispatches", "dstep.ps_pulls", "dstep.ps_flushes",
    "ps.pulls", "ps.pushes", "ps.applies",
    "ps.bytes_pulled", "ps.bytes_pushed", "ps.degraded_pulls",
    "ps.dropped_pushes", "ps_service.applied", "ps_service.published",
    "wire.bytes_quantized", "wire.bytes_saved",
    "zero.rs_bytes", "zero.ag_bytes",
    "overlap.buckets", "overlap.exposed_wait_ms",
    "coord.retries", "coord.reconnects", "coord.breaker_opens",
    "coord.backoff_s",
    "prefetch.batches", "prefetch.dropped_batches",
    "prefetch.dropped_examples",
    "ckpt.saves", "ckpt.barrier_s", "ckpt.gc_removed",
    "ckpt.restores", "ckpt.fallback", "ckpt.corrupt_shards",
    "ckpt.gc_orphans", "ckpt.unhealthy_skipped",
    "sentinel.skips", "sentinel.rollbacks", "sentinel.nan_steps",
    "sentinel.save_vetoes", "sentinel.ps_suppressed",
    "sentinel.lr_halvings",
    "search.candidates", "search.pruned",
    "serve.requests", "serve.batches", "serve.compiles",
    "serve.padded_rows", "serve.degraded", "serve.shed", "serve.drained",
    "serve.deadline_shed", "serve.brownouts",
    "serve.tokens", "serve.prefill_admits", "serve.evictions",
    "autoscale.grows", "autoscale.shrinks", "autoscale.holds",
    "autoscale.refusals",
    "preempt.notices", "preempt.rescue_saves", "preempt.rescue_skips",
    "preempt.handoffs", "preempt.planned_shrinks",
    "telemetry.straggler_flags", "blackbox.dumps", "profiler.windows",
    "cluster.scrapes",
)


class Histogram:
    """Fixed-bucket histogram (log-spaced bounds by default) — the
    latency-distribution metric type counters cannot express: p50/p99
    need the shape of the distribution, not its sum.

    Buckets are CUMULATIVE-exportable (Prometheus ``le`` semantics come
    from a running sum at export time); observation is one bisect + two
    adds under the registry lock — cheap enough for a per-request serving
    hot path. Quantile readout interpolates linearly inside the winning
    bucket, clamped to the observed min/max so tiny samples do not report
    a quantile outside the data."""

    __slots__ = ("bounds", "counts", "count", "sum", "min", "max")

    # log-spaced defaults sized for millisecond-unit observations:
    # 0.05 ms .. ~105 s, x2 per bucket (22 finite bounds + overflow)
    DEFAULT_BOUNDS = tuple(0.05 * 2 ** i for i in range(22))

    def __init__(self, bounds=None):
        self.bounds = tuple(float(b) for b in (
            self.DEFAULT_BOUNDS if bounds is None else bounds))
        if list(self.bounds) != sorted(self.bounds) or not self.bounds:
            raise ValueError("histogram bounds must be sorted and "
                             "non-empty, got %r" % (self.bounds,))
        self.counts = [0] * (len(self.bounds) + 1)  # +1 = overflow bucket
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None

    def observe(self, value: float):
        import bisect
        v = float(value)
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def quantile(self, q: float) -> Optional[float]:
        """Approximate q-quantile (0 <= q <= 1) from the bucket counts;
        None when empty."""
        if self.count == 0:
            return None
        if not 0.0 <= q <= 1.0:
            raise ValueError("quantile q must be in [0, 1], got %r" % q)
        rank = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c >= rank:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = (self.bounds[i] if i < len(self.bounds)
                      else (self.max if self.max is not None else lo))
                frac = (rank - seen) / c
                est = lo + (hi - lo) * max(0.0, min(1.0, frac))
                return min(max(est, self.min), self.max)
            seen += c
        return self.max

    def to_dict(self) -> dict:
        return {"bounds": list(self.bounds), "counts": list(self.counts),
                "count": self.count, "sum": self.sum,
                "min": self.min, "max": self.max,
                "p50": self.quantile(0.5), "p99": self.quantile(0.99)}

    @classmethod
    def from_dict(cls, d: dict) -> "Histogram":
        """Rebuild from :meth:`to_dict` output (the cross-process scrape
        wire format)."""
        h = cls(bounds=d["bounds"])
        h.counts = list(d["counts"])
        h.count = int(d["count"])
        h.sum = float(d["sum"])
        h.min, h.max = d.get("min"), d.get("max")
        return h


class TraceRecorder:
    """Thread-safe span ring buffer + counter/gauge registry.

    One process-global instance (``get_recorder()``) backs the module-
    level ``span()``/``counter_add()`` helpers the framework instruments
    with; independent instances are constructible for tests and for
    merging other processes' scraped traces."""

    def __init__(self, capacity: Optional[int] = None,
                 sample: Optional[int] = None,
                 pid: Optional[int] = None, host: Optional[str] = None):
        if capacity is None:
            capacity = max(int(const.ENV.ADT_TRACE_BUFFER.val), 1)
        self.capacity = capacity
        self.sample = max(int(sample if sample is not None
                              else const.ENV.ADT_TRACE_SAMPLE.val), 1)
        self.pid = os.getpid() if pid is None else int(pid)
        import socket
        self.host = host if host is not None else socket.gethostname()
        self._events: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        # wall-clock anchor for the monotonic span timestamps:
        # perf_counter_ns has an ARBITRARY per-process origin, so traces
        # from different hosts/processes can only merge onto one timeline
        # after re-basing onto the wall clock (export adds this offset)
        self.epoch_offset_ns = time.time_ns() - time.perf_counter_ns()
        # cross-host correction on TOP of the wall clock: hosts disagree
        # by ms (NTP) to seconds (unsynced fleets), the same order as a
        # training step. telemetry/cluster.py's NTP-style handshake fills
        # these in (offset ADDS local→reference; error is the ± bound the
        # estimator reports), and export applies them so a merged scrape
        # is step-aligned across workers.
        self.clock_offset_ns = 0
        self.clock_error_ns: Optional[int] = None
        self._counters: Dict[str, float] = dict.fromkeys(DEFAULT_COUNTERS,
                                                         0.0)
        self._gauges: Dict[str, float] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._ids = itertools.count(1)
        self._sample_tick = itertools.count()
        self._publish_seq = itertools.count(1)  # telemetry blob versions
        self._appended = 0
        self._tls = threading.local()
        # small-int thread ids with names, for readable trace tracks
        self._threads: Dict[int, int] = {}
        self._thread_names: Dict[int, str] = {}

    # ------------------------------------------------------------- plumbing

    def _span_stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._threads.get(ident)
        if tid is None:
            with self._lock:
                tid = self._threads.setdefault(ident, len(self._threads))
                self._thread_names[tid] = threading.current_thread().name
        return tid

    def _append(self, event: SpanEvent):
        # deque.append with maxlen is atomic (GIL) — no lock for the ring
        # itself; the appended tally is a read-modify-write shared with
        # background threads (async checkpoint writer, PS apply loop), so
        # it takes the registry lock (span exits are µs-scale relative to
        # the work they time — contention is noise)
        self._events.append(event)
        with self._lock:
            self._appended += 1

    # ------------------------------------------------------------ span API

    def span(self, name: str, cat: str = "app", **args):
        """Context manager timing a nested span. Honors the recorder's
        sampling stride; returns a shared no-op when sampled out."""
        if self.sample > 1 and next(self._sample_tick) % self.sample:
            return _NOOP
        return _Span(self, name, cat, args or None)

    def instant(self, name: str, cat: str = "app", **args):
        """Zero-duration marker event (state flips, drops, retries).
        NEVER sampled out: instants mark rare diagnostic events (breaker
        opens, degraded pulls, dropped tails) — exactly what a sampled
        production trace must not lose; only hot-path spans pay the
        stride."""
        self._append(SpanEvent(name, cat, time.perf_counter_ns(), 0,
                               self._tid(), next(self._ids),
                               (self._span_stack() or [0])[-1],
                               args or None))

    def current_span_id(self) -> int:
        """Innermost live span id on this thread (0 = none)."""
        stack = getattr(self._tls, "stack", None)
        return stack[-1] if stack else 0

    # ---------------------------------------------------------- registries

    def counter_add(self, name: str, value: float = 1.0):
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def gauge_set(self, name: str, value: float):
        with self._lock:
            self._gauges[name] = float(value)

    def hist_observe(self, name: str, value: float, bounds=None):
        """Record one observation into the named histogram (created with
        log-spaced default bounds — or ``bounds`` — on first use)."""
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(bounds)
            h.observe(value)

    def hist_quantile(self, name: str, q: float) -> Optional[float]:
        """Approximate q-quantile of a histogram (None when absent or
        empty) — the p50/p99 readout serving SLOs watch."""
        with self._lock:
            h = self._histograms.get(name)
            return h.quantile(q) if h is not None else None

    def counters(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._counters)

    def gauges(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._gauges)

    def histograms(self) -> Dict[str, dict]:
        """Snapshot of every histogram as a plain dict (bounds, counts,
        count, sum, min/max, p50/p99)."""
        with self._lock:
            return {n: h.to_dict() for n, h in self._histograms.items()}

    # ------------------------------------------------------------ snapshots

    def events(self) -> List[SpanEvent]:
        return list(self._events)

    @property
    def dropped_events(self) -> int:
        """Spans lost to ring-buffer wraparound."""
        return max(0, self._appended - len(self._events))

    def thread_names(self) -> Dict[int, str]:
        with self._lock:
            return dict(self._thread_names)

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-span-name aggregate: count, total/mean/max seconds."""
        out: Dict[str, Dict[str, float]] = {}
        for e in self.events():
            row = out.setdefault(e.name, {"cat": e.cat, "count": 0,
                                          "total_s": 0.0, "max_s": 0.0})
            row["count"] += 1
            row["total_s"] += e.dur_ns / 1e9
            row["max_s"] = max(row["max_s"], e.dur_ns / 1e9)
        for row in out.values():
            row["mean_s"] = row["total_s"] / max(row["count"], 1)
        return out

    def durations_s(self, name: str) -> List[float]:
        """All recorded durations (seconds) of spans named ``name`` —
        the drift report's measured-time input."""
        return [e.dur_ns / 1e9 for e in self.events() if e.name == name]

    def clear(self):
        with self._lock:
            self._events.clear()
            self._appended = 0
            self._counters = dict.fromkeys(DEFAULT_COUNTERS, 0.0)
            self._gauges.clear()
            self._histograms.clear()


# ------------------------------------------------------- module-level state
#
# The module-level helpers are what the framework calls on hot paths, so
# the enabled/disabled decision must be ONE attribute check. `_TRACING`
# caches the parsed ADT_TRACE mode; configure() overrides it at runtime
# (tests, bench) and refresh_from_env() re-reads the environment.

_recorder: Optional[TraceRecorder] = None
_recorder_lock = threading.Lock()
_TRACING = False          # spans recorded at all
_SAMPLED = False          # spans recorded 1/N
# explicit configure() choice: (mode, sample) — survives reset(), wins
# over the env. None = env-driven. Without this, every helper that calls
# autodist_tpu_torch.reset() (test fixtures, sequential programmatic builds)
# would silently revert a configure("1") to the env default and the
# traced run would come back empty.
_OVERRIDE: Optional[tuple] = None


def _parse_mode(raw: str):
    mode = (raw or "0").strip().lower()
    if mode in ("0", "", "off", "false"):
        return False, False
    if mode in ("sampled", "sample"):
        return True, True
    return True, False  # "1"/"on"/anything truthy: record every span


def _sync_mode():
    """Re-derive mode + the live recorder's sampling stride from ONE
    source (the configure() override when set, else the env) — a stale
    stride after a mode change silently drops (or over-records) spans
    while ``tracing_enabled()`` claims otherwise."""
    global _TRACING, _SAMPLED
    mode, sample = (_OVERRIDE if _OVERRIDE is not None
                    else (const.ENV.ADT_TRACE.val, None))
    _TRACING, _SAMPLED = _parse_mode(mode)
    rec = _recorder
    if rec is not None:
        if not _SAMPLED:
            rec.sample = 1
        else:
            rec.sample = max(int(sample if sample is not None
                                 else const.ENV.ADT_TRACE_SAMPLE.val), 1)


def refresh_from_env():
    """Re-derive the tracing mode (tests set env vars mid-process); an
    explicit :func:`configure` override keeps winning until
    ``configure(None)`` clears it."""
    _sync_mode()


refresh_from_env()


def configure(mode: Optional[str], capacity: Optional[int] = None,
              sample: Optional[int] = None) -> TraceRecorder:
    """Set the tracing mode programmatically ("0" | "1" | "sampled") and
    (optionally) rebuild the global recorder with a new capacity/stride.
    The choice is STICKY: it survives ``reset()`` /
    ``autodist_tpu_torch.reset()`` (which otherwise re-reads ``ADT_TRACE``);
    ``configure(None)`` returns control to the env. Returns the active
    recorder."""
    global _OVERRIDE, _recorder
    _OVERRIDE = None if mode is None else (mode, sample)
    with _recorder_lock:
        if capacity is not None or sample is not None or _recorder is None:
            _recorder = TraceRecorder(capacity=capacity, sample=sample)
    _sync_mode()
    return _recorder


def get_recorder() -> TraceRecorder:
    """The process-global recorder (created on first use)."""
    global _recorder
    if _recorder is None:
        with _recorder_lock:
            if _recorder is None:
                _recorder = TraceRecorder()
        _sync_mode()  # stride follows the active mode, not the env default
    return _recorder


def tracing_enabled() -> bool:
    return _TRACING


def span(name: str, cat: str = "app", **args):
    """Module-level span helper — THE instrumented-code entry point.
    Disabled mode returns a shared no-op after one flag check."""
    if not _TRACING:
        return _NOOP
    return get_recorder().span(name, cat, **args)


def instant(name: str, cat: str = "app", **args):
    if not _TRACING:
        return
    get_recorder().instant(name, cat, **args)


# a thread inside muted() sets no counter and no gauge
_MUTE = threading.local()


@contextlib.contextmanager
def muted():
    """The calling thread's counters and gauges stay as they are in the
    body (a costed trace, which moves nothing, runs the instrumented
    collectives)."""
    was = getattr(_MUTE, "on", False)
    _MUTE.on = True
    try:
        yield
    finally:
        _MUTE.on = was


def counter_add(name: str, value: float = 1.0):
    """Always-on registry increment (works with tracing disabled)."""
    if not getattr(_MUTE, "on", False):
        get_recorder().counter_add(name, value)


def gauge_set(name: str, value: float):
    if not getattr(_MUTE, "on", False):
        get_recorder().gauge_set(name, value)


def hist_observe(name: str, value: float, bounds=None):
    """Always-on histogram observation (works with tracing disabled) —
    the latency-distribution companion to :func:`counter_add`."""
    get_recorder().hist_observe(name, value, bounds=bounds)


def hist_quantile(name: str, q: float) -> Optional[float]:
    return get_recorder().hist_quantile(name, q)


def histograms() -> Dict[str, dict]:
    return get_recorder().histograms()


def counters() -> Dict[str, float]:
    return get_recorder().counters()


def gauges() -> Dict[str, float]:
    return get_recorder().gauges()


def current_span_id() -> int:
    rec = _recorder
    return rec.current_span_id() if rec is not None else 0


def reset():
    """Drop all recorded state (test isolation — wired into
    ``autodist_tpu_torch.reset()``). The MODE is re-derived, not dropped: an
    explicit ``configure()`` override survives (so a traced programmatic
    session keeps tracing across builds); env-driven mode re-reads
    ``ADT_TRACE``."""
    rec = _recorder
    if rec is not None:
        rec.clear()
    _sync_mode()
