"""MicroBatcher — the request queue in front of the InferenceEngine
(PyTorch counterpart of ``autodist_tpu/serving/batcher.py``).

Concurrent callers :meth:`submit` single-example requests and get
futures; one worker thread accumulates requests into groups — up to the
engine's largest bucket, or until the FIRST request of the group has
waited ``max_delay_ms`` — runs each group as one padded bucketed
dispatch, and fans the fetches back out row-per-request. That deadline
is the serving tier's core latency/throughput trade: a lone request
waits at most ``max_delay_ms`` for company; a burst fills a bucket
immediately and amortizes one program dispatch over the whole group.

Failure behavior is SHED, NEVER HANG: a full queue rejects the submit
with :class:`ServingUnavailable`; an exhausted PS-degradation window
fails the GROUP's futures with the engine's typed error and the worker
keeps serving (the next snapshot refresh may succeed — e.g. after the
circuit breaker's cooldown). Every shed carries a populated
``retry_after_s``: queue-full sheds compute it from the measured drain
rate (an EWMA over recent group service times — the honest answer to
"when will there be room"), drain/close sheds carry the operator knob
``ADT_DRAIN_RETRY_AFTER_S``. Requests may carry a per-request
``deadline_s``: one that would already be expired when its group
dispatches is shed immediately instead of consuming a dispatch slot on
an answer nobody is waiting for. Under SUSTAINED overload (queue near
``max_queue`` for ``brownout_sustain_s``) the batcher enters
**brownout**: the group deadline widens by ``brownout_delay_factor`` so
dispatches run at full buckets — maximum throughput at bounded p99 —
until the backlog recedes. Every request is accounted: ``serve.
requests/batches/shed/deadline_shed/brownouts/degraded/padded_rows``
counters, the ``serve.queue_depth`` gauge, and the ``serve.latency_ms``
histogram (submit -> fan-out) feeding the p50/p99 readout in
:meth:`stats`.

At N > 1 ranks the batcher is the chief's (rank 0): its queue, grouping
and brownout decide every dispatch, which the engine broadcasts to its
followers (``serving/plane.py``). A follower's batcher takes no request
(:meth:`submit` raises) and runs no worker; its engine's loop serves the
chief's groups. The chief's :meth:`drain` (a planned departure) also ends
the followers' loops.
"""
import queue
import threading
import time
import weakref
from concurrent.futures import Future
from typing import Optional

from autodist_tpu_torch import const
from autodist_tpu_torch.serving.engine import (InferenceEngine,
                                               ServingUnavailable)
from autodist_tpu_torch.telemetry import spans as tel
from autodist_tpu_torch.utils import logging

_SENTINEL = object()

# every live batcher, so the preemption plane can drain a departing
# process's whole serving tier without threading references through it
_ACTIVE: "weakref.WeakSet" = weakref.WeakSet()


def active_batchers() -> list:
    """The process's live micro-batchers (drained on planned departure
    by ``runtime/preemption.py``)."""
    return list(_ACTIVE)


class _Pending:
    __slots__ = ("example", "future", "t0", "deadline")

    def __init__(self, example, deadline_s: Optional[float] = None):
        self.example = example
        self.future = Future()
        self.t0 = time.perf_counter()
        # absolute expiry on the worker clock (None = no deadline)
        self.deadline = (self.t0 + deadline_s
                         if deadline_s is not None else None)


# clamp on every computed Retry-After: never tell a client to hammer
# back in microseconds, never park it for longer than any drain window
_RETRY_AFTER_MIN_S = 0.05
_RETRY_AFTER_MAX_S = 60.0
# EWMA smoothing for the measured drain rate (requests/s)
_DRAIN_RATE_ALPHA = 0.3


class MicroBatcher:
    """Queue + worker thread over an :class:`InferenceEngine`.

    Context-manager friendly::

        with MicroBatcher(engine) as mb:
            futures = [mb.submit(req) for req in requests]
            results = [f.result() for f in futures]
    """

    def __init__(self, engine: InferenceEngine,
                 max_delay_ms: Optional[float] = None,
                 max_queue: Optional[int] = None):
        self._engine = engine
        cfg = engine.config
        self.max_delay_s = (cfg.max_delay_ms if max_delay_ms is None
                            else max_delay_ms) / 1e3
        self.max_queue = (cfg.max_queue if max_queue is None
                          else int(max_queue))
        self.max_batch = engine.max_batch
        self._queue: "queue.Queue" = queue.Queue()
        self._closed = False
        # serializes submit's closed-check-then-put against close's
        # closed-set-then-drain: without it a submit could enqueue AFTER
        # the drain and its future would hang forever — the one thing
        # this module promises never happens
        self._submit_lock = threading.Lock()
        self.stats_local = {"requests": 0, "batches": 0, "shed": 0,
                            "errors": 0, "fan_out": 0, "drained": 0,
                            "deadline_shed": 0}
        # set while draining/closed: the Retry-After attached to every
        # typed shed past that point
        self._retry_after: Optional[float] = None
        # measured drain rate (requests/s EWMA over group service times);
        # None until the first group completes — the honest source of the
        # queue-full Retry-After
        self._drain_rate: Optional[float] = None
        # brownout: sustained near-full queue widens the group deadline
        # so dispatches run at full buckets (throughput over p50)
        self._brownout = False
        self._brownout_entries = 0
        self._overload_since: Optional[float] = None
        self._effective_delay_s = self.max_delay_s
        # at N > 1 a follower's batcher queues nothing: its engine's loop
        # serves the chief's groups
        self.chief = engine.chief
        self._worker = threading.Thread(target=self._run,
                                        name="adt-serve-batcher",
                                        daemon=True)
        if self.chief:
            self._worker.start()
        _ACTIVE.add(self)

    # ------------------------------------------------------------- submit

    def submit(self, example, deadline_s: Optional[float] = None) -> Future:
        """Enqueue one single-example request; resolves to its fetch tree
        (row of every batch-dim leaf). Sheds with
        :class:`ServingUnavailable` when the queue is full or the
        batcher is closed — backpressure is synchronous and typed, and
        every shed carries a populated ``retry_after_s`` (measured
        drain-rate estimate on queue-full, the drain knob when
        closed/draining) so an overloaded tier fails fast with an honest
        back-off hint instead of buffering unboundedly. ``deadline_s``
        (optional, seconds from now) arms a per-request deadline: if the
        request would already be expired when its group dispatches, it
        is shed then instead of consuming a dispatch slot. At N > 1 only
        the chief's batcher takes requests."""
        if not self.chief:
            raise ValueError(
                "submit on a follower's micro-batcher: at N > 1 the chief "
                "(rank 0) takes the requests and its engine runs each group "
                "on every rank")
        with tel.span("serve.enqueue", "serve"), self._submit_lock:
            if self._closed:
                retry = (const.ENV.ADT_DRAIN_RETRY_AFTER_S.val
                         if self._retry_after is None else self._retry_after)
                raise ServingUnavailable(
                    "micro-batcher is %s (Retry-After %.1fs)"
                    % ("draining" if self._retry_after is not None
                       else "closed", retry),
                    retry_after_s=retry)
            depth = self._queue.qsize()
            if depth >= self.max_queue:
                retry = self._computed_retry_after(depth)
                self.stats_local["shed"] += 1
                tel.counter_add("serve.shed")
                raise ServingUnavailable(
                    "serving queue full (%d pending) — shedding "
                    "(Retry-After %.2fs)" % (self.max_queue, retry),
                    retry_after_s=retry)
            self._maybe_brownout(depth)
            pending = _Pending(example, deadline_s)
            self._queue.put(pending)
            self.stats_local["requests"] += 1
            tel.counter_add("serve.requests")
            tel.gauge_set("serve.queue_depth", self._queue.qsize())
        return pending.future

    def queue_depth(self) -> int:
        """Currently queued (not yet grouped) requests — the live signal
        behind the ``serve.queue_depth`` gauge."""
        return self._queue.qsize()

    def oldest_queue_age_s(self) -> Optional[float]:
        """Age of the OLDEST still-queued request (None when empty) —
        the head-of-line wait a newly shed caller is implicitly being
        quoted on top of the drain-rate backlog estimate."""
        with self._queue.mutex:
            head = next((p for p in self._queue.queue
                         if p is not _SENTINEL), None)
        if head is None:
            return None
        return max(0.0, time.perf_counter() - head.t0)

    def _computed_retry_after(self, depth: int) -> float:
        """Retry-After from the MEASURED drain rate: the current backlog
        over the smoothed requests/s the worker is actually clearing,
        clamped to a sane band. Before any group has completed there is
        no measurement — fall back to the operator knob rather than
        invent a number. The oldest queued request's age FLOORS the
        estimate: a head-of-line request that has already waited T
        seconds proves the tier is clearing slower than the EWMA claims
        (e.g. the worker is parked inside a long dispatch), so the hint
        must not promise anything sooner."""
        rate = self._drain_rate
        if not rate or rate <= 0:
            base = const.ENV.ADT_DRAIN_RETRY_AFTER_S.val
        else:
            base = depth / rate
        oldest = self.oldest_queue_age_s()
        if oldest is not None:
            base = max(base, oldest)
        return min(max(base, _RETRY_AFTER_MIN_S), _RETRY_AFTER_MAX_S)

    def _maybe_brownout(self, depth: int):
        """Brownout state machine, driven from BOTH submit and the
        worker loop (the worker may be parked inside a long dispatch, so
        admission must be able to flip the state without it). Enter when
        the queue has sat above ``brownout_queue_frac * max_queue`` for
        ``brownout_sustain_s``; exit at half the entry threshold —
        hysteresis, so a backlog hovering at the line does not strobe
        the group deadline."""
        cfg = self._engine.config
        factor = cfg.brownout_delay_factor
        if factor <= 1.0:
            return
        high = cfg.brownout_queue_frac * self.max_queue
        now = time.perf_counter()
        if not self._brownout:
            if depth >= high:
                if self._overload_since is None:
                    self._overload_since = now
                elif (now - self._overload_since
                      >= cfg.brownout_sustain_s):
                    self._brownout = True
                    self._brownout_entries += 1
                    self._effective_delay_s = self.max_delay_s * factor
                    tel.counter_add("serve.brownouts")
                    tel.gauge_set("serve.brownout", 1)
                    tel.instant("serve.brownout", "serve", depth=depth,
                                delay_ms=self._effective_delay_s * 1e3)
                    logging.warning(
                        "serving: entering brownout — queue %d/%d "
                        "sustained; widening group deadline to %.1fms "
                        "for full-bucket dispatches", depth,
                        self.max_queue, self._effective_delay_s * 1e3)
            else:
                self._overload_since = None
        elif depth <= high / 2:
            self._brownout = False
            self._overload_since = None
            self._effective_delay_s = self.max_delay_s
            tel.gauge_set("serve.brownout", 0)
            tel.instant("serve.brownout_exit", "serve", depth=depth)
            logging.warning("serving: exiting brownout — queue depth %d "
                            "receded; restoring %.1fms group deadline",
                            depth, self.max_delay_s * 1e3)

    def predict_one(self, example, timeout: Optional[float] = None):
        """Blocking convenience: ``submit(example).result(timeout)``."""
        return self.submit(example).result(timeout=timeout)

    # ------------------------------------------------------------- worker

    def _next_group(self):
        """One request group: the first request opens the group and its
        enqueue time starts the ``max_delay_ms`` deadline; the group
        closes at the deadline, at ``max_batch``, or on shutdown.
        Returns (group, saw_sentinel) — group may be empty."""
        # blocking get: shutdown is signalled in-band (close() posts the
        # sentinel), so an idle worker parks instead of polling
        first = self._queue.get()
        if first is _SENTINEL:
            return [], True
        group = [first]
        # _effective_delay_s, not max_delay_s: under brownout the group
        # deadline is widened so dispatches run at full buckets
        deadline = first.t0 + self._effective_delay_s
        while len(group) < self.max_batch:
            remaining = deadline - time.perf_counter()
            try:
                # past the deadline (e.g. the request queued while the
                # worker served the previous batch), still DRAIN whatever
                # is already waiting — a backlog must coalesce into full
                # buckets, not serialize as size-1 batches
                item = (self._queue.get(timeout=remaining)
                        if remaining > 0 else self._queue.get_nowait())
            except queue.Empty:
                break
            if item is _SENTINEL:
                return group, True
            group.append(item)
        return group, False

    def _run(self):
        while True:
            group, stop = self._next_group()
            if group:
                with tel.span("serve.batch", "serve", n=len(group)):
                    self._serve_group(group)
            # gauge updated UNCONDITIONALLY after every wakeup — a gauge
            # written only on submit reads stale-high forever once
            # traffic stops, and an empty group is exactly the moment
            # the queue went quiet
            depth = self._queue.qsize()
            tel.gauge_set("serve.queue_depth", depth)
            with self._submit_lock:
                self._maybe_brownout(depth)
            if stop:
                break

    def _serve_group(self, group):
        # queue-wait bucket of the per-request goodput decomposition:
        # submit → group start, per request (the other two buckets —
        # dispatch and readback — are observed inside the engine)
        t_start = time.perf_counter()
        # deadline sweep BEFORE the dispatch: a request whose deadline
        # already passed in queue gets an immediate typed shed instead
        # of burning a padded dispatch row on an answer nobody waits for
        expired = [p for p in group
                   if p.deadline is not None and t_start > p.deadline]
        if expired:
            retry = self._computed_retry_after(self._queue.qsize())
            exc = ServingUnavailable(
                "request deadline expired in queue — shedding "
                "(Retry-After %.2fs)" % retry, retry_after_s=retry)
            dead = set(map(id, expired))
            group = [p for p in group if id(p) not in dead]
            self.stats_local["shed"] += len(expired)
            self.stats_local["deadline_shed"] += len(expired)
            tel.counter_add("serve.shed", len(expired))
            tel.counter_add("serve.deadline_shed", len(expired))
            tel.instant("serve.deadline_shed", "serve", n=len(expired))
            for p in expired:
                p.future.set_exception(exc)
            if not group:
                return
        for p in group:
            tel.hist_observe("serve.queue_ms", (t_start - p.t0) * 1e3)
        try:
            fetched, n = self._engine.run_batch(
                [p.example for p in group])
        except ServingUnavailable as e:
            # typed shed: fail THIS group, keep serving — the engine
            # retries its snapshot refresh on the next batch
            self.stats_local["shed"] += len(group)
            tel.counter_add("serve.shed", len(group))
            for p in group:
                p.future.set_exception(e)
            return
        except Exception as e:  # noqa: BLE001 — one bad request (shape
            # mismatch, dtype) must not kill the worker loop for every
            # future caller; the group's futures carry the real error
            self.stats_local["errors"] += len(group)
            logging.warning("serving batch failed: %s", e)
            for p in group:
                p.future.set_exception(e)
            return
        self.stats_local["batches"] += 1
        self.stats_local["fan_out"] += n
        now = time.perf_counter()
        # drain-rate EWMA (requests/s actually cleared): the measured
        # basis for the queue-full Retry-After
        elapsed = now - t_start
        if elapsed > 0:
            rate = len(group) / elapsed
            self._drain_rate = (rate if self._drain_rate is None else
                                _DRAIN_RATE_ALPHA * rate
                                + (1 - _DRAIN_RATE_ALPHA)
                                * self._drain_rate)
        for p, row in zip(group, self._engine.fan_out(fetched, n)):
            tel.hist_observe("serve.latency_ms", (now - p.t0) * 1e3)
            p.future.set_result(row)

    # -------------------------------------------------------------- stats

    def stats(self) -> dict:
        """Serving accounting for THIS batcher plus the engine's
        snapshot/padding stats and the process-wide latency percentiles
        (stable keys; percentiles are None before any request)."""
        # engine stats first, then this batcher's — both carry a
        # "batches" key, and the batcher's group count must win (the
        # engine's also counts warmup dispatches and other callers)
        out = dict(self._engine.stats)
        out.update(self.stats_local)
        from autodist_tpu_torch.serving import autoscale as autoscale_lib
        out.update(
            queue_depth=self._queue.qsize(),
            oldest_queue_age_s=self.oldest_queue_age_s(),
            drain_rate_rps=self._drain_rate,
            brownout={"active": self._brownout,
                      "entries": self._brownout_entries},
            # process-wide controller accounting from the pre-registered
            # counters — stable keys even with no autoscaler running
            autoscale=autoscale_lib.stats_snapshot(),
            buckets=list(self._engine.buckets),
            recompiles_after_warmup=self._engine.recompiles_after_warmup(),
            p50_ms=tel.hist_quantile("serve.latency_ms", 0.50),
            p99_ms=tel.hist_quantile("serve.latency_ms", 0.99),
            # per-request goodput buckets: where a request's latency
            # went — queue wait vs program dispatch vs D2H readback
            # (p50s; the full distributions ride the registry
            # histograms / metrics_text)
            goodput={
                "queue_p50_ms": tel.hist_quantile("serve.queue_ms", 0.50),
                "queue_p99_ms": tel.hist_quantile("serve.queue_ms", 0.99),
                "dispatch_p50_ms": tel.hist_quantile("serve.dispatch_ms",
                                                     0.50),
                "readback_p50_ms": tel.hist_quantile("serve.readback_ms",
                                                     0.50),
            },
        )
        return out

    # ------------------------------------------------------------ shutdown

    def drain(self, retry_after_s: Optional[float] = None,
              timeout: float = 30.0) -> int:
        """Planned-departure drain: stop admitting (subsequent submits
        shed with the typed Retry-After), let the IN-FLIGHT group finish
        and resolve its futures, and shed everything still queued —
        typed, with ``retry_after_s`` (default ``ADT_DRAIN_RETRY_AFTER_S``)
        so callers route to another replica instead of hammering the
        leaver. Counts ``serve.drained`` (in-flight requests completed
        during the drain) and ``serve.shed`` (queued requests rejected).
        Returns the shed count. Idempotent; a drained batcher is
        closed. At N > 1 the chief's drain then stops its engine's
        followers (the replica departs); a follower's has nothing queued
        (0)."""
        retry = (const.ENV.ADT_DRAIN_RETRY_AFTER_S.val
                 if retry_after_s is None else float(retry_after_s))
        with self._submit_lock:
            if self._closed:
                return 0
            self._closed = True
            self._retry_after = retry
        if not self.chief:
            return 0
        # shed the QUEUE first (before the sentinel): whatever the worker
        # already took is in-flight and completes; whatever still sits in
        # the queue is work a healthier replica should take
        shed_exc = ServingUnavailable(
            "serving replica draining for departure — retry elsewhere "
            "(Retry-After %.1fs)" % retry, retry_after_s=retry)
        shed = 0
        requeue = []
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is _SENTINEL:
                requeue.append(item)  # a concurrent close posted it
                continue
            if not item.future.done():
                item.future.set_exception(shed_exc)
                shed += 1
        for item in requeue:
            self._queue.put(item)
        tel.gauge_set("serve.queue_depth", self._queue.qsize())
        fan0 = self.stats_local["fan_out"]
        self._queue.put(_SENTINEL)
        self._worker.join(timeout=timeout)
        # a submit that raced the closed-flag flip cannot exist (the flip
        # holds the submit lock), but the worker may have been mid-group:
        # those futures resolved above the fan-out counter
        drained = self.stats_local["fan_out"] - fan0
        self.stats_local["shed"] += shed
        self.stats_local["drained"] += drained
        if shed:
            tel.counter_add("serve.shed", shed)
        tel.counter_add("serve.drained", drained)
        tel.instant("serve.drained", "serve", shed=shed, drained=drained,
                    retry_after_s=retry)
        logging.warning(
            "serving: drained micro-batcher — %d in-flight request(s) "
            "completed, %d queued shed with Retry-After %.1fs",
            drained, shed, retry)
        if self._worker.is_alive():
            self._queue.put(_SENTINEL)  # join timed out mid-group
        self._engine.close()
        return shed

    def close(self, timeout: float = 30.0):
        """Stop accepting, drain the worker, and fail any still-queued
        requests with a typed shed (a silent dropped future would hang
        its caller forever). Idempotent. The engine stays up (its owner
        closes it)."""
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
        if not self.chief:
            return
        # past this point no submit can enqueue (closed-check holds the
        # same lock), so the drain below cannot race a late put
        self._queue.put(_SENTINEL)
        self._worker.join(timeout=timeout)
        # even a plain close carries a Retry-After: the caller's retry
        # loop should back off the same way it would for a drain, not
        # special-case a None hint
        shed = ServingUnavailable(
            "micro-batcher closed while queued",
            retry_after_s=const.ENV.ADT_DRAIN_RETRY_AFTER_S.val)
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not _SENTINEL and not item.future.done():
                self.stats_local["shed"] += 1
                tel.counter_add("serve.shed")
                item.future.set_exception(shed)
        tel.gauge_set("serve.queue_depth", self._queue.qsize())
        if self._worker.is_alive():
            # join timed out mid-group and the drain may have eaten the
            # sentinel — re-post it so the worker exits instead of
            # spinning on an empty queue forever
            self._queue.put(_SENTINEL)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False
