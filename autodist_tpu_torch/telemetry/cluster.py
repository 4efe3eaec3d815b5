"""Cluster-correlated tracing: clock-offset handshake + fleet profiling
(PyTorch counterpart of ``autodist_tpu/telemetry/cluster.py``, over the
port's coordination service; the fleet window captures a
``torch.profiler`` trace where the JAX runner captures a
``jax.profiler`` one).

Per-process traces re-base onto each host's wall clock at export
(``spans.TraceRecorder.epoch_offset_ns``), but wall clocks on different
hosts disagree — typically by milliseconds under NTP, by *seconds* on a
mis-configured fleet — which is the same order as a training step, so a
merged timeline without correction shows step N on worker A overlapping
step N+3 on worker B. This module closes that gap with the plumbing the
cluster already has (the coordination service; no new server):

- **Clock-offset handshake** (:func:`estimate_clock_offset`): an
  NTP-style multi-round exchange against a reference process (the chief,
  running a :class:`ClockSyncResponder`). Each round the worker enqueues
  a request stamped with its local send time, the responder answers with
  its own wall time, and the worker computes ``offset = t_ref - (t0 +
  t1)/2`` with error bound ``rtt/2``. The **minimum-RTT round wins** —
  queueing jitter and control-plane blips (exactly what the fault proxy
  injects in tests) inflate RTT, and the min-RTT filter discards them.
  The result is stored on the recorder (``clock_offset_ns`` /
  ``clock_error_ns``); ``export.chrome_trace`` adds the offset so every
  published trace is already in reference-clock time and
  ``merge_traces`` produces ONE step-aligned timeline.

- **Fleet-coordinated profiling** (:func:`request_profile` /
  :func:`read_profile_window`): a coordination-service KV flag
  ("profile steps N..M") every Runner polls (``ADT_PROFILE_POLL_S``).
  When a window lands, every worker captures a ``torch.profiler`` trace
  for the SAME step interval (the generalization of the first-step
  ``tracing=True`` hook in ``runtime/runner.py``), written under the
  trace dir next to the merged telemetry trace. ``ADT_PROFILE_STEPS=N:M``
  arms the same machinery locally without a service.

- **Step alignment** (:func:`step_alignment`): reads a merged trace's
  per-step ``runner.dispatch`` spans (the ``step`` arg every dispatch
  and barrier span now carries) and reports the cross-worker start-time
  spread per step — the skew figure a multi-process check asserts on.
"""
import dataclasses
import time
import uuid
from typing import Dict, Optional

from autodist_tpu_torch import const
from autodist_tpu_torch.telemetry import spans as spans_lib
from autodist_tpu_torch.utils import logging

CLOCKSYNC_QUEUE = "clocksync"
CLOCKSYNC_RESP = "clocksync-resp/%s"
PROFILE_KEY = "profile/window"


# ----------------------------------------------------------- clock offset


@dataclasses.dataclass
class ClockOffset:
    """One worker's estimated wall-clock offset against the reference.
    ``offset_ns`` ADDS to local wall time to yield reference time;
    ``error_ns`` is the ± bound (half the winning round's RTT)."""

    offset_ns: int
    error_ns: int
    rtt_ns: int
    rounds: int

    def to_dict(self) -> dict:
        return {"offset_ns": int(self.offset_ns),
                "error_ns": int(self.error_ns),
                "rtt_ns": int(self.rtt_ns), "rounds": int(self.rounds)}

    @classmethod
    def from_dict(cls, d: dict) -> "ClockOffset":
        return cls(offset_ns=int(d.get("offset_ns", 0)),
                   error_ns=int(d.get("error_ns", 0)),
                   rtt_ns=int(d.get("rtt_ns", 0)),
                   rounds=int(d.get("rounds", 0)))


class ClockSyncResponder:
    """Reference-side half of the handshake (run on the chief): drains
    the ``clocksync`` request queue and answers each request with the
    reference wall clock. One responder serves every worker — requests
    carry the worker name, so the responder needs no roster.

    Runs on a daemon thread; ``stop()`` is idempotent. ``clock`` is
    injectable for tests (simulated reference skew)."""

    def __init__(self, client, poll_s: float = 0.002, clock=time.time_ns):
        self._client = client
        self._poll_s = poll_s
        self._clock = clock
        self._stop = None
        self._thread = None
        self.answered = 0

    def start(self) -> "ClockSyncResponder":
        import threading
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="adt-clocksync", daemon=True)
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.is_set():
            if not self.answer_once():
                self._stop.wait(self._poll_s)

    def answer_once(self) -> bool:
        """Drain and answer one queued request (returns False when the
        queue was empty) — the loop body, callable directly from tests
        and single-threaded drivers."""
        try:
            blob = self._client.qpop(CLOCKSYNC_QUEUE)
        except OSError:
            return False  # service blip: the estimator's round times out
        if blob is None:
            return False
        try:
            worker, nonce, _t_send = blob.decode().split(" ", 2)
        except ValueError:
            return False  # malformed request: drop it
        try:
            self._client.put(CLOCKSYNC_RESP % worker,
                             "%s %d" % (nonce, self._clock()))
        except OSError:
            return False
        self.answered += 1
        return True

    def stop(self):
        if self._stop is not None:
            self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def estimate_clock_offset(client, worker: str,
                          rounds: Optional[int] = None,
                          round_timeout_s: float = 2.0,
                          clock=time.time_ns) -> ClockOffset:
    """Worker-side handshake: ``rounds`` request/response exchanges
    against the chief's :class:`ClockSyncResponder`; the minimum-RTT
    round's offset wins (error bound = its RTT/2). Rounds that time out
    (fault-injected delays, a wedged responder) are simply skipped —
    at least one round must complete or ``TimeoutError`` raises.

    ``clock`` is this worker's wall-clock source (``time.time_ns``);
    injectable so tests can simulate host skew without touching the
    system clock."""
    n = rounds if rounds is not None else max(
        int(const.ENV.ADT_CLOCKSYNC_ROUNDS.val), 1)
    token = uuid.uuid4().hex[:8]
    samples = []
    for i in range(n):
        nonce = "%s-%d" % (token, i)
        t0 = clock()
        try:
            client.qpush(CLOCKSYNC_QUEUE,
                         ("%s %s %d" % (worker, nonce, t0)).encode())
        except OSError:
            continue  # transport blip: this round is lost, not the sync
        deadline = time.monotonic() + round_timeout_s
        while time.monotonic() < deadline:
            try:
                val = client.get(CLOCKSYNC_RESP % worker)
            except OSError:
                break
            if val:
                got_nonce, _, ref_raw = val.partition(" ")
                if got_nonce == nonce:
                    t1 = clock()
                    rtt = max(int(t1 - t0), 1)
                    offset = int(ref_raw) - (t0 + t1) // 2
                    samples.append((rtt, offset))
                    break
            time.sleep(0.0005)
    if not samples:
        raise TimeoutError(
            "clock-offset handshake: no round completed in %d attempts — "
            "is a ClockSyncResponder running on the chief?" % n)
    rtt, offset = min(samples)
    est = ClockOffset(offset_ns=offset, error_ns=rtt // 2 + 1,
                      rtt_ns=rtt, rounds=len(samples))
    logging.info("clock sync [%s]: offset %+.3f ms ± %.3f ms over %d/%d "
                 "rounds (min rtt %.3f ms)", worker, est.offset_ns / 1e6,
                 est.error_ns / 1e6, est.rounds, n, est.rtt_ns / 1e6)
    return est


def sync_recorder_clock(client, worker: str,
                        recorder: Optional[spans_lib.TraceRecorder] = None,
                        **kwargs) -> ClockOffset:
    """Run the handshake and store the estimate on the recorder, so
    every subsequent export/publish is reference-clock corrected."""
    rec = recorder if recorder is not None else spans_lib.get_recorder()
    est = estimate_clock_offset(client, worker, **kwargs)
    rec.clock_offset_ns = est.offset_ns
    rec.clock_error_ns = est.error_ns
    return est


# -------------------------------------------------------- fleet profiling


def request_profile(client, first_step: int, last_step: int) -> int:
    """Post the fleet profiling flag: every polling Runner captures a
    ``torch.profiler`` trace for steps ``first_step..last_step``
    (inclusive). Returns the window sequence number (monotonic — a new
    request supersedes an old one even for workers that already served
    it)."""
    if last_step < first_step or first_step < 0:
        raise ValueError("profile window %d..%d is empty/negative"
                         % (first_step, last_step))
    seq = client.incr("profile/seq")
    client.put(PROFILE_KEY, "%d %d %d" % (seq, first_step, last_step))
    return seq


def clear_profile(client) -> None:
    """Withdraw the profiling flag (workers that already started a
    window finish it; nobody new arms)."""
    client.put(PROFILE_KEY, "0 -1 -1")


def read_profile_window(client) -> Optional[tuple]:
    """The posted ``(seq, first_step, last_step)``, or None."""
    try:
        val = client.get(PROFILE_KEY)
    except OSError:
        return None
    if not val:
        return None
    try:
        seq, first, last = (int(x) for x in val.split())
    except ValueError:
        return None
    if first < 0 or last < first:
        return None  # cleared ("0 -1 -1") or malformed
    return seq, first, last


def parse_profile_env(raw: str) -> Optional[tuple]:
    """``ADT_PROFILE_STEPS="N:M"`` → ``(first, last)`` or None — the
    serviceless local arm of the same window machinery."""
    raw = (raw or "").strip()
    if not raw:
        return None
    try:
        first, _, last = raw.partition(":")
        window = int(first), int(last or first)
    except ValueError:
        logging.warning("ADT_PROFILE_STEPS=%r is not N:M — ignored", raw)
        return None
    if window[1] < window[0]:
        return None
    return window


# ---------------------------------------------------------- step alignment


def step_alignment(trace: dict, span: str = "runner.dispatch") -> dict:
    """Cross-worker step skew from a MERGED trace: for every global
    ``step`` arg on ``span`` events, the per-pid start timestamps and
    their spread. Returns ``{"steps": {step: {"spread_us": float,
    "starts_us": {pid: ts}}}, "max_spread_us": float, "aligned_steps":
    int}`` — the number a multi-process check asserts against the clock
    estimator's reported error."""
    per_step: Dict[int, Dict[int, float]] = {}
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X" or e.get("name") != span:
            continue
        step = (e.get("args") or {}).get("step")
        if step is None:
            continue
        starts = per_step.setdefault(int(step), {})
        pid = e.get("pid", 0)
        # a worker can dispatch the same step twice after a rollback
        # replay; keep the FIRST occurrence (the aligned one)
        starts.setdefault(pid, float(e["ts"]))
    steps = {}
    max_spread = 0.0
    for step, starts in sorted(per_step.items()):
        spread = (max(starts.values()) - min(starts.values())
                  if len(starts) > 1 else 0.0)
        max_spread = max(max_spread, spread)
        steps[step] = {"spread_us": round(spread, 3), "starts_us": starts}
    return {"steps": steps, "max_spread_us": round(max_spread, 3),
            "aligned_steps": sum(1 for s in steps.values()
                                 if len(s["starts_us"]) > 1)}
