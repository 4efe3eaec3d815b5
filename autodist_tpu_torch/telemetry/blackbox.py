"""Flight recorder — the always-on bounded black box.

PyTorch counterpart of ``autodist_tpu/telemetry/blackbox.py`` (that module
imports nothing of JAX; the port keeps its own copy). A dump either
package writes is read by the other's :func:`load_dump`.

When a run dies — a ``TrainingDiverged`` of the sentinel
(``runtime/sentinel.py``), a circuit-breaker trip, a fatal signal — the
postmortem question is always the same: *what was this process doing
just before?* The trace ring buffer answers it only if tracing was on and
only until the process is gone. The flight recorder is the crash-safe complement: an always-on,
strictly bounded in-memory record of

- the last ``ADT_BLACKBOX_EVENTS`` **resilience/health events**
  (sentinel verdicts and rollbacks, breaker opens, fenced writes, elastic
  reconfigures, preemption notices and handoffs — anything a subsystem
  ``record()``\\ s),
- the last N **log records** (a bounded logging handler on the
  framework logger),
- the **recent span tail** + current counters/gauges from the global
  recorder (with deltas against process start),

dumped **atomically** (tmp + ``os.replace``) as one JSON file under
``ADT_BLACKBOX_DIR`` on every trigger: ``TrainingDiverged``, sentinel
rollback, breaker-open, SIGTERM (when installable), or at exit when
``ADT_BLACKBOX_DUMP=1``. Old dumps are pruned to ``ADT_BLACKBOX_KEEP``.
Render one with :func:`format_dump`.

The SIGTERM hook chains with the preemption plane's notice handler
(``runtime/preemption.py``) in either install order: the notice fires
first and the dump last, so the dump's event tail holds the notice. A
signal handler is process state that only the main thread may set, so
the hook is installed from the main thread only, and :func:`reset`
(``autodist_tpu_torch.reset()``) puts back the handler it replaced.

Recording cost is one deque append under a lock — safe on every hot
path; ``ADT_BLACKBOX=0`` disables dumps and the signal hook but keeps
``record()`` a cheap no-op-equivalent (events still collect; nothing is
written).
"""
import collections
import json
import logging as std_logging
import os
import threading
import time
from typing import Optional

from autodist_tpu_torch import const
from autodist_tpu_torch.utils import logging

_MAX_DUMP_SPANS = 512


class _BlackboxLogHandler(std_logging.Handler):
    """Bounded tail of formatted log lines (WARNING+ by default keeps
    the tail signal-dense; the level rides ``ADT_MIN_LOG_LEVEL``'s
    floor, never above WARNING)."""

    def __init__(self, ring: collections.deque):
        super().__init__(level=std_logging.WARNING)
        self._ring = ring

    def emit(self, record: std_logging.LogRecord):
        try:
            self._ring.append({"ts": round(record.created, 6),
                               "level": record.levelname,
                               "src": "%s:%d" % (record.filename,
                                                 record.lineno),
                               "msg": record.getMessage()})
        except Exception:  # noqa: BLE001 — the recorder must never raise
            pass


class FlightRecorder:
    """The bounded black box. One process-global instance
    (:func:`get_flight_recorder`); independent instances for tests."""

    def __init__(self, capacity_events: Optional[int] = None,
                 capacity_logs: int = 200):
        if capacity_events is None:
            capacity_events = max(int(const.ENV.ADT_BLACKBOX_EVENTS.val), 8)
        self._events: collections.deque = collections.deque(
            maxlen=capacity_events)
        self._logs: collections.deque = collections.deque(
            maxlen=capacity_logs)
        self._lock = threading.Lock()
        self._started_at = time.time()
        self._log_handler: Optional[_BlackboxLogHandler] = None
        self.dumps = 0
        self.last_dump_path: Optional[str] = None
        from autodist_tpu_torch.telemetry import spans as spans_lib
        self._counters0 = spans_lib.counters()

    # ------------------------------------------------------------ record

    def record(self, kind: str, **data) -> None:
        """Append one event (wall-clock stamped). Values must be JSON-
        serializable scalars/strings — the dump coerces stragglers to
        ``repr``."""
        with self._lock:
            self._events.append((time.time(), kind, data))

    def attach_log_handler(self) -> None:
        """Tee the framework logger's WARNING+ tail into the box
        (idempotent)."""
        if self._log_handler is not None:
            return
        self._log_handler = _BlackboxLogHandler(self._logs)
        logging.get_logger().addHandler(self._log_handler)

    def detach_log_handler(self) -> None:
        if self._log_handler is not None:
            logging.get_logger().removeHandler(self._log_handler)
            self._log_handler = None

    # ---------------------------------------------------------- snapshot

    def snapshot(self, trigger: str) -> dict:
        """The dump payload: identity, trigger, events, span tail,
        registry state + deltas, log tail."""
        from autodist_tpu_torch.telemetry import spans as spans_lib
        rec = spans_lib.get_recorder()
        counters = rec.counters()
        deltas = {k: v - self._counters0.get(k, 0.0)
                  for k, v in counters.items()
                  if v != self._counters0.get(k, 0.0)}
        epoch = getattr(rec, "epoch_offset_ns", 0)
        offset = getattr(rec, "clock_offset_ns", 0)
        spans_tail = [
            {"name": e.name, "cat": e.cat,
             "ts": round((e.ts_ns + epoch + offset) / 1e9, 6),
             "dur_ms": round(e.dur_ns / 1e6, 4), "tid": e.tid,
             "span_id": e.span_id, "args": _jsonable(e.args)}
            for e in rec.events()[-_MAX_DUMP_SPANS:]]
        with self._lock:
            events = [{"ts": round(ts, 6), "kind": kind,
                       "data": _jsonable(data)}
                      for ts, kind, data in self._events]
            logs = list(self._logs)
        return {
            "format": "adt-blackbox-v1",
            "trigger": trigger,
            "dumped_at": round(time.time(), 6),
            "started_at": round(self._started_at, 6),
            "host": rec.host, "pid": rec.pid,
            "worker": const.ENV.ADT_WORKER.val or "chief",
            "events": events,
            "spans": spans_tail,
            "dropped_spans": rec.dropped_events,
            "counters": counters,
            "counter_deltas": deltas,
            "gauges": rec.gauges(),
            "logs": logs,
        }

    # -------------------------------------------------------------- dump

    def dump(self, trigger: str,
             directory: Optional[str] = None) -> Optional[str]:
        """Atomically write one dump file; returns its path (None when
        ``ADT_BLACKBOX=0`` or the write failed — a black box must never
        take the process down with it)."""
        if not const.ENV.ADT_BLACKBOX.val:
            return None
        directory = directory or const.ENV.ADT_BLACKBOX_DIR.val
        try:
            os.makedirs(directory, exist_ok=True)
            from autodist_tpu_torch.telemetry import spans as spans_lib
            rec = spans_lib.get_recorder()
            # the count zero-padded: retention keeps the names that sort
            # last, which must be the newest (an unpadded 10 sorts before
            # 9, and the prune would drop the newest dumps)
            name = "blackbox-%s-%d-%06d.json" % (
                time.strftime("%Y%m%d-%H%M%S"), rec.pid, self.dumps)
            path = os.path.join(directory, name)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self.snapshot(trigger), f, default=repr)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            self.dumps += 1
            self.last_dump_path = path
            spans_lib.counter_add("blackbox.dumps")
            logging.warning("flight recorder: dumped black box (%s) to %s",
                            trigger, path)
            self._prune(directory)
            return path
        except Exception as e:  # noqa: BLE001 — never fail the caller
            logging.warning("flight recorder: dump (%s) failed: %s",
                            trigger, e)
            return None

    @staticmethod
    def _prune(directory: str) -> None:
        keep = max(int(const.ENV.ADT_BLACKBOX_KEEP.val), 1)
        try:
            dumps = sorted(
                f for f in os.listdir(directory)
                if f.startswith("blackbox-") and f.endswith(".json"))
            for stale in dumps[:-keep]:
                os.remove(os.path.join(directory, stale))
        except OSError:
            pass

    def clear(self) -> None:
        """Drop events/logs and re-base counter deltas (test isolation)."""
        from autodist_tpu_torch.telemetry import spans as spans_lib
        with self._lock:
            self._events.clear()
            self._logs.clear()
        self._counters0 = spans_lib.counters()


def _jsonable(data):
    if data is None:
        return None
    import math
    out = {}
    for k, v in dict(data).items():
        if isinstance(v, float) and not math.isfinite(v):
            # strict-JSON consumers reject bare NaN/Infinity tokens, and
            # a nan grad norm is exactly what a divergence dump carries
            out[k] = repr(v)
        elif isinstance(v, (int, float, str, bool)) or v is None:
            out[k] = v
        else:
            out[k] = repr(v)
    return out


# ------------------------------------------------------- module singleton

_recorder: Optional[FlightRecorder] = None
_recorder_lock = threading.Lock()
_exit_hook_installed = False
_signal_hook_installed = False


def get_flight_recorder() -> FlightRecorder:
    """The process-global flight recorder (created on first use; log
    handler attached, exit/signal hooks installed per the env)."""
    global _recorder
    if _recorder is None:
        with _recorder_lock:
            if _recorder is None:
                fr = FlightRecorder()
                fr.attach_log_handler()
                _recorder = fr
                _install_hooks()
    return _recorder


def arm() -> FlightRecorder:
    """The recorder with its hooks installed (every Runner calls it at
    start-up): after :func:`reset` put the SIGTERM handler back, the next
    Runner installs the hook again."""
    fr = get_flight_recorder()
    _install_hooks()
    return fr


def _install_hooks():
    global _exit_hook_installed, _signal_hook_installed
    if const.ENV.ADT_BLACKBOX_DUMP.val and not _exit_hook_installed:
        import atexit
        atexit.register(lambda: dump("exit (ADT_BLACKBOX_DUMP=1)"))
        _exit_hook_installed = True
    if (const.ENV.ADT_BLACKBOX.val and not _signal_hook_installed
            and threading.current_thread() is threading.main_thread()):
        _signal_hook_installed = True
        try:
            import signal

            prev = signal.getsignal(signal.SIGTERM)

            def _grace_active() -> bool:
                # the preemption plane consumed the SIGTERM as an advance
                # notice: the process lives through its grace window, so
                # the default-disposition re-raise must not fire
                try:
                    from autodist_tpu_torch.runtime import preemption
                    return preemption.grace_active()
                except ImportError:
                    return False

            def _on_sigterm(signum, frame):
                # deterministic chain with the preemption notice handler
                # REGARDLESS of install order: the notice fires first,
                # the dump fires LAST (so its event tail contains the
                # notice). When the previous handler IS the notice
                # handler, run it before dumping; any other callable
                # keeps the legacy dump-then-chain order.
                notice_prev = (callable(prev)
                               and getattr(prev, "_adt_notice_handler",
                                           False))
                if notice_prev:
                    prev(signum, frame)
                record("signal", signum=signum)
                dump("fatal signal SIGTERM")
                if callable(prev) and not notice_prev:
                    prev(signum, frame)
                elif prev == signal.SIG_DFL and not _grace_active():
                    signal.signal(signal.SIGTERM, signal.SIG_DFL)
                    os.kill(os.getpid(), signal.SIGTERM)

            _on_sigterm._adt_blackbox_handler = True
            _on_sigterm._adt_prev = prev  # what restore_sigterm puts back
            signal.signal(signal.SIGTERM, _on_sigterm)
        except (ValueError, OSError):
            pass  # non-main thread / restricted env: dumps still work


def restore_sigterm() -> None:
    """Put back the SIGTERM handler that this module's hook and the
    preemption plane's notice handler replaced, in whichever order they
    were installed (main thread only: elsewhere a handler cannot be set).
    Both count as uninstalled afterwards, so the next Runner installs
    them again; a later SIGTERM in this process is not eaten by a grace
    window that no run owns any more."""
    global _signal_hook_installed
    if threading.current_thread() is not threading.main_thread():
        return
    import signal
    import sys
    try:
        for _ in range(4):
            handler = signal.getsignal(signal.SIGTERM)
            if not hasattr(handler, "_adt_prev"):
                break
            signal.signal(signal.SIGTERM, handler._adt_prev)
    except (ValueError, OSError):
        return
    _signal_hook_installed = False
    preemption = sys.modules.get("autodist_tpu_torch.runtime.preemption")
    if preemption is not None:
        preemption._sigterm_installed = False


def record(kind: str, **data) -> None:
    """Module-level event append — THE instrumented-code entry point
    (sentinel verdicts, rollbacks, breaker opens, resilience events)."""
    get_flight_recorder().record(kind, **data)


def dump(trigger: str, directory: Optional[str] = None) -> Optional[str]:
    return get_flight_recorder().dump(trigger, directory=directory)


def reset() -> None:
    """Clear the box's events/logs and put back the SIGTERM handler
    (wired into ``autodist_tpu_torch.reset()`` for test isolation); the
    log handler stays attached."""
    if _recorder is not None:
        _recorder.clear()
    restore_sigterm()


# ---------------------------------------------------------------- loading


def load_dump(path: str) -> dict:
    with open(path) as f:
        d = json.load(f)
    if d.get("format") != "adt-blackbox-v1":
        raise ValueError("%s is not an adt-blackbox-v1 dump" % path)
    return d


def format_dump(d: dict, max_rows: int = 40) -> str:
    """Human-readable rendering of one dump (the CLI's ``blackbox``
    subcommand)."""
    lines = [
        "black box: trigger=%r worker=%s host=%s pid=%s"
        % (d.get("trigger"), d.get("worker"), d.get("host"), d.get("pid")),
        "  dumped_at=%s (up %.1fs)  spans=%d (+%d dropped)  dumps file "
        "format=%s"
        % (time.strftime("%Y-%m-%d %H:%M:%S",
                         time.localtime(d.get("dumped_at", 0))),
           d.get("dumped_at", 0) - d.get("started_at", 0),
           len(d.get("spans", [])), d.get("dropped_spans", 0),
           d.get("format")),
        "  events (%d, newest last):" % len(d.get("events", []))]
    for ev in d.get("events", [])[-max_rows:]:
        lines.append("    %s  %-24s %s"
                     % (time.strftime("%H:%M:%S",
                                      time.localtime(ev.get("ts", 0))),
                        ev.get("kind"), json.dumps(ev.get("data") or {},
                                                   sort_keys=True)))
    deltas = d.get("counter_deltas", {})
    if deltas:
        lines.append("  counter deltas since start:")
        for k in sorted(deltas):
            lines.append("    %-40s %+g" % (k, deltas[k]))
    logs = d.get("logs", [])
    if logs:
        lines.append("  log tail (%d):" % len(logs))
        for rec in logs[-max_rows:]:
            lines.append("    %s %s %s  %s"
                         % (time.strftime("%H:%M:%S",
                                          time.localtime(rec.get("ts", 0))),
                            rec.get("level", "?")[:1], rec.get("src", ""),
                            rec.get("msg", "")))
    spans_tail = d.get("spans", [])
    if spans_tail:
        lines.append("  span tail (last %d):" % min(len(spans_tail),
                                                    max_rows))
        for s in spans_tail[-max_rows:]:
            lines.append("    %-28s %-10s %10.3fms  %s"
                         % (s.get("name"), s.get("cat"),
                            s.get("dur_ms", 0.0),
                            json.dumps(s.get("args") or {},
                                       sort_keys=True)))
    return "\n".join(lines)
