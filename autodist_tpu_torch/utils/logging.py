"""Framework logger.

Analog of reference ``autodist/utils/logging.py:80-107``: a dedicated
``autodist_tpu_torch`` logger with PID+file+line formatting, writing to
stderr only (the port keeps no per-run log file, so a run writes nothing
outside its working tree); level taken from the ``ADT_MIN_LOG_LEVEL`` env
var.

``ADT_LOG_FORMAT=json`` switches both handlers to structured one-object-
per-line JSON carrying the ACTIVE TELEMETRY SPAN ID (``telemetry/spans.py``)
so log lines correlate with trace timelines — a resilience retry warning
lands inside the ``coord.backoff`` span that slept it, a degraded-pull
warning inside its ``ps.pull``. ``set_format()`` switches a live logger.
"""
import json as _json
import logging as _logging
import sys
import threading

from autodist_tpu_torch import const

_logger = None
_logger_lock = threading.Lock()

_FMT = "%(asctime)s %(levelname).1s %(process)d %(filename)s:%(lineno)d] %(message)s"


class _JsonFormatter(_logging.Formatter):
    """One JSON object per line: stable keys, ISO-ish timestamp, and the
    innermost live telemetry span id (0 = no span active) so a log
    pipeline can join lines onto the exported trace."""

    def format(self, record: _logging.LogRecord) -> str:
        out = {
            "ts": round(record.created, 6),
            "level": record.levelname,
            "pid": record.process,
            "thread": record.threadName,
            "src": "%s:%d" % (record.filename, record.lineno),
            "msg": record.getMessage(),
        }
        try:  # lazy: logging must work even mid-import of telemetry
            from autodist_tpu_torch.telemetry import spans as _tspans
            span_id = _tspans.current_span_id()
            if span_id:
                out["span_id"] = span_id
        except Exception:  # noqa: BLE001 — correlation is best-effort
            pass
        if record.exc_info and record.exc_info[0] is not None:
            out["exc"] = self.formatException(record.exc_info)
        return _json.dumps(out)


def make_formatter(fmt: str = None) -> _logging.Formatter:
    """The formatter for a format mode ("text" | "json"; default: the
    ``ADT_LOG_FORMAT`` env var)."""
    mode = (fmt or const.ENV.ADT_LOG_FORMAT.val or "text").lower()
    if mode == "json":
        return _JsonFormatter()
    return _logging.Formatter(_FMT)


def get_logger() -> _logging.Logger:
    global _logger
    if _logger is not None:
        return _logger
    with _logger_lock:
        if _logger is not None:
            return _logger
        logger = _logging.getLogger("autodist_tpu_torch")
        logger.propagate = False
        level = const.ENV.ADT_MIN_LOG_LEVEL.val.upper()
        logger.setLevel(getattr(_logging, level, _logging.INFO))
        fmt = make_formatter()
        sh = _logging.StreamHandler(sys.stderr)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        _logger = logger
        return logger


def set_format(fmt: str):
    """Switch a live logger's handlers between "text" and "json" lines
    (tests / long-running jobs flipping to structured output)."""
    formatter = make_formatter(fmt)
    for handler in get_logger().handlers:
        handler.setFormatter(formatter)


def debug(msg, *args, **kw):
    get_logger().debug(msg, *args, stacklevel=2, **kw)


def info(msg, *args, **kw):
    get_logger().info(msg, *args, stacklevel=2, **kw)


def warning(msg, *args, **kw):
    get_logger().warning(msg, *args, stacklevel=2, **kw)


def error(msg, *args, **kw):
    get_logger().error(msg, *args, stacklevel=2, **kw)


def set_verbosity(level: str):
    get_logger().setLevel(getattr(_logging, level.upper(), _logging.INFO))
