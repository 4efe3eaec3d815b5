"""Trace/metric export: Chrome-trace (Perfetto) JSON + Prometheus text
(PyTorch counterpart of ``autodist_tpu/telemetry/export.py``; the same
JSON and the same exposition text, byte for byte, so a dashboard or a
merge reads either package's output).

Two consumers, two formats:

- **Traces** export as Chrome Trace Event JSON (``traceEvents`` with
  ``ph="X"`` complete events) — the format https://ui.perfetto.dev loads
  directly. Each process is one trace ``pid`` track labeled
  ``host:pid``; threads are named sub-tracks; final counter values ride
  as ``ph="C"`` counter samples so they graph alongside the timeline.
- **Metrics** export as a Prometheus-style text exposition
  (:func:`metrics_text`): every registry counter as
  ``adt_<name>_total`` and every gauge as ``adt_<name>``, names
  sanitized to the metric charset.

Cross-process plumbing rides the EXISTING coordination service (the
async-PS wire — no new server): each worker :func:`publish_telemetry`\\ s
a versioned blob (``BPUT telemetry/<worker>``), the coordinator
:func:`scrape_cluster`\\ s every worker (``BGET``) and merges the
per-process timelines into one trace — pid/host become the track
identity, exactly what the Perfetto UI groups by.
"""
import json
import re
import time
from typing import Dict, Iterable, List, Optional

from autodist_tpu_torch.telemetry import spans as spans_lib

TELEMETRY_KEY = "telemetry/%s"


# ------------------------------------------------------------ chrome trace


def chrome_trace(recorder: Optional[spans_lib.TraceRecorder] = None,
                 label: Optional[str] = None) -> dict:
    """Chrome Trace Event JSON dict for one recorder's events + final
    counter values. ``label`` overrides the process track name."""
    rec = recorder if recorder is not None else spans_lib.get_recorder()
    pid = rec.pid
    proc_name = label or ("%s:%d" % (rec.host, pid))
    events: List[dict] = [
        {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
         "args": {"name": proc_name}},
    ]
    for tid, tname in sorted(rec.thread_names().items()):
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": {"name": tname}})
    # re-base the monotonic span clocks onto the wall clock — PLUS the
    # cluster clock-offset correction (telemetry/cluster.py handshake)
    # when one was estimated — so traces published by different
    # processes/hosts merge onto ONE step-aligned timeline
    # (perf_counter_ns origins are arbitrary per process; wall clocks
    # disagree across hosts)
    epoch = (getattr(rec, "epoch_offset_ns", 0)
             + getattr(rec, "clock_offset_ns", 0))
    # counters-only export (tracing disabled — the always-on registry
    # mode): the C samples must still land at wall-clock NOW, not 1970,
    # or a merged scrape mixes timebases 56 years apart
    last_ts = (epoch + time.perf_counter_ns()) / 1e3 if epoch else 0.0
    for e in rec.events():
        ts = (e.ts_ns + epoch) / 1e3  # chrome-trace ts are microseconds
        last_ts = max(last_ts, ts + e.dur_ns / 1e3)
        ev = {"ph": "X", "name": e.name, "cat": e.cat, "ts": ts,
              "dur": e.dur_ns / 1e3, "pid": pid, "tid": e.tid,
              "args": dict(e.args or {}, span_id=e.span_id,
                           parent_id=e.parent_id)}
        events.append(ev)
    # final counter/gauge values as one counter sample at the trace end
    for name, val in sorted(rec.counters().items()):
        events.append({"ph": "C", "name": name, "pid": pid, "tid": 0,
                       "ts": last_ts, "args": {"value": val}})
    for name, val in sorted(rec.gauges().items()):
        events.append({"ph": "C", "name": name, "pid": pid, "tid": 0,
                       "ts": last_ts, "args": {"value": val}})
    # histogram summaries as counter samples: Chrome-trace has no native
    # histogram phase, so the p50/p99 readouts graph as counter tracks —
    # the SLO numbers land on the same timeline as the spans they time
    for name, h in sorted(rec.histograms().items()):
        if not h["count"]:
            continue
        for q_label in ("p50", "p99"):
            events.append({"ph": "C", "name": "%s.%s" % (name, q_label),
                           "pid": pid, "tid": 0, "ts": last_ts,
                           "args": {"value": h[q_label]}})
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "host": rec.host, "pid": pid,
            "dropped_events": rec.dropped_events,
            "clock_offset_ns": getattr(rec, "clock_offset_ns", 0),
            "clock_error_ns": getattr(rec, "clock_error_ns", None),
            "counters": rec.counters(),
            "gauges": rec.gauges(),
        },
    }


def write_trace(path: str,
                recorder: Optional[spans_lib.TraceRecorder] = None,
                label: Optional[str] = None) -> str:
    """Serialize :func:`chrome_trace` to ``path`` (Perfetto-loadable)."""
    import os
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        json.dump(chrome_trace(recorder, label=label), f)
    return path


def load_trace(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def merge_traces(traces: Iterable[dict]) -> dict:
    """Merge per-process trace dicts into one timeline. Colliding pids
    (two single-process hosts both pid 1234) are remapped so every
    process keeps its own track; ``otherData`` aggregates per-process."""
    merged: List[dict] = []
    per_proc: Dict[str, dict] = {}
    seen_pids: Dict[int, str] = {}
    next_free = 1 << 20  # remap target far above real pids
    for i, t in enumerate(traces):
        other = t.get("otherData", {})
        # traces lacking otherData (external producers) each get a UNIQUE
        # fallback key — sharing one would defeat the collision remap and
        # interleave two processes' events on one track
        if "host" in other or "pid" in other:
            key = "%s:%s" % (other.get("host", "?"), other.get("pid", "?"))
        else:
            key = "trace-%d" % i
        events = t.get("traceEvents", [])
        pids = {e.get("pid") for e in events if "pid" in e}
        remap = {}
        for pid in pids:
            owner = seen_pids.get(pid)
            if owner is not None and owner != key:
                remap[pid] = next_free
                seen_pids[next_free] = key
                next_free += 1
            else:
                seen_pids[pid] = key
        for e in events:
            if remap and e.get("pid") in remap:
                e = dict(e, pid=remap[e["pid"]])
            merged.append(e)
        per_proc[key] = other
    return {"traceEvents": merged, "displayTimeUnit": "ms",
            "otherData": {"processes": per_proc}}


# the minimal contract a Perfetto-loadable export satisfies — the chip
# smoke validates its exported trace against this
def validate_chrome_trace(trace: dict) -> List[str]:
    """Schema check; returns a list of violations (empty = valid)."""
    errors: List[str] = []
    if not isinstance(trace, dict):
        return ["trace is not a JSON object"]
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return ["missing traceEvents list"]
    if not events:
        errors.append("traceEvents is empty")
    for i, e in enumerate(events):
        if len(errors) > 20:  # checked FIRST: every error branch below
            errors.append("... (truncated)")  # continues, so a fully
            break                             # malformed file must not
        if not isinstance(e, dict) or "ph" not in e:  # build one error
            errors.append("event %d: missing ph" % i)  # per event
            continue
        ph = e["ph"]
        if ph not in ("X", "M", "C", "i", "I", "B", "E"):
            errors.append("event %d: unknown phase %r" % (i, ph))
            continue
        if "name" not in e or "pid" not in e:
            errors.append("event %d (%s): missing name/pid" % (i, ph))
        if ph == "X":
            for field in ("ts", "dur", "tid"):
                if not isinstance(e.get(field), (int, float)):
                    errors.append("event %d (X %r): non-numeric %s"
                                  % (i, e.get("name"), field))
    # a span-less export is still valid when it carries counter samples —
    # the documented ADT_TRACE=0 counters-only mode produces exactly that
    if not any(isinstance(e, dict) and e.get("ph") in ("X", "C")
               for e in events):
        errors.append("no span (ph=X) or counter (ph=C) events")
    return errors


# ---------------------------------------------------------------- metrics

_METRIC_RE = re.compile(r"[^a-zA-Z0-9_]")


def _metric_name(name: str) -> str:
    return "adt_" + _METRIC_RE.sub("_", name)


def _escape_label_value(value: str) -> str:
    """Prometheus exposition-format label escaping: backslash, double
    quote and newline must be escaped or a strict scraper rejects the
    whole exposition (worker names and host labels are caller data)."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _help_text(name: str, kind: str) -> str:
    """One-line HELP for a registry entry. Metric names are the
    ``<subsystem>.<operation>`` taxonomy, so the help derives from the
    name — a curated per-metric string registry would drift the moment a
    counter is added anywhere else. The text names the project as the
    JAX package's does, so the two expositions are the same bytes."""
    sub, _, op = name.partition(".")
    return ("autodist_tpu %s %r of subsystem %r (registry key %r)"
            % (kind, op or sub, sub, name))


def metrics_text(recorder: Optional[spans_lib.TraceRecorder] = None,
                 labels: Optional[Dict[str, str]] = None) -> str:
    """Prometheus text exposition of the registry: counters as
    ``adt_<name>_total``, gauges as ``adt_<name>``, each with ``# HELP``
    + ``# TYPE`` headers; ``labels`` (e.g. ``{"worker": "w0"}``) attach
    to every sample — the scrape merge uses them to keep per-worker
    series distinct. Label values are escaped per the exposition format
    (backslash/quote/newline), so arbitrary worker/host names survive a
    strict scraper."""
    rec = recorder if recorder is not None else spans_lib.get_recorder()
    lbl = ""
    if labels:
        lbl = "{%s}" % ",".join(
            '%s="%s"' % (k, _escape_label_value(v))
            for k, v in sorted(labels.items()))
    lines: List[str] = []
    for name, val in sorted(rec.counters().items()):
        mname = _metric_name(name) + "_total"
        lines.append("# HELP %s %s" % (mname, _help_text(name, "counter")))
        lines.append("# TYPE %s counter" % mname)
        lines.append("%s%s %s" % (mname, lbl, _fmt_value(val)))
    for name, val in sorted(rec.gauges().items()):
        mname = _metric_name(name)
        lines.append("# HELP %s %s" % (mname, _help_text(name, "gauge")))
        lines.append("# TYPE %s gauge" % mname)
        lines.append("%s%s %s" % (mname, lbl, _fmt_value(val)))
    for name, h in sorted(rec.histograms().items()):
        mname = _metric_name(name)
        lines.append("# HELP %s %s" % (mname,
                                       _help_text(name, "histogram")))
        lines.append("# TYPE %s histogram" % mname)
        # Prometheus histogram exposition: cumulative bucket counts with
        # an ``le`` label (the extra label merges with the caller's), a
        # +Inf bucket, and _sum/_count
        cumulative = 0
        for bound, c in zip(list(h["bounds"]) + [float("inf")],
                            h["counts"]):
            cumulative += c
            le = "+Inf" if bound == float("inf") else _fmt_value(bound)
            blbl = ('{%s,le="%s"}' % (lbl[1:-1], le)) if lbl \
                else '{le="%s"}' % le
            lines.append("%s_bucket%s %d" % (mname, blbl, cumulative))
        lines.append("%s_sum%s %s" % (mname, lbl, _fmt_value(h["sum"])))
        lines.append("%s_count%s %d" % (mname, lbl, h["count"]))
    return "\n".join(lines) + "\n"


def _fmt_value(val: float) -> str:
    return ("%d" % val) if float(val).is_integer() else repr(float(val))


# ------------------------------------------- cross-process publish/scrape


def publish_telemetry(client, worker: str,
                      recorder: Optional[spans_lib.TraceRecorder] = None,
                      version: Optional[int] = None) -> int:
    """Publish this process's telemetry (trace + registry) as a versioned
    blob on the coordination service (``BPUT telemetry/<worker>``) —
    same wire the async-PS values ride, so any deployed job already has
    the plumbing. Returns the published version."""
    rec = recorder if recorder is not None else spans_lib.get_recorder()
    if version is None:
        # a per-publish sequence, NOT the span tally: counters-only mode
        # (tracing disabled) records no spans, and the version must still
        # advance every publish or consumers read live workers as stale
        version = next(rec._publish_seq)
    payload = {
        "worker": worker, "host": rec.host, "pid": rec.pid,
        # reference-corrected publish stamp: the scraper derives per-
        # worker scrape AGE from it, so the clock offset must already be
        # applied or a skewed host reads permanently stale (or from the
        # future)
        "published_at": (time.time()
                         + getattr(rec, "clock_offset_ns", 0) / 1e9),
        "clock": {"offset_ns": getattr(rec, "clock_offset_ns", 0),
                  "error_ns": getattr(rec, "clock_error_ns", None)},
        "trace": chrome_trace(rec, label="%s (%s:%d)"
                              % (worker, rec.host, rec.pid)),
        "metrics": rec.counters(),
        "gauges": rec.gauges(),
        "histograms": rec.histograms(),
    }
    client.bput(TELEMETRY_KEY % worker, version,
                json.dumps(payload).encode())
    return version


def fetch_telemetry(client, worker: str) -> Optional[dict]:
    """The latest telemetry blob a worker published, or None."""
    res = client.bget(TELEMETRY_KEY % worker)
    if res is None:
        return None
    _version, blob = res
    return json.loads(blob.decode())


def scrape_cluster(client, workers: Iterable[str]) -> dict:
    """Coordinator-side scrape: fetch every worker's published blob,
    merge the traces into one multi-track timeline and the registries
    into one labeled exposition. Workers that have not published are
    listed in ``missing`` — and counted in the ``cluster.workers_missing``
    gauge (set on the local registry AND emitted in the returned
    exposition) so a dashboard can alert on silent workers instead of
    diffing lists. ``scrape_age_s`` carries each worker's publish age
    (reference-clock corrected), the freshness signal per worker; a
    scrape never blocks on a dead worker."""
    blobs, missing = {}, []
    for w in workers:
        payload = fetch_telemetry(client, w)
        if payload is None:
            missing.append(w)
        else:
            blobs[w] = payload
    trace = merge_traces([p["trace"] for p in blobs.values()])
    now = time.time()
    ages = {w: (round(max(now - p["published_at"], 0.0), 3)
                if p.get("published_at") else None)
            for w, p in blobs.items()}
    clocks = {w: p.get("clock", {}) for w, p in blobs.items()}
    texts = []
    for w, p in sorted(blobs.items()):
        shadow = spans_lib.TraceRecorder(capacity=1, pid=p["pid"],
                                         host=p["host"])
        shadow._counters = dict(p.get("metrics", {}))
        shadow._gauges = dict(p.get("gauges", {}))
        shadow._histograms = {
            n: spans_lib.Histogram.from_dict(d)
            for n, d in p.get("histograms", {}).items()}
        texts.append(metrics_text(shadow, labels={"worker": w}))
    # coordinator-side cluster gauges: appended to the exposition (a
    # scraper sees them next to the per-worker series) AND set on the
    # local registry (step_stats/bench readers see them without parsing
    # text)
    spans_lib.gauge_set("cluster.workers_missing", float(len(missing)))
    spans_lib.counter_add("cluster.scrapes")
    cluster_lines = [
        "# HELP adt_cluster_workers_missing workers that never published "
        "a telemetry blob this scrape",
        "# TYPE adt_cluster_workers_missing gauge",
        "adt_cluster_workers_missing %d" % len(missing)]
    age_samples = [
        'adt_cluster_scrape_age_seconds{worker="%s"} %s'
        % (_escape_label_value(w), _fmt_value(ages[w]))
        for w in sorted(ages) if ages[w] is not None]
    if age_samples:
        cluster_lines.append(
            "# HELP adt_cluster_scrape_age_seconds age of each "
            "worker's latest published blob (reference clock)")
        cluster_lines.append(
            "# TYPE adt_cluster_scrape_age_seconds gauge")
        cluster_lines.extend(age_samples)
    texts.append("\n".join(cluster_lines) + "\n")
    return {"trace": trace, "metrics_text": "".join(texts),
            "workers": sorted(blobs), "missing": missing,
            "scrape_age_s": ages, "clocks": clocks}
