"""Goodput & straggler attribution: where the wall time actually went
(PyTorch counterpart of ``autodist_tpu/telemetry/goodput.py``, which
imports nothing of JAX; pure Python, so the port's copy computes the
same buckets bit for bit).

``Runner.step_stats()`` reports *that* time was lost (total vs steady
median × dispatches); this module reports *where*: a
:class:`GoodputReport` decomposes the training thread's wall time into
attributed buckets by walking the recorded span tree —

==================  ====================================================
bucket              spans whose SELF time it aggregates
==================  ====================================================
``compute``         ``runner.dispatch`` / ``dstep.dispatch`` self time
                    (the jitted program, minus everything nested below)
``collective_wait`` ``runner.barrier`` (staleness pacing / lockstep
                    waits), ``coord.backoff`` (control-plane retries)
``ps_wire``         ``ps.pull``/``ps.push``/``ps.apply``/``ps.absorb``,
                    ``dstep.pull_ps``/``dstep.flush_ps``
``host_input``      ``runner.feed`` (host→device batch placement),
                    ``prefetch.place``
``readback``        ``runner.readback`` (device→host metrics)
``checkpoint``      every ``ckpt`` category span on the training thread
                    (async writer-thread time overlaps compute and is
                    deliberately NOT charged against the wall)
``rollback_replay`` ``sentinel.rollback`` self time (the restore's own
                    ckpt spans land in ``checkpoint``)
``other``           everything else (fit-loop bookkeeping, spans this
                    table does not know)
==================  ====================================================

**Self time** is a span's duration minus its same-thread children's, so
every nanosecond of the wall is attributed exactly once: the buckets sum
to the root spans' wall time *by construction* (the acceptance bound is
2% to absorb ring-buffer drops). Sampled traces cannot be decomposed —
the report flags itself ``approximate`` and the buckets scale by the
stride only in aggregate.

The cross-worker half (:func:`cluster_goodput`) runs the same
decomposition per process on a merged/scraped trace and adds **step-time
skew**: per-worker dispatch medians, the max/min skew ratio, and
straggler flags (median > ``flag_ratio`` × the cluster median).

The *online* straggler signal is :class:`StragglerEwma` — the Runner
feeds it per-dispatch wall times; sustained z-score outliers flip the
``telemetry.straggler`` gauge, emit instants, and (multi-process) mark
``straggler/<worker>`` on the coordination service so the chief's
watchdog can tell slow-but-alive from dead.
"""
import dataclasses
import math
import statistics
from typing import Dict, List, Optional

from autodist_tpu_torch import const
from autodist_tpu_torch.telemetry import spans as spans_lib

BUCKETS = ("compute", "collective_wait", "ps_wire", "host_input",
           "readback", "checkpoint", "rollback_replay", "other")

_SPAN_BUCKET = {
    "runner.dispatch": "compute", "dstep.dispatch": "compute",
    "runner.barrier": "collective_wait", "coord.backoff": "collective_wait",
    "ps.pull": "ps_wire", "ps.push": "ps_wire", "ps.apply": "ps_wire",
    "ps.absorb": "ps_wire", "dstep.pull_ps": "ps_wire",
    "dstep.flush_ps": "ps_wire",
    "ps_service.publish": "ps_wire", "ps_service.apply": "ps_wire",
    "runner.feed": "host_input", "prefetch.place": "host_input",
    "runner.readback": "readback",
    "sentinel.rollback": "rollback_replay",
}
_CAT_BUCKET = {"ckpt": "checkpoint"}

DISPATCH_SPAN = "runner.dispatch"


def classify(name: str, cat: str) -> str:
    """The bucket one span's SELF time belongs to."""
    bucket = _SPAN_BUCKET.get(name)
    if bucket is not None:
        return bucket
    return _CAT_BUCKET.get(cat, "other")


# --------------------------------------------------------------- reports


@dataclasses.dataclass
class GoodputReport:
    """One process's attributed wall-time decomposition (seconds)."""

    wall_s: float
    buckets: Dict[str, float]
    num_dispatches: int
    dispatch_median_s: Optional[float]
    dispatch_p90_s: Optional[float]
    first_dispatch_s: Optional[float]     # includes the XLA compile
    approximate: bool = False             # sampled trace or ring drops
    dropped_events: int = 0

    @property
    def attributed_s(self) -> float:
        return sum(self.buckets.values())

    @property
    def coverage(self) -> Optional[float]:
        """attributed / wall — 1.0 ± float noise by construction; < 1
        signals ring-buffer drops (see ``approximate``)."""
        return (self.attributed_s / self.wall_s) if self.wall_s > 0 else None

    @property
    def goodput(self) -> Optional[float]:
        """Fraction of the wall spent computing (the bucket the job
        exists for)."""
        if self.wall_s <= 0:
            return None
        return min(1.0, self.buckets.get("compute", 0.0) / self.wall_s)

    def to_dict(self) -> dict:
        return {
            "wall_s": round(self.wall_s, 6),
            "buckets": {k: round(v, 6) for k, v in self.buckets.items()},
            "attributed_s": round(self.attributed_s, 6),
            "coverage": (round(self.coverage, 4)
                         if self.coverage is not None else None),
            "goodput": (round(self.goodput, 4)
                        if self.goodput is not None else None),
            "num_dispatches": self.num_dispatches,
            "dispatch_median_s": (round(self.dispatch_median_s, 6)
                                  if self.dispatch_median_s is not None
                                  else None),
            "dispatch_p90_s": (round(self.dispatch_p90_s, 6)
                               if self.dispatch_p90_s is not None else None),
            "first_dispatch_s": (round(self.first_dispatch_s, 6)
                                 if self.first_dispatch_s is not None
                                 else None),
            "approximate": self.approximate,
            "dropped_events": self.dropped_events,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "GoodputReport":
        return cls(wall_s=float(d.get("wall_s", 0.0)),
                   buckets={k: float(v)
                            for k, v in d.get("buckets", {}).items()},
                   num_dispatches=int(d.get("num_dispatches", 0)),
                   dispatch_median_s=d.get("dispatch_median_s"),
                   dispatch_p90_s=d.get("dispatch_p90_s"),
                   first_dispatch_s=d.get("first_dispatch_s"),
                   approximate=bool(d.get("approximate", False)),
                   dropped_events=int(d.get("dropped_events", 0)))

    def save(self, path: str) -> str:
        import json
        import os
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1, sort_keys=True)
        return path

    def format_table(self) -> str:
        lines = ["goodput report: wall=%.6gs dispatches=%d%s"
                 % (self.wall_s, self.num_dispatches,
                    " (APPROXIMATE: sampled/dropped spans)"
                    if self.approximate else "")]
        lines.append("  %-16s %12s %8s" % ("bucket", "seconds", "share"))
        for name in BUCKETS:
            sec = self.buckets.get(name, 0.0)
            share = sec / self.wall_s if self.wall_s > 0 else 0.0
            lines.append("  %-16s %12.6f %7.1f%%" % (name, sec,
                                                     100.0 * share))
        lines.append("  %-16s %12.6f %7.1f%%"
                     % ("(attributed)", self.attributed_s,
                        100.0 * (self.coverage or 0.0)))
        if self.dispatch_median_s is not None:
            lines.append("  dispatch: median=%.6gs p90=%.6gs first=%s"
                         % (self.dispatch_median_s, self.dispatch_p90_s,
                            "%.6gs" % self.first_dispatch_s
                            if self.first_dispatch_s is not None else "-"))
        return "\n".join(lines)


# ----------------------------------------------------------- event walks


def _normalize_recorder(rec) -> List[dict]:
    return [{"name": e.name, "cat": e.cat, "ts": e.ts_ns / 1e3,
             "dur": e.dur_ns / 1e3, "tid": e.tid, "pid": rec.pid,
             "id": e.span_id, "parent": e.parent_id}
            for e in rec.events()]


def _normalize_trace(trace: dict) -> List[dict]:
    out = []
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        args = e.get("args") or {}
        out.append({"name": e.get("name", "?"), "cat": e.get("cat", ""),
                    "ts": float(e.get("ts", 0.0)),
                    "dur": float(e.get("dur", 0.0)),
                    "tid": e.get("tid", 0), "pid": e.get("pid", 0),
                    "id": args.get("span_id", 0),
                    "parent": args.get("parent_id", 0)})
    return out


def _training_tid(events: List[dict]) -> Optional[int]:
    """The thread whose wall time the decomposition attributes: the one
    holding ``runner.fit`` (or, failing that, the most dispatches, or
    the most recorded time)."""
    fits = [e for e in events if e["name"] == "runner.fit"]
    if fits:
        return max(fits, key=lambda e: e["dur"])["tid"]
    per_tid: Dict[int, int] = {}
    for e in events:
        if e["name"] == DISPATCH_SPAN:
            per_tid[e["tid"]] = per_tid.get(e["tid"], 0) + 1
    if per_tid:
        return max(per_tid, key=per_tid.get)
    per_tid_time: Dict[int, float] = {}
    for e in events:
        per_tid_time[e["tid"]] = per_tid_time.get(e["tid"], 0.0) + e["dur"]
    return (max(per_tid_time, key=per_tid_time.get)
            if per_tid_time else None)


def breakdown_from_events(events: List[dict],
                          tid: Optional[int] = None) -> GoodputReport:
    """Self-time decomposition of one process's events (µs in, s out).
    Only spans on the training thread participate — background threads
    (async checkpoint writer, PS apply loop, serving) overlap the wall
    rather than spending it."""
    if tid is None:
        tid = _training_tid(events)
    mine = [e for e in events if e["tid"] == tid and e["dur"] > 0]
    ids = {e["id"] for e in mine}
    child_time: Dict[int, float] = {}
    for e in mine:
        if e["parent"] in ids:
            child_time[e["parent"]] = (child_time.get(e["parent"], 0.0)
                                       + e["dur"])
    buckets = dict.fromkeys(BUCKETS, 0.0)
    wall_us = 0.0
    dispatch_durs: List[float] = []
    for e in mine:
        self_us = max(e["dur"] - child_time.get(e["id"], 0.0), 0.0)
        buckets[classify(e["name"], e["cat"])] += self_us / 1e6
        if e["parent"] not in ids:
            wall_us += e["dur"]
        if e["name"] == DISPATCH_SPAN:
            dispatch_durs.append(e["dur"] / 1e6)
    n = len(dispatch_durs)
    steady = sorted(dispatch_durs[1:]) if n > 1 else []
    return GoodputReport(
        wall_s=wall_us / 1e6,
        buckets=buckets,
        num_dispatches=n,
        dispatch_median_s=(statistics.median(steady) if steady
                           else (dispatch_durs[0] if n else None)),
        dispatch_p90_s=(steady[min(len(steady) - 1,
                                   math.floor(0.9 * len(steady)))]
                        if steady else None),
        first_dispatch_s=dispatch_durs[0] if n else None)


def build_report(recorder: Optional[spans_lib.TraceRecorder] = None
                 ) -> GoodputReport:
    """GoodputReport for one live recorder (``Runner.goodput_report``'s
    backend)."""
    rec = recorder if recorder is not None else spans_lib.get_recorder()
    report = breakdown_from_events(_normalize_recorder(rec))
    report.dropped_events = rec.dropped_events
    report.approximate = rec.sample > 1 or rec.dropped_events > 0
    return report


def report_from_trace(trace: dict) -> Dict[int, GoodputReport]:
    """Per-pid reports from an exported (possibly merged) trace file —
    the ``python -m autodist_tpu_torch.telemetry goodput`` backend."""
    events = _normalize_trace(trace)
    pids = sorted({e["pid"] for e in events})
    return {pid: breakdown_from_events([e for e in events
                                        if e["pid"] == pid])
            for pid in pids}


# ------------------------------------------------------- cluster analysis


def cluster_goodput(trace: dict, flag_ratio: float = 1.5) -> dict:
    """Cross-worker skew + straggler attribution over a merged trace:
    per-pid goodput reports, per-pid dispatch medians, the max/min skew
    ratio, and the pids flagged as stragglers (median > ``flag_ratio``
    × the FASTEST worker's median — the fastest worker is the honest
    baseline of what the hardware can do; a cluster-median baseline
    cannot flag anything in a 2-worker cluster, and a half-degraded
    fleet drags the median toward the stragglers). Labels come from the
    trace's process_name metadata when present."""
    labels: Dict[int, str] = {}
    for e in trace.get("traceEvents", []):
        if e.get("ph") == "M" and e.get("name") == "process_name":
            labels[e.get("pid", 0)] = (e.get("args") or {}).get("name", "")
    reports = report_from_trace(trace)
    medians = {pid: r.dispatch_median_s for pid, r in reports.items()
               if r.dispatch_median_s}
    skew = (max(medians.values()) / min(medians.values())
            if len(medians) > 1 and min(medians.values()) > 0 else 1.0)
    baseline = min(medians.values()) if len(medians) > 1 else None
    stragglers = sorted(
        pid for pid, m in medians.items()
        if baseline and m > flag_ratio * baseline)
    return {
        "workers": {pid: dict(reports[pid].to_dict(),
                              label=labels.get(pid, str(pid)))
                    for pid in reports},
        "step_medians_s": {pid: round(m, 6)
                           for pid, m in medians.items()},
        "skew_ratio": round(skew, 4),
        "stragglers": [{"pid": pid, "label": labels.get(pid, str(pid)),
                        "median_s": round(medians[pid], 6)}
                       for pid in stragglers],
    }


# --------------------------------------------------------- online EWMA


class StragglerEwma:
    """Online per-dispatch straggler detector (the Runner feeds it one
    wall-time sample per dispatch). Sustained z-score outliers —
    ``ADT_STRAGGLER_Z`` sigma above the EWMA baseline for
    ``ADT_STRAGGLER_PATIENCE`` consecutive dispatches — flag this worker
    as *slow-but-alive*; recovery (one in-band sample) clears the flag.
    The EWMA ingests only non-flagged samples, so a long degradation
    cannot drag its own baseline up and hide."""

    def __init__(self, alpha: float = 0.1, zscore: Optional[float] = None,
                 patience: Optional[int] = None, warmup: int = 8):
        self.alpha = alpha
        self.zscore = (zscore if zscore is not None
                       else const.ENV.ADT_STRAGGLER_Z.val)
        self.patience = max(int(patience if patience is not None
                                else const.ENV.ADT_STRAGGLER_PATIENCE.val),
                            1)
        self.warmup = warmup
        self._mean: Optional[float] = None
        self._var = 0.0
        self._n = 0
        self._streak = 0
        self.flagged = False
        self.last_z: Optional[float] = None
        self.flags = 0

    def observe(self, dur_s: float) -> Optional[str]:
        """Ingest one dispatch wall time. Returns ``"flag"`` on the
        transition into the straggling state, ``"clear"`` on recovery,
        None otherwise (the caller emits telemetry on transitions)."""
        if self._mean is None:
            self._mean, self._n = dur_s, 1
            return None
        std = math.sqrt(max(self._var, 0.0))
        z = (dur_s - self._mean) / (std + 1e-9)
        self.last_z = z
        if self._n >= self.warmup and z > self.zscore:
            self._streak += 1
            if self._streak >= self.patience and not self.flagged:
                self.flagged = True
                self.flags += 1
                return "flag"
            return None  # an outlier must not inflate its own baseline
        self._streak = 0
        delta = dur_s - self._mean
        self._mean += self.alpha * delta
        self._var = ((1.0 - self.alpha)
                     * (self._var + self.alpha * delta * delta))
        self._n += 1
        if self.flagged:
            self.flagged = False
            return "clear"
        return None

    def stats(self) -> dict:
        return {"flagged": self.flagged, "flags": self.flags,
                "last_z": (round(self.last_z, 3)
                           if self.last_z is not None else None),
                "ewma_s": (round(self._mean, 6)
                           if self._mean is not None else None)}
