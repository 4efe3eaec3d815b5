"""Trace-file tooling: ``python -m autodist_tpu_torch.telemetry <cmd>``
(the port of ``autodist_tpu/telemetry/cli.py``: the same subcommands,
output and exit codes; it reads either package's files).

Subcommands:

- ``inspect FILE``            per-span-name summary + final counters
- ``merge OUT FILE...``       merge per-process traces into one timeline
- ``diff A B``                per-span-name total-duration deltas
- ``validate FILE``           schema check (exit 1 on violations)
- ``drift REPORT.json``       pretty-print a saved DriftReport table
- ``goodput FILE``            attributed wall-time buckets per process
  (+ cross-worker skew/stragglers on a merged trace); FILE may also be
  a saved GoodputReport json
- ``blackbox DUMP.json``      pretty-print a flight-recorder dump
- ``profile FIRST LAST``      post the fleet profiling flag on the
  coordination service (``--clear`` withdraws it)
"""
import argparse
import json
import sys
from typing import Dict

from autodist_tpu_torch.telemetry import export


def _span_totals(trace: dict) -> Dict[str, dict]:
    out: Dict[str, dict] = {}
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        row = out.setdefault(e["name"], {"cat": e.get("cat", ""),
                                         "count": 0, "total_us": 0.0,
                                         "max_us": 0.0})
        row["count"] += 1
        row["total_us"] += float(e.get("dur", 0.0))
        row["max_us"] = max(row["max_us"], float(e.get("dur", 0.0)))
    return out


def _counters(trace: dict) -> Dict[str, float]:
    """Final counter values — SUMMED across processes on a merged trace
    (each process reports its own monotonic totals; the cluster total is
    their sum), never double-counted against the duplicate ph="C"
    samples (those are the fallback for traces lacking otherData)."""
    other = trace.get("otherData", {})
    procs = ([other] if "counters" in other
             else list(other.get("processes", {}).values()))
    out: Dict[str, float] = {}
    if procs:
        for proc in procs:
            for name, val in proc.get("counters", {}).items():
                out[name] = out.get(name, 0.0) + val
        return out
    last: Dict[tuple, float] = {}  # last C sample per (pid, name)
    for e in trace.get("traceEvents", []):
        if e.get("ph") == "C":
            last[(e.get("pid"), e["name"])] = (
                e.get("args", {}).get("value", 0.0))
    for (_pid, name), val in last.items():
        out[name] = out.get(name, 0.0) + val
    return out


def cmd_inspect(args) -> int:
    trace = export.load_trace(args.file)
    totals = _span_totals(trace)
    print("%-28s %-10s %8s %12s %12s %12s"
          % ("span", "cat", "count", "total_ms", "mean_ms", "max_ms"))
    for name in sorted(totals, key=lambda n: -totals[n]["total_us"]):
        r = totals[name]
        print("%-28s %-10s %8d %12.3f %12.3f %12.3f"
              % (name, r["cat"], r["count"], r["total_us"] / 1e3,
                 r["total_us"] / 1e3 / max(r["count"], 1),
                 r["max_us"] / 1e3))
    counters = _counters(trace)
    if counters:
        print("\ncounters:")
        for name in sorted(counters):
            print("  %-40s %g" % (name, counters[name]))
    return 0


def cmd_merge(args) -> int:
    traces = [export.load_trace(p) for p in args.inputs]
    merged = export.merge_traces(traces)
    with open(args.out, "w") as f:
        json.dump(merged, f)
    print("merged %d traces (%d events) -> %s"
          % (len(traces), len(merged["traceEvents"]), args.out))
    return 0


def cmd_diff(args) -> int:
    a = _span_totals(export.load_trace(args.a))
    b = _span_totals(export.load_trace(args.b))
    print("%-28s %12s %12s %10s" % ("span", "a_total_ms", "b_total_ms",
                                    "b/a"))
    for name in sorted(set(a) | set(b)):
        ta = a.get(name, {}).get("total_us", 0.0) / 1e3
        tb = b.get(name, {}).get("total_us", 0.0) / 1e3
        ratio = ("%10.3f" % (tb / ta)) if ta > 0 else "       new"
        print("%-28s %12.3f %12.3f %s" % (name, ta, tb, ratio))
    return 0


def cmd_validate(args) -> int:
    errors = export.validate_chrome_trace(export.load_trace(args.file))
    if errors:
        for e in errors:
            print("INVALID: %s" % e, file=sys.stderr)
        return 1
    print("%s: valid chrome trace" % args.file)
    return 0


def cmd_drift(args) -> int:
    from autodist_tpu_torch.telemetry import drift as drift_lib
    report = drift_lib.DriftReport.from_dict(
        drift_lib.load_report(args.file))
    print(report.format_table())
    return 0


def cmd_goodput(args) -> int:
    from autodist_tpu_torch.telemetry import goodput as goodput_lib
    with open(args.file) as f:
        doc = json.load(f)
    if "buckets" in doc and "traceEvents" not in doc:
        # a saved GoodputReport json, not a trace
        print(goodput_lib.GoodputReport.from_dict(doc).format_table())
        return 0
    cluster = goodput_lib.cluster_goodput(doc)
    for pid, row in sorted(cluster["workers"].items()):
        print("process %s (%s):" % (pid, row["label"]))
        print(goodput_lib.GoodputReport.from_dict(row).format_table())
    if len(cluster["workers"]) > 1:
        print("cluster: skew_ratio=%s stragglers=%s"
              % (cluster["skew_ratio"],
                 [s["label"] for s in cluster["stragglers"]] or "none"))
    return 0


def cmd_blackbox(args) -> int:
    from autodist_tpu_torch.telemetry import blackbox as blackbox_lib
    print(blackbox_lib.format_dump(blackbox_lib.load_dump(args.file)))
    return 0


def cmd_profile(args) -> int:
    from autodist_tpu_torch import const
    from autodist_tpu_torch.runtime.coordination import CoordinationClient
    from autodist_tpu_torch.telemetry import cluster as cluster_lib
    client = CoordinationClient(args.host,
                                args.port or const.ENV.ADT_COORDSVC_PORT.val)
    try:
        if args.clear:
            cluster_lib.clear_profile(client)
            print("fleet profiling flag cleared")
            return 0
        seq = cluster_lib.request_profile(client, args.first, args.last)
        print("fleet profiling window #%d posted: steps %d..%d "
              "(every polling worker captures a torch.profiler trace)"
              % (seq, args.first, args.last))
        return 0
    finally:
        client.close()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m autodist_tpu_torch.telemetry",
        description="Inspect, merge, diff and validate telemetry traces.")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("inspect", help="per-span summary of a trace file")
    p.add_argument("file")
    p.set_defaults(fn=cmd_inspect)
    p = sub.add_parser("merge", help="merge per-process traces")
    p.add_argument("out")
    p.add_argument("inputs", nargs="+")
    p.set_defaults(fn=cmd_merge)
    p = sub.add_parser("diff", help="compare two traces per span name")
    p.add_argument("a")
    p.add_argument("b")
    p.set_defaults(fn=cmd_diff)
    p = sub.add_parser("validate", help="schema-check a trace file")
    p.add_argument("file")
    p.set_defaults(fn=cmd_validate)
    p = sub.add_parser("drift", help="print a saved drift-report table")
    p.add_argument("file")
    p.set_defaults(fn=cmd_drift)
    p = sub.add_parser("goodput",
                       help="attributed wall-time buckets of a trace "
                            "(per process + cluster skew) or a saved "
                            "goodput report")
    p.add_argument("file")
    p.set_defaults(fn=cmd_goodput)
    p = sub.add_parser("blackbox",
                       help="pretty-print a flight-recorder dump")
    p.add_argument("file")
    p.set_defaults(fn=cmd_blackbox)
    p = sub.add_parser("profile",
                       help="post the fleet profiling flag "
                            "(steps FIRST..LAST) on the coordination "
                            "service")
    p.add_argument("first", type=int, nargs="?", default=0)
    p.add_argument("last", type=int, nargs="?", default=0)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--clear", action="store_true",
                   help="withdraw the flag instead")
    p.set_defaults(fn=cmd_profile)
    args = parser.parse_args(argv)
    return args.fn(args)
