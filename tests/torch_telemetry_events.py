"""Deterministic telemetry for the observability parity tests
(``test_torch_goodput``, ``test_torch_telemetry_export``,
``test_torch_drift``, ``test_torch_plan_cli``): the same span events,
counters, gauges and histograms written into either package's
``TraceRecorder``, at fixed timestamps (no clock is read), so that the two
packages' reports and exports can be compared value for value.
"""

MS = 1_000_000   # ns


def fill(rec, span_event, steps=4, slow=1.0):
    """Record a traced fit of ``steps`` dispatches on thread 0 (inside a
    ``runner.fit`` span): each dispatch a feed, a ``dstep.dispatch`` with
    a nested ``ps.pull``, a barrier wait and a readback after it, the
    first dispatch longer (the build); a checkpoint write on the training
    thread and an async writer's on thread 1 (which overlaps the wall);
    instants; and a registry of counters, gauges and histograms.
    ``slow`` scales the dispatch work (a straggler). ``span_event`` is
    the package's ``spans.SpanEvent``."""
    rec.epoch_offset_ns = 0
    rec._threads.update({101: 0, 202: 1})
    rec._thread_names.update({0: "MainThread", 1: "adt-ckpt-writer"})
    ids = iter(range(1, 10_000))
    events = []

    def add(name, cat, ts, dur, tid, parent, **args):
        sid = next(ids)
        events.append(span_event(name, cat, int(ts), int(dur), tid, sid,
                                 parent, args or None))
        return sid

    fit = next(ids)
    t = 1_000 * MS
    for step in range(steps):
        work = int((40 if step == 0 else 7) * MS * slow)
        d0 = t
        disp = next(ids)
        sub = []
        sub.append(span_event("runner.feed", "runner", d0 + MS // 10,
                              MS // 2, 0, next(ids), disp, None))
        ds = next(ids)
        sub.append(span_event("ps.pull", "ps", d0 + MS, 3 * MS // 4, 0,
                              next(ids), ds, {"bytes": 4096}))
        sub.append(span_event("dstep.dispatch", "dstep",
                              d0 + 3 * MS // 4, work, 0, ds, disp, None))
        sub.append(span_event("runner.barrier", "runner",
                              d0 + MS + work, MS // 3, 0, next(ids), disp,
                              {"step": step + 1, "staleness": 1}))
        sub.append(span_event("runner.readback", "runner",
                              d0 + 2 * MS + work, MS // 5, 0, next(ids),
                              disp, {"microsteps": 1}))
        dur = 3 * MS + work
        events.extend(sub)
        events.append(span_event("runner.dispatch", "runner", d0, dur, 0,
                                 disp, fit, {"microsteps": 1, "sync": True,
                                             "step": step}))
        events.append(span_event("telemetry.straggler_clear", "runner",
                                 d0 + dur, 0, 0, next(ids), fit,
                                 {"step": step}))
        t = d0 + dur + MS // 4
    add("ckpt.write", "ckpt", t, 5 * MS, 0, fit, step=steps)
    add("ckpt.write", "ckpt", t + MS, 20 * MS, 1, 0, step=steps)
    add("ckpt.gc", "ckpt", t + 5 * MS, MS // 7, 0, fit)
    t += 6 * MS
    events.append(span_event("runner.fit", "runner", 1_000 * MS - MS,
                             t - 999 * MS, 0, fit, 0,
                             {"fuse_steps": 1, "metrics_every": 1}))
    for e in sorted(events, key=lambda e: e.ts_ns + e.dur_ns):
        rec._append(e)
    rec.counter_add("runner.steps", float(steps))
    rec.counter_add("ps.bytes_pulled", 4096.0 * steps)
    rec.counter_add("wire.bytes_quantized", 1000.0)
    rec.counter_add("wire.bytes_saved", 3000.0)
    rec.counter_add("serve/odd name.x", 2.5)
    rec.gauge_set("telemetry.straggler", 0.0)
    rec.gauge_set("serve.queue_depth", 3.25)
    for v in (0.5, 1.5, 2.5, 40.0, 250.0, 7.75):
        rec.hist_observe("serve.latency_ms", v)
    return rec
