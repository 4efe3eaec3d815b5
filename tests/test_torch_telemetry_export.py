"""autodist_tpu_torch's trace and metric export (``telemetry/export.py``)
against the JAX package's:

- on the same events, counters, gauges and histograms
  (``torch_telemetry_events.fill``), ``chrome_trace`` gives the same JSON
  (clock offset and error applied), ``metrics_text`` the same bytes (with
  labels that need escaping), ``merge_traces`` the same merge of two
  processes whose pids collide, and ``write_trace``/``load_trace`` the
  same file;
- ``validate_chrome_trace`` reports the same violations on the JAX
  tests' malformed traces;
- publish and scrape over the port's native coordination service: the
  blob round trip, the merged two-track trace, ages, the missing
  workers' gauge; the JAX ``scrape_cluster`` on the same service gives
  the same scrape (its age readings aside).
"""
import json
import socket
import time

import pytest
import torch

import torch_telemetry_events as E
from autodist_tpu.telemetry import export as jexport
from autodist_tpu.telemetry import spans as jtel
from autodist_tpu_torch.telemetry import export
from autodist_tpu_torch.telemetry import spans as tel


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _telemetry_isolation():
    yield
    tel.configure(None)
    tel.reset()
    jtel.configure(None)
    jtel.reset()


def _pair(pid=1, host=None):
    host = host or "n%d" % pid
    rec = E.fill(tel.TraceRecorder(capacity=256, sample=1, pid=pid,
                                   host=host), tel.SpanEvent)
    jrec = E.fill(jtel.TraceRecorder(capacity=256, sample=1, pid=pid,
                                     host=host), jtel.SpanEvent)
    for r in (rec, jrec):
        # the offset cancels the wall-clock anchor, so the export reads no
        # clock (its counter samples' stamp is the last event's end)
        r.epoch_offset_ns = 2_000_000
        r.clock_offset_ns = -2_000_000
        r.clock_error_ns = 150_000
    return rec, jrec


def _dump(trace):
    return json.dumps(trace, sort_keys=True)


def test_chrome_trace_equals_jax():
    rec, jrec = _pair()
    for label in (None, "w0 (n1:1)"):
        got = export.chrome_trace(rec, label=label)
        assert _dump(got) == _dump(jexport.chrome_trace(jrec, label=label))
    assert export.validate_chrome_trace(got) == []
    assert got["otherData"]["clock_offset_ns"] == -2_000_000
    xs = [e for e in got["traceEvents"] if e["ph"] == "X"]
    first = min(xs, key=lambda e: e["ts"])
    assert first["ts"] == 999 * E.MS / 1e3
    cs = {e["name"] for e in got["traceEvents"] if e["ph"] == "C"}
    assert {"runner.steps", "serve.latency_ms.p50",
            "serve.latency_ms.p99"} <= cs


@pytest.mark.parametrize("labels", [None, {"worker": "w0"},
                                    {"worker": 'a "b"\\c\nd', "host": "h"}])
def test_metrics_text_equals_jax_byte_for_byte(labels):
    rec, jrec = _pair()
    got = export.metrics_text(rec, labels=labels)
    assert got == jexport.metrics_text(jrec, labels=labels)
    assert "adt_runner_steps_total" in got
    assert "adt_serve_odd_name_x_total" in got
    assert 'adt_serve_latency_ms_bucket' in got and "+Inf" in got


def test_merge_and_files_equal_jax(tmp_path):
    """Two single-process hosts with the same pid: the merge keeps a track
    each; the written files are the same bytes."""
    (r1, j1), (r2, j2) = _pair(7, "a"), _pair(7, "b")
    merged = export.merge_traces([export.chrome_trace(r1),
                                  export.chrome_trace(r2),
                                  {"traceEvents": [{"ph": "X", "name": "x",
                                                    "pid": 7, "tid": 0,
                                                    "ts": 1.0, "dur": 1.0}]}])
    want = jexport.merge_traces([jexport.chrome_trace(j1),
                                 jexport.chrome_trace(j2),
                                 {"traceEvents": [{"ph": "X", "name": "x",
                                                   "pid": 7, "tid": 0,
                                                   "ts": 1.0, "dur": 1.0}]}])
    assert _dump(merged) == _dump(want)
    assert len({e["pid"] for e in merged["traceEvents"]}) == 3
    path = export.write_trace(str(tmp_path / "a" / "t.json"), r1)
    jpath = jexport.write_trace(str(tmp_path / "b" / "t.json"), j1)
    with open(path) as f, open(jpath) as g:
        assert f.read() == g.read()
    assert export.load_trace(path) == jexport.load_trace(jpath)


MALFORMED = [
    {},
    [],
    {"traceEvents": "x"},
    {"traceEvents": []},
    {"traceEvents": [{"ph": "X", "name": "x", "pid": 1, "tid": 0,
                      "ts": "soon", "dur": 1.0}]},
    {"traceEvents": [{"ph": "M", "name": "m", "pid": 1}]},
    {"traceEvents": [{"ph": "Q", "name": "q", "pid": 1}, {"name": "n"},
                     {"ph": "X", "pid": 1, "ts": 0, "dur": 0, "tid": 0}]},
    {"traceEvents": [{"bogus": i} for i in range(1000)]},
]


@pytest.mark.parametrize("case", range(len(MALFORMED)))
def test_validate_reports_the_jax_violations(case):
    got = export.validate_chrome_trace(MALFORMED[case])
    assert got == jexport.validate_chrome_trace(MALFORMED[case])
    assert got   # every one of them is malformed


def test_counters_only_export_is_valid():
    rec = tel.TraceRecorder(capacity=4, sample=1, pid=3, host="h")
    rec.counter_add("ps.pulls", 1)
    assert export.validate_chrome_trace(export.chrome_trace(rec)) == []


@pytest.fixture()
def service():
    from autodist_tpu_torch.runtime.coordination import (CoordinationClient,
                                                         CoordinationServer)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    srv = CoordinationServer(port=port)
    srv.start()
    client = CoordinationClient("127.0.0.1", port)
    yield client
    client.close()
    srv.stop()


def test_publish_and_scrape_over_the_native_service(service):
    (r1, _), (r2, _) = _pair(1), _pair(2)
    assert export.publish_telemetry(service, "w1", recorder=r1) == 1
    assert export.publish_telemetry(service, "w1", recorder=r1) == 2
    export.publish_telemetry(service, "w2", recorder=r2)
    blob = export.fetch_telemetry(service, "w1")
    assert blob["worker"] == "w1" and blob["pid"] == 1
    assert blob["clock"] == {"offset_ns": -2_000_000, "error_ns": 150_000}
    assert export.fetch_telemetry(service, "ghost") is None
    time.sleep(0.02)
    scraped = export.scrape_cluster(service, ["w1", "w2", "ghost"])
    assert scraped["workers"] == ["w1", "w2"]
    assert scraped["missing"] == ["ghost"]
    assert all(a >= 0.0 for a in scraped["scrape_age_s"].values())
    trace = scraped["trace"]
    assert export.validate_chrome_trace(trace) == []
    assert {e["pid"] for e in trace["traceEvents"]} == {1, 2}
    text = scraped["metrics_text"]
    assert 'adt_runner_steps_total{worker="w1"} 4' in text
    assert "adt_cluster_workers_missing 1" in text
    assert tel.get_recorder().gauges()["cluster.workers_missing"] == 1.0
    # the JAX scrape over the same service reads the same blobs the same
    # way (the age readings are taken at another instant)
    want = jexport.scrape_cluster(service, ["w1", "w2", "ghost"])

    def steady(d):
        d = dict(d, scrape_age_s=None, metrics_text=[
            ln for ln in d["metrics_text"].splitlines()
            if not ln.startswith("adt_cluster_scrape_age_seconds")])
        return _dump(d)
    assert steady(scraped) == steady(want)
