"""autodist_tpu_torch's goodput attribution (``telemetry/goodput.py``) and
the Runner's tracing surface against the JAX package's:

- the same span events (``torch_telemetry_events.fill``) through both
  packages' ``breakdown_from_events``, ``build_report`` (a live recorder,
  full, sampled and with ring drops), ``report_from_trace`` and
  ``cluster_goodput`` (two processes, one 3x slower): the reports, the
  buckets and the straggler flags are equal, bit for bit (the same Python
  arithmetic on the same numbers), and so are ``format_table`` and the
  saved JSON;
- a real traced port fit (host PS, fused supersteps): the buckets sum to
  the recorded wall within 2% (the JAX test's bound), ``step_stats`` has
  ``goodput_breakdown`` and ``straggler``, the drift report joins the
  buckets, and the trace file gives the same decomposition;
- fault C15: ``AutoDist(tracing=True)`` builds and its first step writes a
  ``torch.profiler`` Chrome trace (the constructor raised ``TypeError``
  before);
- ``ADT_SNAPSHOT=1`` writes stage ``0-original-loss``: the aten op listing
  of ``ModelItem.prepare``'s one fake-tensor run.
"""
import functools
import json
import os

import numpy as np
import pytest
import torch

import torch_telemetry_events as E
from autodist_tpu.telemetry import export as jexport
from autodist_tpu.telemetry import goodput as jgoodput
from autodist_tpu.telemetry import spans as jtel
from autodist_tpu_torch.telemetry import export, goodput
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


def _pair(pid=1, slow=1.0, capacity=256, sample=1):
    """(port recorder, JAX recorder) holding the same events."""
    return (E.fill(tel.TraceRecorder(capacity=capacity, sample=sample,
                                     pid=pid, host="n%d" % pid),
                   tel.SpanEvent, slow=slow),
            E.fill(jtel.TraceRecorder(capacity=capacity, sample=sample,
                                      pid=pid, host="n%d" % pid),
                   jtel.SpanEvent, slow=slow))


def test_breakdown_equals_jax_bit_for_bit():
    rec, jrec = _pair()
    events = goodput._normalize_recorder(rec)
    assert events == jgoodput._normalize_recorder(jrec)
    got = goodput.breakdown_from_events(events)
    want = jgoodput.breakdown_from_events(events)
    assert got.to_dict() == want.to_dict()
    assert got.buckets == want.buckets            # unrounded, bit-equal
    assert (got.wall_s, got.dispatch_median_s, got.dispatch_p90_s,
            got.first_dispatch_s) == (want.wall_s, want.dispatch_median_s,
                                      want.dispatch_p90_s,
                                      want.first_dispatch_s)
    assert got.format_table() == want.format_table()
    # every bucket the events feed was charged ("other": the fit loop's
    # own time between dispatches)
    assert all(got.buckets[b] > 0 for b in (
        "compute", "collective_wait", "ps_wire", "host_input", "readback",
        "checkpoint", "other"))
    assert got.buckets["rollback_replay"] == 0.0
    assert got.coverage == pytest.approx(1.0, abs=1e-12)
    # the async writer's 20 ms overlaps the wall and is not charged
    assert got.buckets["checkpoint"] == pytest.approx(5.142857e-3, abs=1e-9)
    for name in goodput.BUCKETS + ("nope",):
        assert goodput.classify(name, "ckpt") == jgoodput.classify(name,
                                                                   "ckpt")


@pytest.mark.parametrize("mode", ["full", "sampled", "dropped"])
def test_build_report_equals_jax(mode, tmp_path):
    kw = {"full": {}, "sampled": {"sample": 4},
          "dropped": {"capacity": 20}}[mode]
    rec, jrec = _pair(**kw)
    got, want = goodput.build_report(rec), jgoodput.build_report(jrec)
    assert got.to_dict() == want.to_dict()
    assert got.approximate == (mode != "full")
    assert got.dropped_events == jrec.dropped_events
    path = got.save(str(tmp_path / "g.json"))
    jpath = want.save(str(tmp_path / "jg.json"))
    with open(path) as f, open(jpath) as g:
        assert f.read() == g.read()
    back = goodput.GoodputReport.from_dict(got.to_dict())
    assert back.to_dict() == jgoodput.GoodputReport.from_dict(
        want.to_dict()).to_dict()


def test_cluster_goodput_and_trace_reports_equal_jax():
    """Two processes, the second's dispatch work 3x: both packages'
    exports merged, then ``report_from_trace`` and ``cluster_goodput``."""
    (r1, j1), (r2, j2) = _pair(1), _pair(2, slow=3.0)
    merged = export.merge_traces([export.chrome_trace(r) for r in (r1, r2)])
    jmerged = jexport.merge_traces([jexport.chrome_trace(r)
                                    for r in (j1, j2)])
    assert json.dumps(merged, sort_keys=True) == json.dumps(jmerged,
                                                            sort_keys=True)
    got = {p: r.to_dict() for p, r in goodput.report_from_trace(
        merged).items()}
    assert got == {p: r.to_dict() for p, r in jgoodput.report_from_trace(
        merged).items()}
    for ratio in (1.5, 4.0):
        out = goodput.cluster_goodput(merged, flag_ratio=ratio)
        assert out == jgoodput.cluster_goodput(merged, flag_ratio=ratio)
    out = goodput.cluster_goodput(merged, flag_ratio=1.5)
    assert out["skew_ratio"] > 1.5
    assert [s["pid"] for s in out["stragglers"]] == [2]
    assert out["stragglers"][0]["label"] == "n2:2"
    assert goodput.cluster_goodput(merged, flag_ratio=4.0)[
        "stragglers"] == []


def _setup_ps():
    rng = np.random.RandomState(0)
    params = {"w": torch.from_numpy(rng.randn(4, 2).astype(np.float32)),
              "b": torch.zeros((2,))}

    def loss_fn(p, b):
        return torch.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)

    batches = [{"x": rng.randn(16, 4).astype(np.float32),
                "y": rng.randn(16, 2).astype(np.float32)}
               for _ in range(8)]
    return params, loss_fn, batches


def test_goodput_real_fit_coverage_within_two_percent(tmp_path):
    import autodist_tpu_torch as adt
    from autodist_tpu_torch import strategy
    from autodist_tpu_torch.resource_spec import ResourceSpec
    from autodist_tpu_torch.telemetry import cli, drift
    tel.configure("1")
    params, loss_fn, batches = _setup_ps()
    adt.reset()
    try:
        runner = adt.AutoDist(strategy_builder=strategy.PS(),
                              device="cpu").build(
            loss_fn, functools.partial(torch.optim.Adam, lr=0.1), params,
            batches[0])
        runner.init(params)
        runner.fit(list(batches), fuse_steps=4, metrics_every=2)
        report = runner.goodput_report()
        assert report is not None and not report.approximate
        assert abs(report.coverage - 1.0) < 0.02
        assert report.buckets["ps_wire"] > 0 and report.buckets["compute"] > 0
        stats = runner.step_stats()
        assert stats["goodput_breakdown"] == {
            k: round(v, 6) for k, v in report.buckets.items()}
        assert stats["straggler"]["flags"] == 0
        assert set(stats["straggler"]) == {"flagged", "flags", "last_z",
                                           "ewma_s"}
        spec = ResourceSpec.from_dict({
            "nodes": [{"address": "127.0.0.1", "cpus": [0],
                       "chief": True, "network_bandwidth": 25}],
            "slice": {"ici_bandwidth": 100}})
        dr = drift.report_for_runner(runner, resource_spec=spec)
        assert dr.goodput is not None
        assert {t.term: t for t in dr.terms}["compute"].measured_s > 0
        # with a batch the static rows come from the runner's own
        # program: one replica issues no collective, so every measured
        # row is 0 and the timing terms are the batch-less report's
        prof = runner.static_profile(batches[0])
        assert prof.num_collectives == 0 and prof.class_wire_bytes == {}
        dr_b = drift.report_for_runner(runner, resource_spec=spec,
                                       batch=batches[0])
        assert all(c.measured_wire_bytes == 0 for c in dr_b.collectives)
        assert dr_b.predicted_step_s == dr.predicted_step_s
        path = export.write_trace(str(tmp_path / "trace.json"))
        (pid, from_file), = goodput.report_from_trace(
            export.load_trace(path)).items()
        assert from_file.buckets == pytest.approx(report.buckets, abs=2e-6)
        assert cli.main(["goodput", path]) == 0
        assert cli.main(["goodput", report.save(
            str(tmp_path / "goodput.json"))]) == 0
    finally:
        adt.reset()


def test_goodput_report_none_when_tracing_off():
    import autodist_tpu_torch as adt
    from autodist_tpu_torch import strategy
    tel.configure("0")
    params, loss_fn, batches = _setup_ps()
    adt.reset()
    try:
        runner = adt.AutoDist(strategy_builder=strategy.AllReduce(),
                              device="cpu").build(
            loss_fn, functools.partial(torch.optim.Adam, lr=0.1), params,
            batches[0])
        runner.init(params)
        runner.run(batches[0])
        assert runner.goodput_report() is None
        stats = runner.step_stats()
        assert stats["goodput_breakdown"] is None
        assert stats["straggler"]["flagged"] is False
    finally:
        adt.reset()


def test_c15_autodist_tracing_writes_a_first_step_trace(monkeypatch,
                                                        tmp_path):
    """Fault C15: the port's ``AutoDist`` took no ``tracing=`` (the JAX
    constructor's, passed on to the Runner), so ``AutoDist(tracing=True)``
    raised ``TypeError``. Now the first step runs under torch.profiler
    (CPU activities on the CPU) and writes Chrome JSON under
    ``DEFAULT_TRACE_DIR/<time>/``; the later steps are not traced."""
    import autodist_tpu_torch as adt
    from autodist_tpu_torch import const as const_mod
    from autodist_tpu_torch import strategy
    from autodist_tpu_torch.models import lm
    monkeypatch.setattr(const_mod, "DEFAULT_TRACE_DIR",
                        str(tmp_path / "traces"))
    loss_fn, params, batch, _ = lm.make_train_setup(
        lm.LMConfig.tiny(), seq_len=16, batch_size=8, attention="flash")
    adt.reset()
    try:
        ad = adt.AutoDist(strategy_builder=strategy.AllReduce(),
                          device="cpu", tracing=True)
        runner = ad.build(loss_fn, functools.partial(torch.optim.Adam,
                                                     lr=1e-3),
                          params, batch)
        assert runner.last_profile_path is None
        runner.init(params)
        runner.run(batch)
        path = runner.last_profile_path
        assert path is not None and path.startswith(str(tmp_path))
        (stamp,) = os.listdir(tmp_path / "traces")
        assert path == str(tmp_path / "traces" / stamp / "trace.json")
        with open(path) as f:
            names = {e.get("name") for e in json.load(f)["traceEvents"]}
        assert "aten::addmm" in names or "aten::mm" in names
        runner.run(batch)
        runner.run(batch)
        assert runner.last_profile_path == path
        assert os.listdir(tmp_path / "traces") == [stamp]
    finally:
        adt.reset()


def test_snapshot_writes_the_original_loss_stage(monkeypatch, tmp_path):
    import autodist_tpu_torch as adt
    from autodist_tpu_torch import const as const_mod
    from autodist_tpu_torch import strategy
    from autodist_tpu_torch.models import lm
    from autodist_tpu_torch.utils import visualization_util
    monkeypatch.setenv("ADT_SNAPSHOT", "1")
    monkeypatch.setattr(const_mod, "DEFAULT_SNAPSHOT_DIR",
                        str(tmp_path / "snapshots"))
    monkeypatch.setattr(visualization_util, "_RUN_DIR", None)
    loss_fn, params, batch, _ = lm.make_train_setup(
        lm.LMConfig.tiny(), seq_len=16, batch_size=8)
    adt.reset()
    try:
        adt.AutoDist(strategy_builder=strategy.AllReduce(),
                     device="cpu").build(
            loss_fn, functools.partial(torch.optim.Adam, lr=1e-3), params,
            batch)
        (run,) = os.listdir(tmp_path / "snapshots")
        assert os.listdir(tmp_path / "snapshots" / run) == [
            "0-original-loss.txt"]
        with open(tmp_path / "snapshots" / run / "0-original-loss.txt") as f:
            lines = f.read().splitlines()
        # every line an aten op of the fake run, with its shapes: the
        # token embedding's lookup of the [8, 16] ids among them
        assert lines and all(ln.startswith("aten.") for ln in lines)
        assert any(ln.startswith("aten.embedding.default(float32[")
                   and "int64[8, 16]" in ln for ln in lines)
    finally:
        adt.reset()
    monkeypatch.delenv("ADT_SNAPSHOT")
    assert visualization_util.log_program("x", "y") is None
