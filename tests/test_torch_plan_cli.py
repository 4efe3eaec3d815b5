"""The port's three command lines against the JAX package's, in process
(``main(argv)``, the ``python -m`` entry points' body):

- ``autodist_tpu_torch.analysis``: for every bundled example and every
  builder both CLIs offer it (with the memory gate at 16 GiB), the exit
  codes and the JSON documents are equal; two drift points show and are
  pinned by name: "Rules and the search read the port's layouts" (ADT309
  names the port's variable, ``embed.embedding`` for
  ``params/embed/embedding``, on lm1b's partitioned-AllReduce builders:
  equal once the port's names are mapped) and "Activation bytes by the
  trace's op set" (the memory gate's peak: equal once the port's cost
  model is given JAX's activation estimate). ``--numerics``,
  ``--compute-dtype``, ``--topology`` (ADT524 for a malformed file),
  ``--strategy-json`` (ADT301 at deserialize), ``--list`` and the usage
  errors match too; ``--programs`` lints the port's own recorded dumps
  (exit 0, ADT503 on a fused un-donated dump, ADT501 on a tiny budget;
  its parity with the JAX CLI: ``tests/test_torch_program_lints.py``).
- ``autodist_tpu_torch.search``: equal JSON (timings aside) on the
  examples whose products are all 2-D (linear_regression,
  sentiment_classifier); on the others the drift point "Exact FLOPs"
  moves the pricing (named in ``EXACT_FLOPS``), and the JSON is equal
  once the port's cost model takes JAX's FLOPs and activation estimate.
  ``--dump-plan`` writes a plan that ``analysis --strategy-json`` lints
  clean, and ``--trace-out`` the deterministic trace with its header.
- ``autodist_tpu_torch.telemetry``: ``inspect``, ``diff``, ``merge``,
  ``validate``, ``goodput``, ``drift``, ``blackbox`` and ``profile``
  print the same text with the same exit codes (``profile`` names the
  profiler it arms).
"""
import contextlib
import functools
import io
import json

import pytest
import torch

import torch_telemetry_events as E
from autodist_tpu.analysis import cli as jcli
from autodist_tpu.search import cli as jscli
from autodist_tpu.telemetry import cli as jtcli
from autodist_tpu_torch.analysis import cli
from autodist_tpu_torch.search import cli as scli
from autodist_tpu_torch.telemetry import cli as tcli

# examples whose search pricing differs through the exact FLOPs
EXACT_FLOPS = ("image_classifier", "lm1b", "moe_lm", "pipe_lm", "tp_lm")
# (example, builder) pairs whose ADT309 names the port's variable
PORT_NAMES = {("lm1b", "PartitionedAR"), ("lm1b", "RandomAxisPartitionAR")}

ITEMS = {}   # (package, id of the example's loss) -> prepared ModelItem


@pytest.fixture(autouse=True, scope="module")
def _cached_examples():
    """Each example built and prepared once a package (the CLIs build the
    item afresh each call), on one torch thread."""
    import autodist_tpu.model_item as jmi
    import autodist_tpu_torch.model_item as tmi
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    for mod in (jcli, cli):
        for name, make in list(mod.EXAMPLES.items()):
            mp.setitem(mod.EXAMPLES, name, functools.lru_cache(None)(make))
    for pkg, mod in (("jax", jmi), ("port", tmi)):
        real = mod.ModelItem

        class Cached:
            def __init__(self, _real=real, _pkg=pkg, **kw):
                self._real, self._pkg, self._kw = _real, _pkg, kw

            def prepare(self):
                key = (self._pkg, id(self._kw["loss_fn"]))
                if key not in ITEMS:
                    ITEMS[key] = self._real(**self._kw).prepare()
                return ITEMS[key]
        mp.setattr(mod, "ModelItem", Cached)
    yield
    mp.undo()
    torch.set_num_threads(n)


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _items(example):
    """(JAX item, port item) of an example (built through the CLIs)."""
    keys = [("jax", id(jcli.EXAMPLES[example]()[0])),
            ("port", id(cli.EXAMPLES[example]()[0]))]
    return ITEMS[keys[0]], ITEMS[keys[1]]


@contextlib.contextmanager
def _jax_estimates(example, flops=True):
    """The port's cost model given the JAX model's activation estimate
    and, with ``flops``, its FLOPs, both packages pricing one chip (the
    JAX CLI's spec prices a TPU generation, the port's an H100: the drift
    point "The card table"): the inputs the drift points change."""
    from autodist_tpu.simulator.cost_model import CostModel as JCostModel
    from autodist_tpu_torch.simulator.cost_model import CostModel
    jitem, _ = _items(example)
    jcm = JCostModel(jitem, jcli.default_spec(4))
    act, fl = jcm._activation_profile(), jcm.flops_per_step()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(CostModel, "_activation_profile", lambda self: act)
        if flops:
            mp.setattr(CostModel, "flops_per_step", lambda self: fl)
            for cls in (CostModel, JCostModel):
                mp.setattr(cls, "_guess_chip", lambda self: "cpu")
        yield


@pytest.mark.parametrize("example", sorted(jcli.EXAMPLES))
def test_analysis_json_equals_jax_for_every_builder(example):
    mp_rules = jcli.EXAMPLES[example]()[3]
    builders = sorted(jcli._builders(mp_rules))
    assert builders == sorted(cli._builders(cli.EXAMPLES[example]()[3]))
    named = {}
    for builder in builders:
        argv = [example, "--strategy", builder, "--json",
                "--hbm-budget", "16"]
        jrc, jout, jerr = _run(jcli.main, argv)
        rc, out, err = _run(cli.main, argv)
        assert (rc, bool(err)) == (jrc, bool(jerr)), builder
        got, want = json.loads(out), json.loads(jout)
        if (example, builder) in PORT_NAMES:
            _, item = _items(example)
            names = {n: v.collective_name for n, v in item.var_infos.items()}
            assert any(d["var"] in names for d in got["diagnostics"])
            for d in got["diagnostics"]:
                d["var"] = names.get(d["var"], d["var"])
            named[builder] = True
        # the memory gate's peak holds the activation estimate
        assert got.pop("memory").keys() == want.pop("memory").keys()
        assert got == want, builder
    assert set(named) == {b for e, b in PORT_NAMES if e == example}
    # the memory gate, given JAX's activation estimate: the same document
    argv = [example, "--strategy", "AllReduce", "--json", "--hbm-budget",
            "0.0005", "--fuse-steps", "2"]
    with _jax_estimates(example, flops=False):
        assert _run(cli.main, argv)[:2] == _run(jcli.main, argv)[:2]


@pytest.mark.parametrize("argv", [
    ["lm1b", "--strategy", "AllReduce", "--numerics", "--compute-dtype",
     "bf16"],
    ["lm1b", "--strategy", "PS", "--numerics", "--json"],
    ["tp_lm", "--strategy", "TensorParallel", "--quiet"],
    ["linear_regression", "--strategy", "PS", "--devices", "2"],
    ["sentiment_classifier", "--strategy", "Parallax", "--format", "json"],
    [], ["nope", "--strategy", "PS"],
    ["linear_regression", "--strategy", "Bogus"],
    ["linear_regression", "--strategy", "TensorParallel"],
    ["--list"],
])
def test_analysis_flags_and_usage_equal_jax(argv):
    jrc, jout, jerr = _run(jcli.main, argv)
    rc, out, err = _run(cli.main, argv)
    assert (rc, out) == (jrc, jout)
    assert err.replace("autodist_tpu_torch", "autodist_tpu") == jerr


def test_analysis_topology_and_strategy_json_equal_jax(tmp_path):
    good = tmp_path / "topo.yaml"
    good.write_text("hosts: 2\nchips_per_host: 2\nlevels:\n"
                    "  - {name: ici, bandwidth_gbps: 400}\n"
                    "  - {name: dcn, bandwidth_gbps: 25}\n")
    bad = tmp_path / "bad.yaml"
    bad.write_text("hosts: 0\nchips_per_host: 2\nlevels: []\n")
    gossip = tmp_path / "gossip.json"
    gossip.write_text(json.dumps({
        "id": "x", "graph_config": {"replicas": ["127.0.0.1:GPU:0"]},
        "node_config": [{"var_name": "w",
                         "synchronizer": {"kind": "Gossip"}}]}))
    for argv, code in (
            (["lm1b", "--strategy", "AllReduce", "--topology", str(good),
              "--json"], 0),
            (["lm1b", "--strategy", "AllReduce", "--topology", str(bad),
              "--json"], 1),
            (["sentiment_classifier", "--strategy-json", str(gossip),
              "--json"], 1)):
        jrc, jout, _ = _run(jcli.main, argv)
        rc, out, _ = _run(cli.main, argv)
        assert rc == jrc == code
        assert json.loads(out) == json.loads(jout)


def test_programs_mode_lints_a_recorded_dump(tmp_path):
    """``--programs`` on the port's own dumps (``Runner.lowered_text``
    written to files): a clean step exits 0 and prints its peak; the fused
    ``donate=False`` superstep under ``--fuse-steps 2`` warns ADT503 (exit
    0), as the JAX CLI does; a 1e-6 GiB budget is ADT501 (exit 1)."""
    import autodist_tpu_torch as adt
    from autodist_tpu_torch import strategy
    from autodist_tpu_torch.models import lm
    loss_fn, params, batch, _ = lm.make_train_setup(
        lm.LMConfig.tiny(), seq_len=16, batch_size=8)
    adt.reset()
    try:
        runner = adt.AutoDist(strategy_builder=strategy.AllReduce(),
                              device="cpu").build(
            loss_fn, functools.partial(torch.optim.Adam, lr=1e-3), params,
            batch)
        runner.init(params)
        step = tmp_path / "step.txt"
        step.write_text(runner.lowered_text(batch, donate=True))
        fused = tmp_path / "fused.txt"
        fused.write_text(runner.lowered_text(batch, fuse_steps=2))
    finally:
        adt.reset()
    rc, out, _ = _run(cli.main, ["--programs", str(step)])
    assert rc == 0 and out.startswith("%s: peak " % step)
    rc, out, _ = _run(cli.main, ["--programs", str(fused), "--fuse-steps",
                                 "2", "--format", "json"])
    doc = json.loads(out)
    assert rc == 0 and doc["errors"] == 0
    assert [d["code"] for d in doc["programs"][0]["diagnostics"]] == \
        ["ADT503"]
    rc, out, _ = _run(cli.main, ["--programs", str(step), "--hbm-budget",
                                 "0.000001"])
    assert rc == 1 and "ADT501" in out


def _search(main, argv):
    rc, out, err = _run(main, argv)
    doc = json.loads(out) if out else None
    for key in ("search_s", "candidates_per_s", "plan_file", "trace_file"):
        if doc is not None:
            doc.pop(key, None)
    return rc, doc


@pytest.mark.parametrize("example", sorted(jcli.EXAMPLES))
def test_search_json_equals_jax(example):
    argv = [example, "--budget", "12", "--format", "json"]
    jrc, want = _search(jscli.main, argv)
    rc, got = _search(scli.main, argv)
    assert rc == jrc == 0
    assert got["beats_zoo"] and want["beats_zoo"]
    if example in EXACT_FLOPS:
        moved = {k for k in want if got[k] != want[k]}
        assert moved and moved <= {"chosen", "score_ms", "est_step_ms",
                                   "zoo_score_ms", "zoo_best"}, moved
        with _jax_estimates(example):
            jrc, want = _search(jscli.main, argv)
            rc, got = _search(scli.main, argv)
    assert got == want


def test_search_dump_plan_lints_clean_and_traces(tmp_path):
    plan, trace = str(tmp_path / "plan.json"), str(tmp_path / "t.json")
    rc, out, _ = _run(scli.main, ["lm1b", "--budget", "10", "--dump-plan",
                                  plan, "--trace-out", trace, "--seed", "3"])
    assert rc == 0 and ("plan:  %s" % plan) in out
    assert _run(cli.main, ["lm1b", "--strategy-json", plan])[0] == 0
    with open(trace) as f:
        doc = json.load(f)
    assert doc["header"]["config"]["seed"] == 3
    assert doc["header"]["config"]["budget"] == 10
    assert _run(scli.main, ["nope"])[0] == _run(jscli.main, ["nope"])[0] \
        == 2
    assert _run(scli.main, ["--list"])[1] == _run(jscli.main, ["--list"])[1]


def _trace_files(tmp_path):
    """The same two-process telemetry, exported by each package."""
    from autodist_tpu.telemetry import export as jexport
    from autodist_tpu.telemetry import spans as jtel
    from autodist_tpu_torch.telemetry import export
    from autodist_tpu_torch.telemetry import spans as tel
    paths = {}
    for pkg, t, ex in (("port", tel, export), ("jax", jtel, jexport)):
        for pid, slow in ((1, 1.0), (2, 3.0)):
            rec = E.fill(t.TraceRecorder(capacity=256, sample=1, pid=pid,
                                         host="n%d" % pid), t.SpanEvent,
                         slow=slow)
            paths[pkg, pid] = ex.write_trace(
                str(tmp_path / pkg / ("p%d.json" % pid)), rec)
    return paths


def test_telemetry_cli_equals_jax(tmp_path):
    from autodist_tpu.telemetry import drift as jdrift
    from autodist_tpu_torch.telemetry import blackbox, goodput
    from autodist_tpu_torch.telemetry import spans as tel
    paths = _trace_files(tmp_path)
    merged = {pkg: str(tmp_path / ("%s-merged.json" % pkg))
              for pkg in ("port", "jax")}
    for pkg, main in (("port", tcli.main), ("jax", jtcli.main)):
        rc, out, _ = _run(main, ["merge", merged[pkg], paths[pkg, 1],
                                 paths[pkg, 2]])
        assert rc == 0 and out.startswith("merged 2 traces")
    with open(merged["port"]) as f, open(merged["jax"]) as g:
        assert f.read() == g.read()
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [{"ph": "X", "name": "x",
                                                "pid": 1, "ts": "later"}]}))
    report = goodput.build_report(E.fill(
        tel.TraceRecorder(capacity=256, sample=1, pid=1, host="h"),
        tel.SpanEvent))
    gpath = report.save(str(tmp_path / "goodput.json"))
    dr = jdrift.DriftReport(
        "s1", 4, 0.0125, 0.01, [jdrift.TermDrift("step", 0.0125, 0.01)],
        [jdrift.CollectiveDrift("reduce", 1e6, 1.5e6)], {}, {},
        wire={"bytes_quantized": 10, "bytes_saved": 30,
              "reduction_x": 4.0, "per_step_quantized": 2.5},
        levels=[{"level": "ici", "predicted_bytes": 10,
                 "measured_bytes": None, "ratio": None}])
    dpath = dr.save(str(tmp_path / "drift.json"))
    box = blackbox.FlightRecorder(capacity_events=16)
    box.record("runner.straggler", z=5.5, step=3)
    bpath = box.dump("test", directory=str(tmp_path / "bb"))
    assert bpath is not None
    cases = [["inspect", merged["port"]], ["inspect", paths["port", 1]],
             ["diff", paths["port", 1], paths["port", 2]],
             ["validate", merged["port"]], ["validate", str(bad)],
             ["goodput", merged["port"]], ["goodput", paths["port", 2]],
             ["goodput", gpath], ["drift", dpath], ["blackbox", bpath]]
    for argv in cases:
        assert _run(tcli.main, argv) == _run(jtcli.main, argv), argv
    assert _run(tcli.main, ["validate", str(bad)])[0] == 1
    assert "stragglers=['n2:2']" in _run(tcli.main,
                                          ["goodput", merged["port"]])[1]


def test_telemetry_profile_posts_the_window(tmp_path):
    import socket
    from autodist_tpu_torch.runtime.coordination import (CoordinationClient,
                                                         CoordinationServer)
    from autodist_tpu_torch.telemetry import cluster
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    srv = CoordinationServer(port=port)
    srv.start()
    client = CoordinationClient("127.0.0.1", port)
    try:
        rc, out, _ = _run(tcli.main, ["profile", "4", "5", "--port",
                                      str(port)])
        assert rc == 0
        assert out == ("fleet profiling window #1 posted: steps 4..5 "
                       "(every polling worker captures a torch.profiler "
                       "trace)\n")
        assert cluster.read_profile_window(client) == (1, 4, 5)
        rc, out, _ = _run(tcli.main, ["profile", "--clear", "--port",
                                      str(port)])
        assert (rc, out) == (0, "fleet profiling flag cleared\n")
        assert cluster.read_profile_window(client) is None
    finally:
        client.close()
        srv.stop()


def test_the_new_modules_leave_jax_and_the_jax_package_out():
    import subprocess
    import sys
    code = ("import sys\n"
            "import autodist_tpu_torch.telemetry.goodput, "
            "autodist_tpu_torch.telemetry.export, "
            "autodist_tpu_torch.telemetry.cluster, "
            "autodist_tpu_torch.telemetry.drift, "
            "autodist_tpu_torch.telemetry.cli, "
            "autodist_tpu_torch.telemetry.__main__, "
            "autodist_tpu_torch.analysis.cli, "
            "autodist_tpu_torch.analysis.__main__, "
            "autodist_tpu_torch.search.cli, "
            "autodist_tpu_torch.search.__main__, "
            "autodist_tpu_torch.utils.visualization_util\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'autodist_tpu'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
