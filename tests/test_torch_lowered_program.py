"""The port's step recorded as a program (``kernel/lowering.py``,
``analysis/program.py``) against the JAX package's lowering
(``Runner.lowered_text`` + ``analysis/hlo.py``), on the CPU.

- (a) The per-step class payload bytes of ``Runner.collective_schedule``
  equal JAX's ``collective_schedule(runner.lowered_text(batch))
  .per_step().class_payload_bytes()``, exactly, under AllReduce, PS and
  ZeroSharded (the MLP of ``tests/test_hlo_analysis.py`` at N = 2; the
  JAX runner on 2 of the virtual devices) and TensorParallel (``tp_lm``
  tiny at {data: 4, model: 2}: the port at 8 ranks of torch's ``fake``
  backend, the JAX runner on the session's 8 devices, global batch 8,
  seq 16), and so do the collective counts. No class differs; under
  ZeroSharded the order does (ROADMAP C).
- (b) ``CostModel.estimate(use_static_profile=True)`` with the port's
  profile equals the JAX estimate with JAX's profile at rtol 1e-12 on
  every field, given both packages the same FLOPs and activation bytes
  (as ``test_torch_simulator`` does), and the ranking test of
  ``test_hlo_analysis`` is reproduced: the profiled candidates keep
  their relative order, the order and step times equal JAX's (rtol
  1e-12), and the per-class drift is logged.
- (f) Recording has no side effects: the state, the step, the telemetry
  counters and spans, the flash kernels' launch counts, the host-PS
  store and the RNG state are bit-equal after it.
- (g) The flash kernels' custom ops give, under ``FakeTensorMode``, the
  shapes and dtypes of their plain versions' outputs (exactly).
- The parser on a hand-written program, the fused program's per-step
  schedule equal to the per-step program's, the ``3-transformed-program``
  snapshot, and the Runner recording a program once for its arguments
  and the structure of state and feed.

The N = 2 and N = 8 port programs are recorded in this process on the
``fake`` backend (``tests/torch_program_cases.py``).
"""
import logging as pylogging

import numpy as np
import pytest
import torch

import torch_program_cases as C
from autodist_tpu import strategy as jS
from autodist_tpu.analysis import hlo
from autodist_tpu_torch import strategy
from autodist_tpu_torch.analysis import program

STRATEGIES = ("AllReduce", "PS", "ZeroSharded")
FLOPS = 3.2e9
ACT = (2.5e6, 1.0e6, 4.0e4)
HBM = 1.5e9
FIELDS = ("compute_s", "allreduce_s", "ps_s", "latency_s", "mp_s",
          "hbm_bytes", "step_time_s")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = C.one_thread()
    yield
    torch.set_num_threads(n)


def _tp_setups():
    from autodist_tpu.models import tp_lm as jtp
    from autodist_tpu_torch.models import tp_lm
    j = jtp.make_train_setup(jtp.TPLMConfig.tiny(), seq_len=16,
                             batch_size=8)
    t = tp_lm.make_train_setup(tp_lm.TPLMConfig.tiny(), seq_len=16,
                               batch_size=8)
    return j, t, jtp.tp_rules(), tp_lm.tp_rules()


@pytest.fixture(scope="module")
def built():
    """Every program and profile the tests read, recorded once: the port's
    at N = 2 (MLP) and N = 8 (tp_lm), the JAX package's lowerings."""
    out = {"port": {}, "jax": {}}
    loss, params = C.mlp_port()
    with C.fake_world(2):
        for name in STRATEGIES:
            r = C.port_runner(loss, params, C.MLP_BATCH,
                              getattr(strategy, name)(), n=2)
            sched = r.collective_schedule(C.MLP_BATCH)
            fused = r.collective_schedule(C.MLP_BATCH, fuse_steps=3)
            out["port"][name] = {
                "sched": sched, "fused": fused,
                "profile": r.static_profile(C.MLP_BATCH),
                "strategy": r.distributed_step.strategy}
    jset, tset, jrules, trules = _tp_setups()
    with C.fake_world(8):
        r = C.port_runner(tset[0], tset[1], tset[2],
                          strategy.TensorParallel(2, trules), n=8)
        out["port"]["TensorParallel"] = {
            "sched": r.collective_schedule(tset[2])}
    jloss, jparams = C.mlp_jax()
    for name in STRATEGIES:
        jr = C.jax_runner(jloss, jparams, C.MLP_BATCH, getattr(jS, name)(),
                          n=2)
        out["jax"][name] = {
            "sched": hlo.collective_schedule(jr.lowered_text(C.MLP_BATCH)),
            "profile": jr.static_profile(C.MLP_BATCH),
            "strategy": jr.distributed_step.strategy}
    jr = C.jax_runner(jset[0], jset[1], jset[2],
                      jS.TensorParallel(2, jrules))
    out["jax"]["TensorParallel"] = {
        "sched": hlo.collective_schedule(jr.lowered_text(jset[2]))}
    import autodist_tpu as jadt
    jadt.reset()
    return out


# ------------------------------------------------------------------ (a)


@pytest.mark.parametrize("name", STRATEGIES + ("TensorParallel",))
def test_class_payload_bytes_equal_jax(built, name):
    got = built["port"][name]["sched"].per_step()
    want = built["jax"][name]["sched"].per_step()
    assert got.class_payload_bytes() == want.class_payload_bytes()
    assert len(got) == len(want)
    assert sorted(c.signature()[::2] for c in got) == \
        sorted(c.signature()[::2] for c in want)
    if name != "TensorParallel":
        # the groups too: both on ranks (devices) 0 and 1
        assert {c.replica_groups for c in got} == \
            {c.replica_groups for c in want} == {((0, 1),)}


def test_fused_per_step_schedule_is_the_step_schedule(built):
    """A fused program records its microsteps one after the other; its
    per-step schedule is the first microstep's, equal to the per-step
    program's (the JAX loop body)."""
    for name in STRATEGIES:
        fused = built["port"][name]["fused"]
        step = built["port"][name]["sched"]
        assert len(fused) == 3 * len(step)
        assert {c.microstep for c in fused} == {0, 1, 2}
        assert fused.per_step().signature() == step.signature()
        assert not program.compare_schedules(step, fused, "train", "fused")


# ------------------------------------------------------------------ (b)


def _cost_models(cls_pair):
    from autodist_tpu.model_item import ModelItem as JModelItem
    from autodist_tpu.resource_spec import ResourceSpec as JSpec
    from autodist_tpu_torch.model_item import ModelItem
    from autodist_tpu_torch.resource_spec import ResourceSpec
    import functools
    import optax
    jloss, jparams = C.mlp_jax()
    loss, params = C.mlp_port()
    jitem = JModelItem(loss_fn=jloss, optimizer=optax.adam(C.LR),
                       params=jparams, example_batch=C.MLP_BATCH).prepare()
    item = ModelItem(loss_fn=loss, optimizer=functools.partial(
        torch.optim.Adam, lr=C.LR), params=params,
        example_batch=C.MLP_BATCH).prepare()
    jspec = JSpec.from_dict(C.spec_dict(2))
    spec = ResourceSpec.from_dict(C.spec_dict(2))
    kw = dict(chip_kind="cpu", flops_per_step=FLOPS, hbm_capacity_bytes=HBM)
    jm, m = cls_pair[0](jitem, jspec, **kw), cls_pair[1](item, spec, **kw)
    for x in (jm, m):
        getattr(x, "_cost_model", x)._act_cache = ACT
    return jitem, item, jspec, spec, jm, m


@pytest.mark.parametrize("name", STRATEGIES)
def test_estimate_with_static_profile_equals_jax(built, name):
    from autodist_tpu.simulator.cost_model import CostModel as JCostModel
    from autodist_tpu_torch.simulator.cost_model import CostModel
    jitem, item, jspec, spec, jcm, cm = _cost_models((JCostModel, CostModel))
    jplan = getattr(jS, name)().build(jitem, jspec)
    plan = getattr(strategy, name)().build(item, spec)
    jcm.attach_static_profile(built["jax"][name]["profile"], jplan)
    cm.attach_static_profile(built["port"][name]["profile"], plan)
    want = jcm.estimate(jplan, use_static_profile=True)
    got = cm.estimate(plan, use_static_profile=True)
    for field in FIELDS:
        assert getattr(got, field) == pytest.approx(
            getattr(want, field), rel=1e-12, abs=0), field
    # the profile is used: the estimate moved off the heuristic one
    assert built["port"][name]["profile"].num_collectives == \
        built["jax"][name]["profile"].num_collectives > 0


def test_static_profile_reproduces_ranking_and_logs_drift(built, caplog):
    """test_hlo_analysis's ranking test on the port: attaching the
    measured profiles of AllReduce and PS keeps their relative order,
    orders the zoo as JAX does with JAX's profiles, and logs the
    per-class drift."""
    from autodist_tpu.simulator.simulator import Simulator as JSimulator
    from autodist_tpu_torch.simulator.simulator import Simulator
    from autodist_tpu_torch.utils.logging import get_logger
    jitem, item, jspec, spec, jsim, sim = _cost_models((JSimulator,
                                                        Simulator))
    names = ("AllReduce", "PartitionedAR", "PS", "PSLoadBalancing",
             "Parallax")
    zoo = [(n, getattr(strategy, n)().build(item, spec)) for n in names]
    jzoo = [(n, getattr(jS, n)().build(jitem, jspec)) for n in names]
    heuristic = [r.label for r in sim.rank(zoo)]
    assert heuristic == [r.label for r in jsim.rank(jzoo)]
    for n in ("AllReduce", "PS"):
        sim.attach_static_profile(built["port"][n]["profile"], dict(zoo)[n])
        jsim.attach_static_profile(built["jax"][n]["profile"], dict(jzoo)[n])
    logger = get_logger()
    logger.addHandler(caplog.handler)
    try:
        with caplog.at_level(pylogging.INFO, logger=logger.name):
            measured = sim.rank(zoo)
    finally:
        logger.removeHandler(caplog.handler)
    jmeasured = jsim.rank(jzoo)
    assert [r.label for r in measured] == [r.label for r in jmeasured]
    np.testing.assert_allclose([r.step_time_s for r in measured],
                               [r.step_time_s for r in jmeasured],
                               rtol=1e-12, atol=0)

    def restricted(order):
        return [x for x in order if x in ("AllReduce", "PS")]
    assert restricted([r.label for r in measured]) == restricted(heuristic)
    drift = [r.getMessage() for r in caplog.records
             if "static profile drift" in r.getMessage()]
    assert any("/reduce" in m for m in drift), drift


# ------------------------------------------------------------------ (f)


def _snapshot(runner):
    from autodist_tpu_torch.ops import flash_attention as fa
    from autodist_tpu_torch.telemetry import spans as tel
    st = runner.state
    leaves = [t.clone() for t in torch.utils._pytree.tree_leaves(
        (st.params, st.opt_state, st.sync_state))
        if isinstance(t, torch.Tensor)]
    store = runner.distributed_step.ps_store
    return {"leaves": leaves, "step": st.step,
            "counters": dict(tel.counters()), "gauges": dict(tel.gauges()),
            "events": len(tel.get_recorder().events()),
            "launches": fa.launch_counts(), "rng": torch.get_rng_state(),
            "store": (dict(store.stats), store.version,
                      {n: v.clone() for n, v in store.full_values().items()})
            if store is not None else None,
            "dispatches": runner.distributed_step.dispatches}


def _assert_same(a, b):
    assert len(a["leaves"]) == len(b["leaves"])
    for x, y in zip(a["leaves"], b["leaves"]):
        assert torch.equal(x, y)
    for key in ("step", "counters", "gauges", "events", "launches",
                "dispatches"):
        assert a[key] == b[key], key
    assert torch.equal(a["rng"], b["rng"])
    if a["store"] is not None:
        assert a["store"][:2] == b["store"][:2]
        for n, v in a["store"][2].items():
            assert torch.equal(v, b["store"][2][n]), n


@pytest.mark.parametrize("name", ("AllReduce", "PS", "lm_flash_bf16"))
def test_recording_has_no_side_effects(name):
    from autodist_tpu_torch.telemetry import spans as tel
    tel.configure("1")
    try:
        if name == "lm_flash_bf16":
            from autodist_tpu_torch.models import lm
            import dataclasses
            cfg = dataclasses.replace(lm.LMConfig.tiny(),
                                      dtype=torch.bfloat16)
            loss, params, batch = lm.make_train_setup(
                cfg, seq_len=16, batch_size=4, attention="flash",
                lean_head=True)[:3]
            runner = C.port_runner(loss, params, batch, strategy.AllReduce())
        else:
            loss, params = C.mlp_port()
            batch = C.MLP_BATCH
            runner = C.port_runner(loss, params, batch,
                                   getattr(strategy, name)())
        runner.run(batch)
        # the pipeline's last push lands (and its next pull is staged)
        # before the counters are read
        runner.distributed_step.flush_ps()
        before = _snapshot(runner)
        torch.manual_seed(7)
        before["rng"] = torch.get_rng_state()
        for kw in ({}, {"donate": True}, {"fuse_steps": 2},
                   {"program": "eval"}):
            runner.lowered_text(batch, **kw)
        runner.lint_lowered(batch)
        runner.memory_report(batch, fuse_steps=2, donate=False)
        _assert_same(before, _snapshot(runner))
        # and the step the recording saw still trains from that state
        runner.run(batch)
    finally:
        tel.configure("0")
        import autodist_tpu_torch as adt
        adt.reset()


# ------------------------------------------------------------------ (g)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("segments", (False, True))
def test_flash_ops_fake_outputs_match_plain_versions(dtype, segments):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from autodist_tpu_torch.ops import flash_attention as fa
    B, S, H, D = 2, 64, 2, 64
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(B, S, H, D, generator=g).to(dtype)
                   for _ in range(4))
    segs = ((torch.ones(B, S, dtype=torch.int32),) * 2 if segments
            else (None, None))
    out, lse = fa.flash_fwd_reference(q, k, v, *segs, causal=True)
    delta = fa.flash_bwd_delta(out, do)
    dq = fa.flash_bwd_dq_reference(q, k, v, do, lse, delta, *segs, True)
    dk, dv = fa.flash_bwd_dkdv_reference(q, k, v, do, lse, delta, *segs,
                                         True)
    before = fa.launch_counts()
    mode = FakeTensorMode()
    with mode:
        fq, fk, fv, fdo, flse, fdelta = (mode.from_tensor(t) for t in
                                         (q, k, v, do, lse, delta))
        fsegs = tuple(None if s is None else mode.from_tensor(s)
                      for s in segs)
        got = (torch.ops.adt.flash_fwd(fq, fk, fv, *fsegs, True)
               + (torch.ops.adt.flash_bwd_dq(fq, fk, fv, fdo, flse, fdelta,
                                             *fsegs, True),)
               + torch.ops.adt.flash_bwd_dkdv(fq, fk, fv, fdo, flse, fdelta,
                                              *fsegs, True))
    want = (out, lse, dq, dk, dv)
    assert [(tuple(t.shape), t.dtype) for t in got] == \
        [(tuple(t.shape), t.dtype) for t in want]
    assert fa.launch_counts() == before     # a fake launches nothing


# ------------------------------------------------------------- parser

FIXTURE = """\
# a hand-written program
program @train fuse_steps=2 donate=true rank=1 ranks=2 device=cuda:0
arg %0 params['w'] : f32[8,4] s0 +128 donated
arg %1 batch['x'] : bf16[16,8] s1 +256
microstep 0 {
%2 = aten.mm.default(%1, %0) : bf16[16,4] s2 +128
%3 = aten.t.default(%2) : bf16[4,16] s2
%4 = c10d.allreduce_.default(%3) : bf16[4,16] s2 bwd {collective=reduce group=[0,1] payload=128 dtype=bf16 elems=64}
_ = aten._local_scalar_dense.default(%4) : scalar {host=read}
%5 = aten._to_copy.default(%2) : f32[16,4] s3 +256 cpu {host=copy}
free s2 128
}
microstep 1 {
%6 = c10d.allreduce_.default(%0) : f32[8,4] s0 {collective=reduce group=[0,1] payload=128 dtype=f32 elems=32}
}
result %0 params['w']
result %5 metrics['loss']
end
"""


def test_parser_reads_every_record():
    prog = program.parse_program_text(FIXTURE)
    entry = prog.entry
    assert (entry.name, prog.fuse_steps, prog.num_partitions) == \
        ("train", 2, 2)
    assert prog.attrs["rank"] == "1" and prog.attrs["device"] == "cuda:0"
    assert [(a.label, a.dtype, a.shape, a.type_bytes, a.donated)
            for a in entry.args] == [
        ("params['w']", "f32", (8, 4), 128, True),
        ("batch['x']", "bf16", (16, 8), 256, False)]
    mm, t, ar, read, copy_ = entry.statements[:5]
    assert (mm.op, mm.operand_ids, mm.out_bytes, mm.alloc_bytes) == \
        ("aten.mm.default", ["1", "0"], [128], [128])
    assert t.storages == ["s2"] and t.alloc_bytes == [0]
    assert ar.backward and ar.collective.describe() == \
        "c10d.allreduce_.default(128B, groups=[[0, 1]])"
    assert (ar.collective.elem_dtype, ar.collective.payload_elems,
            ar.collective.loop_depth, ar.collective.microstep) == \
        ("bf16", 64, 1, 0)
    assert read.host == "read" and read.result_ids == []
    assert copy_.host == "copy" and copy_.devices == ["cpu"]
    assert [(f.storage, f.nbytes) for f in entry.frees] == [("s2", 128)]
    assert [(r.result_info, r.dtype, r.type_bytes, r.storage)
            for r in entry.results] == [("params['w']", "f32", 128, "s0"),
                                        ("metrics['loss']", "f32", 256,
                                         "s3")]
    sched = program.collective_schedule(prog)
    assert [c.microstep for c in sched] == [0, 1]
    assert [c.payload_bytes for c in sched.per_step()] == [128]
    assert sched.class_payload_bytes() == {"reduce": 256}
    # forgiving: junk lines parse to a smaller model
    assert program.parse_program_text("junk\n%x = \n").entry is None


def test_snapshot_writes_the_transformed_stage(monkeypatch, tmp_path):
    """``ADT_SNAPSHOT`` at build: the transform writes ``0-original-loss``
    and the first step ``3-transformed-program``, the step recorded as a
    program (the JAX ``3-transformed-stablehlo``), once."""
    import os
    from autodist_tpu_torch import const as const_mod
    from autodist_tpu_torch.utils import visualization_util
    monkeypatch.setenv("ADT_SNAPSHOT", "1")
    monkeypatch.setattr(const_mod, "DEFAULT_SNAPSHOT_DIR",
                        str(tmp_path / "snapshots"))
    monkeypatch.setattr(visualization_util, "_RUN_DIR", None)
    loss, params = C.mlp_port()
    runner = C.port_runner(loss, params, C.MLP_BATCH, strategy.AllReduce())
    monkeypatch.delenv("ADT_SNAPSHOT")       # read at build, as the JAX one
    runner.run(C.MLP_BATCH)
    runner.run(C.MLP_BATCH)
    (run,) = os.listdir(tmp_path / "snapshots")
    assert sorted(os.listdir(tmp_path / "snapshots" / run)) == [
        "0-original-loss.txt", "3-transformed-program.txt"]
    with open(tmp_path / "snapshots" / run /
              "3-transformed-program.txt") as f:
        prog = program.parse_program_text(f.read())
    assert [a.label for a in prog.entry.args][:4] == [
        "params['w1']", "params['b1']", "params['w2']", "params['b2']"]
    assert any(st.op == "aten.mm.default" and st.backward
               for st in prog.entry.statements)
    import autodist_tpu_torch as adt
    adt.reset()


def test_runner_records_a_program_once_for_its_structure(monkeypatch):
    """The Runner keeps each program it recorded, by its arguments and the
    structure (paths, shapes, dtypes, devices) of state and feed: a
    recording runs on fake tensors, so a step that changes the values
    leaves the program as it was, and another feed shape records anew."""
    from autodist_tpu_torch.kernel import lowering
    calls = []
    real = lowering.record_step

    def counted(*args, **kw):
        calls.append(kw)
        return real(*args, **kw)
    monkeypatch.setattr(lowering, "record_step", counted)
    loss, params = C.mlp_port()
    runner = C.port_runner(loss, params, C.MLP_BATCH, strategy.AllReduce())
    report = runner.memory_report(C.MLP_BATCH)
    text = runner.lowered_text(C.MLP_BATCH, donate=True)
    assert len(calls) == 1
    runner.run(C.MLP_BATCH)
    assert runner.lowered_text(C.MLP_BATCH, donate=True) == text
    assert len(calls) == 1
    assert memory_estimate(text) == report["peak_hbm_bytes"]
    half = {k: v[:16] for k, v in C.MLP_BATCH.items()}
    assert runner.lowered_text(half, donate=True) != text
    runner.lowered_text(C.MLP_BATCH)            # donate=False: another
    assert len(calls) == 3
    import autodist_tpu_torch as adt
    adt.reset()


def memory_estimate(text):
    from autodist_tpu_torch.analysis import memory
    return round(memory.estimate_from_text(text).peak_hbm_bytes)


def test_a_binding_thread_leaves_anothers_bindings_as_they_are():
    """A step recorded beside a build: the recording's thread enters and
    leaves ``mesh.bind`` (a plan without a mesh binds nothing) while the
    build's trace holds ``mesh.recording()``'s size-1 axes, and leaves
    after it. The trace's axes go when the trace ends, and none is left
    bound (a snapshot restore put them back for good, and a later
    pipe_lm step ran pipelined at pp 1)."""
    import threading
    from autodist_tpu_torch.parallel import mesh as mesh_lib
    entered, traced = threading.Event(), threading.Event()

    def recording_thread():
        with mesh_lib.bind(None):
            entered.set()
            traced.wait(10)
    t = threading.Thread(target=recording_thread)
    with mesh_lib.recording():
        assert mesh_lib.binding("pipe") is not None
        t.start()
        assert entered.wait(10)
    traced.set()
    t.join(10)
    assert not t.is_alive()
    assert [mesh_lib.binding(a) for a in mesh_lib.MODEL_PARALLEL_AXES] == \
        [None] * len(mesh_lib.MODEL_PARALLEL_AXES)
