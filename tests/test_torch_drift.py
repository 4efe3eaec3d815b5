"""autodist_tpu_torch's drift report (``telemetry/drift.py``) against the
JAX package's, on the JAX inputs of the cost-model parity tests
(``test_torch_simulator``: the JAX item's variables, the same
``flops_per_step`` and activation estimate, ``chip_kind="cpu"`` and one
memory capacity), the same recorded spans and counters
(``torch_telemetry_events.fill``) and the same static collective profile:

- ``build_report(...).to_dict()`` equals JAX's within rtol 1e-12 for every
  ``AutoStrategy`` candidate, on one node and on a two-level topology
  (the per-level rows), with and without the static profile;
- ``format_table`` gives the same text, ``save``/``load``/``from_dict``
  round-trip, and ``fit_calibration`` fits the same scales;
- ``report_for_runner(batch=...)`` takes its collective rows from the
  runner's ``static_profile(batch)``, asked with the spec's topology.
"""
import math

import pytest
import torch

import torch_plan_models as M
import torch_telemetry_events as E
from autodist_tpu.simulator.cost_model import CostModel as JCostModel
from autodist_tpu.simulator.cost_model import \
    StaticCollectiveProfile as JProfile
from autodist_tpu.strategy.auto_strategy import \
    default_candidates as jdefault_candidates
from autodist_tpu.strategy.auto_strategy import \
    mp_candidates as jmp_candidates
from autodist_tpu.telemetry import drift as jdrift
from autodist_tpu.telemetry import spans as jtel
from autodist_tpu_torch.simulator.cost_model import (CostModel,
                                                     StaticCollectiveProfile)
from autodist_tpu_torch.strategy.auto_strategy import (default_candidates,
                                                       mp_candidates)
from autodist_tpu_torch.telemetry import drift
from autodist_tpu_torch.telemetry import spans as tel

FLOPS = 3.2e12
ACT = (2.5e8, 1.0e8, 4.0e6)
HBM = 1.5e9
KW = dict(chip_kind="cpu", flops_per_step=FLOPS, hbm_capacity_bytes=HBM)
# the lowering's measured wire bytes a step, by collective class and by
# link level (the two-level topology's)
CLASSES = {"reduce": 3.5e6, "gather": 1.25e6, "all_to_all": 4.0e5}
LEVELS = {"ici": 4.0e6, "dcn": 1.15e6}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = M.one_thread()
    yield
    torch.set_num_threads(n)


def _recorders():
    return (E.fill(tel.TraceRecorder(capacity=256, sample=1, pid=1,
                                     host="h"), tel.SpanEvent),
            E.fill(jtel.TraceRecorder(capacity=256, sample=1, pid=1,
                                      host="h"), jtel.SpanEvent))


def _pools(model, spec):
    jitem, _, item = M.items(model)
    jspec, tspec = M.specs(spec)
    jcm, cm = JCostModel(jitem, jspec, **KW), CostModel(item, tspec, **KW)
    for m in (jcm, cm):
        m._act_cache = ACT
    pool = []
    for (label, jb), (_, b) in zip(
            jdefault_candidates() + jmp_candidates(jitem, jspec),
            default_candidates() + mp_candidates(item, tspec)):
        try:
            jplan = jb.build(jitem, jspec)
        except Exception:  # noqa: BLE001 — both refuse (plan verify test)
            continue
        plan = b.build(item, tspec)
        plan.id = jplan.id = "drift-%s" % label
        pool.append((label, jplan, plan))
    return jcm, cm, pool


def _close(got, want, where=""):
    """Equal structure, equal strings, numbers within rtol 1e-12."""
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _close(got[k], want[k], "%s.%s" % (where, k))
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, "%s[%d]" % (where, i))
    elif isinstance(want, float) and not isinstance(want, bool):
        assert got == pytest.approx(want, rel=1e-12, abs=0) or (
            math.isinf(want) and got == want), where
    else:
        assert got == want, where


@pytest.mark.parametrize("spec", ["one", "two"])
@pytest.mark.parametrize("model", ["lm", "dlrm", "tp_lm"])
def test_reports_equal_jax(model, spec):
    jcm, cm, pool = _pools(model, spec)
    rec, jrec = _recorders()
    jprof = JProfile(dict(CLASSES), dict(CLASSES), 3,
                     level_wire_bytes=dict(LEVELS) if spec == "two" else {})
    prof = StaticCollectiveProfile(dict(CLASSES), dict(CLASSES), 3,
                                   level_wire_bytes=dict(LEVELS)
                                   if spec == "two" else {})
    reports, jreports = [], []
    for label, jplan, plan in pool:
        for with_profile in (False, True):
            got = drift.build_report(cm, plan, recorder=rec,
                                     static_profile=prof if with_profile
                                     else None)
            want = jdrift.build_report(jcm, jplan, recorder=jrec,
                                       static_profile=jprof if with_profile
                                       else None)
            _close(got.to_dict(), want.to_dict(), label)
            assert got.format_table() == want.format_table(), label
            assert (got.levels is not None) == (spec == "two")
            assert bool(got.collectives) == with_profile
        reports.append(got)
        jreports.append(want)
    assert reports[0].wire == {"bytes_quantized": 1000, "bytes_saved": 3000,
                               "reduction_x": 4.0,
                               "per_step_quantized": 250.0}
    assert reports[0].goodput is not None and reports[0].num_steps == 4
    cal = drift.fit_calibration(reports[:6])
    jcal = jdrift.fit_calibration(jreports[:6])
    _close(cal.to_dict(), jcal.to_dict(), "calibration")
    assert all(math.isfinite(s) for s in cal.to_dict().values())


def test_report_round_trip_and_refusals(tmp_path):
    jcm, cm, pool = _pools("lm", "one")
    rec, jrec = _recorders()
    label, jplan, plan = pool[0]
    got = drift.build_report(cm, plan, recorder=rec)
    path = got.save(str(tmp_path / "r.json"))
    back = drift.DriftReport.from_dict(drift.load_report(path))
    assert back.to_dict() == got.to_dict()
    jback = jdrift.DriftReport.from_dict(jdrift.load_report(path))
    assert jback.format_table() == back.format_table()
    empty = drift.build_report(cm, plan, recorder=tel.TraceRecorder(
        capacity=4, sample=1, pid=1, host="h"))
    assert empty.measured_step_s is None and empty.goodput is None
    with pytest.raises(ValueError, match="no report carries"):
        drift.fit_calibration([empty])

    # with a batch, the report's collective rows come from the runner's
    # own static profile (Runner.static_profile), asked with the spec's
    # topology
    prof = StaticCollectiveProfile(dict(CLASSES), dict(CLASSES), 3)
    asked = []

    class _DStep:
        model_item, strategy = cm._item, plan
        device, num_replicas = torch.device("cpu"), 1

    class _Runner:
        distributed_step = _DStep()

        def static_profile(self, batch, topology=None):
            asked.append((batch, topology))
            return prof
    got = drift.report_for_runner(_Runner(), resource_spec=cm._spec,
                                  batch={"x": 1}, recorder=rec)
    assert asked == [({"x": 1}, cm._spec.topology())]
    want = drift.build_report(cm, plan, recorder=rec, static_profile=prof)
    assert got.collectives and \
        got.to_dict()["collectives"] == want.to_dict()["collectives"]
