"""autodist_tpu_torch's pre-compile plan verifier against the JAX
package's (``analysis/rules.py``, ``analysis/memory.py``'s plan half,
``AutoDist(validate=)``):

- every mutation of ``tests/test_analysis.py``'s table, applied to the
  JAX package's clean AllReduce plan of its embedding model and read into
  the port's IR, gives the same ``(code, severity, variable)`` set from
  the port's ``verify`` over the same variables and cluster as from the
  JAX ``verify``;
- every candidate builder of ``AutoStrategy`` (the default pool and the
  model-parallel ones) over the zoo models (lm, bert, DLRM, NCF, tp_lm,
  pipe_lm, moe_lm tiny), on the port's own items, gives the JAX set on
  the JAX items, on one node and on a two-level topology — but for
  ADT308, which reads the port's layout (a DenseGeneral bias the port
  holds 1-D passes PowerSGD uncompressed, where flax's 2-D one is
  compressed; ROADMAP's drift point);
- ``AutoDist(validate="error")`` raises ``StrategyVerificationError``
  with the JAX codes before the plan is compiled (``build`` and
  ``build_step``), ``"warn"`` builds and logs, ``"off"`` skips, and any
  other mode raises the JAX ``ValueError``; the plan memory gate's
  ADT501 stops an over-budget plan.
"""
import functools
import json

import numpy as np
import pytest
import torch

import autodist_tpu_torch as adt
import test_analysis as jtable
import torch_plan_models as M
from autodist_tpu.analysis import cli as jcli
from autodist_tpu.analysis.rules import verify as jverify
from autodist_tpu.model_item import ModelItem as JModelItem
from autodist_tpu.strategy.auto_strategy import \
    default_candidates as jdefault_candidates
from autodist_tpu.strategy.auto_strategy import \
    mp_candidates as jmp_candidates
from autodist_tpu_torch import strategy
from autodist_tpu_torch.analysis.diagnostics import StrategyVerificationError
from autodist_tpu_torch.analysis.memory import GIB, plan_memory_report
from autodist_tpu_torch.analysis.rules import verify
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy.auto_strategy import (default_candidates,
                                                       mp_candidates)
from autodist_tpu_torch.strategy.base import Strategy, StrategyBuilder


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = M.one_thread()
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reset():
    yield
    adt.reset()


def _set(diags, names=None):
    names = names or {}
    return {(d.code, int(d.severity), names.get(d.var, d.var))
            for d in diags}


def _to_port(jplan) -> Strategy:
    return Strategy.from_dict(json.loads(json.dumps(jplan.to_dict())))


# ------------------------------------------------------ the mutation table


class _Shape:
    def __init__(self, shape):
        self.shape = shape


class _Stub:
    var_infos = {"embedding": _Shape((512, 16))}


MUTATIONS = [m[0] for m in jtable._mutations(_Stub())]


@pytest.fixture(scope="module")
def emb():
    """The JAX table's embedding model: (JAX item, port list item over its
    variables, JAX spec, port spec of the same 4 devices)."""
    loss_fn, params, batch, _ = jcli.EXAMPLES["sentiment_classifier"]()
    jitem = JModelItem(loss_fn=loss_fn, params=params,
                       example_batch=batch).prepare()
    jspec, tspec = M.specs("one")
    return jitem, M.JaxListItem(jitem, _NoTrace()), jspec, tspec


class _NoTrace:
    optimizer_spec = None
    trace_costs = None
    example_batch = None


def test_clean_plans_are_the_same_bytes(emb):
    jitem, item, jspec, tspec = emb
    jplan = jtable.clean_strategy(jitem, jspec)
    tplan = strategy.AllReduce().build(item, tspec)
    tplan.id = jplan.id
    assert json.dumps(tplan.to_dict(), sort_keys=True) == \
        json.dumps(jplan.to_dict(), sort_keys=True)
    assert verify(strategy.AllReduce().build(item, tspec), item,
                  tspec) == []


@pytest.mark.parametrize("name", MUTATIONS)
def test_mutation_gives_the_jax_diagnostics(emb, name):
    jitem, item, jspec, tspec = emb
    mutate, code = {m[0]: m[1:] for m in jtable._mutations(jitem)}[name]
    jplan = jtable.clean_strategy(jitem, jspec)
    mutate(jplan)
    want = _set(jverify(jplan, jitem, jspec))
    got = _set(verify(_to_port(jplan), item, tspec))
    assert got == want
    assert code in {c for c, sev, _ in got if sev >= 2}


# -------------------------------------------------- the zoo's candidates


def _powersgd_layout_delta(plan, titem, names):
    """The ADT308 warnings the port's layout adds under PowerSGD: a
    variable the port holds at rank < 2 whose flax shape has rank >= 2."""
    out = set()
    for node in plan.node_config:
        sync = node.synchronizer
        info = titem.var_infos.get(node.var_name)
        if (sync is None or info is None or node.partitioner
                or node.mp_axes or info.sparse
                or not (getattr(sync, "compressor", "") or "").startswith(
                    "PowerSGDCompressor")):
            continue
        if len(info.shape) < 2 <= len(info.flax_shape):
            out.add(("ADT308", 1, names[node.var_name]))
    return out


@pytest.mark.parametrize("spec", ["one", "two"])
@pytest.mark.parametrize("model", M.MODELS)
def test_zoo_candidates_give_the_jax_diagnostics(model, spec):
    jitem, titem, _ = M.items(model)
    jspec, tspec = M.specs(spec)
    names = M.port_name_map(titem)
    jpool = jdefault_candidates() + jmp_candidates(jitem, jspec)
    tpool = default_candidates() + mp_candidates(titem, tspec)
    assert [label for label, _ in tpool] == [label for label, _ in jpool]
    checked = 0
    for (label, jbuilder), (_, builder) in zip(jpool, tpool):
        try:
            jplan = jbuilder.build(jitem, jspec)
        except Exception as e:  # noqa: BLE001 — the port must refuse too
            with pytest.raises(type(e)):
                builder.build(titem, tspec)
            continue
        plan = builder.build(titem, tspec)
        want = _set(jverify(jplan, jitem, jspec))
        got = _set(verify(plan, titem, tspec), names)
        assert got == want | _powersgd_layout_delta(plan, titem, names), \
            label
        checked += 1
    assert checked >= len(jdefault_candidates())


# ------------------------------------------------------ AutoDist(validate)

ONE_CPU = {"nodes": [{"address": "127.0.0.1", "chief": True, "cpus": [0]}]}


def _regression():
    torch.manual_seed(0)
    params = {"w": torch.randn(8, 4), "b": torch.zeros(4)}

    def loss_fn(p, batch):
        return ((batch["x"] @ p["w"] + p["b"] - batch["y"]) ** 2).mean()

    batch = {"x": np.random.RandomState(0).randn(8, 8).astype(np.float32),
             "y": np.zeros((8, 4), np.float32)}
    return loss_fn, params, batch


class _Broken(StrategyBuilder):
    """AllReduce's plan with one PS destination on a host the spec lacks
    (ADT303)."""

    def build(self, model_item, resource_spec):
        from autodist_tpu_torch.strategy.base import PSSynchronizer
        plan = strategy.AllReduce().build(model_item, resource_spec)
        plan.node_config[0].synchronizer = PSSynchronizer(
            reduction_destination="10.9.9.9:CPU:0")
        return plan


def _autodist(builder, validate, spec=ONE_CPU):
    return adt.AutoDist(strategy_builder=builder, validate=validate,
                        device="cpu", resource_spec=ResourceSpec.from_dict(
                            spec))


def _no_compile(monkeypatch):
    from autodist_tpu_torch.strategy import base

    def compile_(self, plan):
        raise AssertionError("the plan reached the compiler")
    monkeypatch.setattr(base.StrategyCompiler, "compile", compile_)


def test_validate_error_raises_before_the_compile(monkeypatch):
    loss_fn, params, batch = _regression()
    ad = _autodist(_Broken(), "error")
    _no_compile(monkeypatch)
    with pytest.raises(StrategyVerificationError) as ei:
        ad.build(loss_fn, functools.partial(torch.optim.SGD, lr=0.1),
                 params, batch)
    assert {d.code for d in ei.value.diagnostics} == {"ADT303"}


def test_validate_error_covers_build_step(monkeypatch):
    state = {"w": torch.zeros(4)}

    def step_fn(s, batch):
        return {"w": s["w"] + batch["x"].sum(0)}, {}

    ad = _autodist(_Broken(), "error")
    _no_compile(monkeypatch)
    with pytest.raises(StrategyVerificationError) as ei:
        ad.build_step(step_fn, state, {"x": np.ones((2, 4), np.float32)})
    assert "ADT303" in {d.code for d in ei.value.diagnostics}


def test_validate_warn_builds_and_off_skips(monkeypatch):
    from autodist_tpu_torch.utils import logging
    loss_fn, params, batch = _regression()
    sgd = functools.partial(torch.optim.SGD, lr=0.1)
    logged = []
    monkeypatch.setattr(logging, "warning",
                        lambda msg, *a, **kw: logged.append(msg % a))
    # PowerSGD on the 1-D bias: ADT308, a warning only
    psgd = strategy.AllReduce(compressor="PowerSGDCompressor:2")
    ad = _autodist(psgd, "warn")
    assert ad.build(loss_fn, sgd, params, batch) is not None
    assert any("ADT308" in line for line in logged)
    assert ad.last_memory_report["diagnostics"] == []
    assert ad.last_memory_report["peak_hbm_bytes"] > 0
    adt.reset()
    logged.clear()
    ad = _autodist(psgd, "off")
    ad.build(loss_fn, sgd, params, batch)
    assert not any("ADT308" in line for line in logged)
    assert ad.last_memory_report is None


def test_validate_rejects_a_bogus_mode():
    with pytest.raises(ValueError, match="validate must be 'error', 'warn' "
                                         "or 'off'"):
        adt.AutoDist(validate="bogus", device="cpu")


def test_memory_gate_refuses_an_over_budget_plan(monkeypatch):
    """A card of 1 KiB (``slice.hbm_gib``): the plan-level report projects
    an OOM (ADT501) and ``validate="error"`` refuses the plan."""
    loss_fn, params, batch = _regression()
    spec = dict(ONE_CPU, slice={"hbm_gib": 1024 / GIB})
    ad = _autodist(strategy.AllReduce(), "error", spec)
    _no_compile(monkeypatch)
    with pytest.raises(StrategyVerificationError) as ei:
        ad.build(loss_fn, functools.partial(torch.optim.Adam, lr=0.1),
                 params, batch)
    assert [d.code for d in ei.value.diagnostics] == ["ADT501"]


@pytest.mark.parametrize("fuse_steps", [1, 4])
@pytest.mark.parametrize("model", ["lm", "dlrm"])
def test_plan_peak_equals_jax(model, fuse_steps):
    """The plan gate's peak over the JAX inputs equals the JAX one within
    1e-12 (the activation estimate given to both: the traces' difference
    is ``test_torch_simulator``'s), under host PS (the fused carry's
    optimizer state with ``fuse_steps``) and ZeRO, and so do the
    ADT501/502 verdicts against budgets around it."""
    from autodist_tpu.analysis.memory import budget_diagnostics as jbudget
    from autodist_tpu.analysis.memory import plan_peak_hbm as jpeak
    from autodist_tpu.simulator.cost_model import CostModel as JCostModel
    from autodist_tpu.strategy import PS as JPS
    from autodist_tpu.strategy import ZeroSharded as JZeroSharded
    from autodist_tpu_torch.analysis.memory import (budget_diagnostics,
                                                    plan_peak_hbm)
    from autodist_tpu_torch.simulator.cost_model import CostModel
    jitem, _, item = M.items(model)
    jspec, tspec = M.specs("one")
    for jbuilder, builder in [(JPS(), strategy.PS()),
                              (JZeroSharded(), strategy.ZeroSharded())]:
        jplan, plan = jbuilder.build(jitem, jspec), builder.build(item,
                                                                   tspec)
        jcm, cm = JCostModel(jitem, jspec), CostModel(item, tspec)
        jcm._act_cache = cm._act_cache = (3e5, 1e5, 1e3)
        want = jpeak(jplan, jitem, jspec, fuse_steps, cost_model=jcm)
        got = plan_peak_hbm(plan, item, tspec, fuse_steps, cost_model=cm)
        assert got == pytest.approx(want, rel=1e-12)
        for budget in (0.5 * want, 1.05 * want, 2 * want):
            assert [d.code for d in budget_diagnostics(got, budget)] == \
                [d.code for d in jbudget(want, budget)]
    report = plan_memory_report(plan, item, tspec, budget_bytes=GIB)
    assert report["budget_gib"] == 1.0 and report["diagnostics"] == []
