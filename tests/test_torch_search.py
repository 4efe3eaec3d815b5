"""autodist_tpu_torch's per-variable plan search and ``AutoStrategy``
against the JAX package's (``search/{space,scoring,trace,drivers}.py``,
``strategy/auto_strategy.py``), given the JAX inputs (the JAX item's
variables, the same ``flops_per_step`` and activation estimate,
``chip_kind="cpu"`` and one memory capacity):

- at a fixed seed, ``run_search`` (beam and annealing) visits the same
  plans in the same order as the JAX run — the two traces are equal,
  record for record — and returns the same strategy JSON, byte for byte,
  on the zoo models (lm, bert, DLRM, NCF, tp_lm, pipe_lm, moe_lm tiny);
- ``AutoStrategy`` ranks the same labels in the same order with the same
  step times and picks the same plan, byte for byte; its plan is stable
  across two builds, and the search on the port's own item (the port's
  layouts and names) builds a plan the port verifies clean;
- ``SearchConfig``'s refusals and an all-OOM search behave as in JAX.

Test-only overrides: ``flops_per_step`` (a constructor argument of both
packages' cost models) and the cost models' ``_act_cache`` (the
activation estimate), set to the same numbers on both sides.
"""
import json

import pytest
import torch

import torch_plan_models as M
from autodist_tpu.search.drivers import SearchConfig as JSearchConfig
from autodist_tpu.search.drivers import run_search as jrun_search
from autodist_tpu.simulator.simulator import Simulator as JSimulator
from autodist_tpu.strategy.auto_strategy import AutoStrategy as JAutoStrategy
from autodist_tpu.strategy.auto_strategy import \
    default_candidates as jdefault_candidates
from autodist_tpu_torch.analysis.diagnostics import Severity
from autodist_tpu_torch.analysis.rules import verify
from autodist_tpu_torch.search.drivers import SearchConfig, run_search
from autodist_tpu_torch.simulator.simulator import Simulator
from autodist_tpu_torch.strategy.auto_strategy import (SEARCH_LABEL,
                                                       AutoStrategy,
                                                       default_candidates)

FLOPS = 3.2e12
ACT = (2.5e8, 1.0e8, 4.0e6)
HBM = 1.5e9
KW = dict(chip_kind="cpu", flops_per_step=FLOPS, hbm_capacity_bytes=HBM)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = M.one_thread()
    yield
    torch.set_num_threads(n)


def _json(plan):
    d = plan.to_dict()
    d.pop("id")
    return json.dumps(d, sort_keys=True)


def _sims(jitem, item, jspec, tspec):
    jsim, sim = JSimulator(jitem, jspec, **KW), Simulator(item, tspec, **KW)
    for s in (jsim, sim):
        s._cost_model._act_cache = ACT
    return jsim, sim


def _zoo(jitem, item, jspec, tspec):
    jbuilt, built = [], []
    for (label, jb), (_, b) in zip(jdefault_candidates(),
                                   default_candidates()):
        jbuilt.append((label, jb.build(jitem, jspec)))
        built.append((label, b.build(item, tspec)))
    return jbuilt, built


@pytest.mark.parametrize("algo", ["beam", "anneal"])
@pytest.mark.parametrize("model", M.MODELS)
def test_fixed_seed_walks_the_jax_plans(model, algo):
    jitem, _, item = M.items(model)
    jspec, tspec = M.specs("one")
    jsim, sim = _sims(jitem, item, jspec, tspec)
    jbuilt, built = _zoo(jitem, item, jspec, tspec)
    cfg = dict(algo=algo, budget=48, seed=3)
    want = jrun_search(jitem, jspec, config=JSearchConfig(**cfg),
                       simulator=jsim, extra_seeds=jbuilt)
    got = run_search(item, tspec, config=SearchConfig(**cfg),
                     simulator=sim, extra_seeds=built)
    assert got.trace.to_dict() == want.trace.to_dict()
    assert got.ok == want.ok
    assert _json(got.strategy) == _json(want.strategy)
    assert got.candidates == want.candidates <= 48


def test_search_on_a_two_level_topology_walks_the_jax_plans():
    jitem, _, item = M.items("lm")
    jspec, tspec = M.specs("two")
    jsim, sim = _sims(jitem, item, jspec, tspec)
    want = jrun_search(jitem, jspec, config=JSearchConfig(budget=48, seed=5),
                       simulator=jsim)
    got = run_search(item, tspec, config=SearchConfig(budget=48, seed=5),
                     simulator=sim)
    assert got.trace.to_dict() == want.trace.to_dict()
    assert _json(got.strategy) == _json(want.strategy)


@pytest.mark.parametrize("model", M.MODELS)
def test_autostrategy_picks_the_jax_plan(model):
    jitem, _, item = M.items(model)
    jspec, tspec = M.specs("one")
    # a memory capacity every plan fits: the two traces' activation
    # estimates differ (test_torch_simulator), which moves only hbm_bytes
    kw = dict(KW, hbm_capacity_bytes=1e15)
    jauto = JAutoStrategy(search=JSearchConfig(budget=32, seed=1), **kw)
    auto = AutoStrategy(search=SearchConfig(budget=32, seed=1), **kw)
    want, got = jauto.build(jitem, jspec), auto.build(item, tspec)
    assert _json(got) == _json(want)
    jr, r = jauto.last_ranking, auto.last_ranking
    assert [x.label for x in r] == [x.label for x in jr]
    assert [x.step_time_s for x in r] == pytest.approx(
        [x.step_time_s for x in jr], rel=1e-12)
    assert r.skipped == jr.skipped
    assert r.search_trace.to_dict() == jr.search_trace.to_dict()
    assert _json(auto.build(item, tspec)) == _json(got)


def test_autostrategy_on_the_port_item_verifies_clean():
    """On the port's own item (its names, layouts and trace), the picked
    plan covers every trainable variable and verifies without an error;
    the search entry, when it wins, sorts first on a tie."""
    _, titem, _ = M.items("bert")
    _, tspec = M.specs("one")
    auto = AutoStrategy(search=SearchConfig(budget=32, seed=0))
    plan = auto.build(titem, tspec)
    assert {n.var_name for n in plan.node_config} >= set(
        titem.trainable_var_names)
    assert not [d for d in verify(plan, titem, tspec)
                if d.severity >= Severity.ERROR]
    labels = [r.label for r in auto.last_ranking]
    assert SEARCH_LABEL in labels and len(labels) > 10


def test_search_config_refuses_as_jax():
    for kw in ({"algo": "bogus"}, {"budget": 0}):
        with pytest.raises(ValueError) as want:
            JSearchConfig(**kw)
        with pytest.raises(ValueError) as got:
            SearchConfig(**kw)
        assert str(got.value) == str(want.value)
    assert SearchConfig.from_dict(SearchConfig(seed=4).to_dict()) == \
        SearchConfig(seed=4)


def test_all_oom_search_prunes_every_candidate_as_jax():
    jitem, _, item = M.items("ncf")
    jspec, tspec = M.specs("one")
    kw = dict(KW, hbm_capacity_bytes=1.0)
    jsim, sim = JSimulator(jitem, jspec, **kw), Simulator(item, tspec, **kw)
    cfg = dict(budget=24, seed=0)
    want = jrun_search(jitem, jspec, config=JSearchConfig(**cfg),
                       simulator=jsim)
    got = run_search(item, tspec, config=SearchConfig(**cfg), simulator=sim)
    assert got.ok is want.ok is False
    assert got.trace.prune_reasons() == want.trace.prune_reasons() == {
        "oom:ADT501": got.candidates}
