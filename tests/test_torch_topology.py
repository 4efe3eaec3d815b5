"""autodist_tpu_torch's topology-aware communication analyzer
(``analysis/topology.py``, ADT520-525) against the JAX package's, on a
dryrun 8-host x 8-card pod with a slow inter-host level:

- the byte algebra (``flat_inter_bytes``, ``hier_inter_bytes``,
  ``group_geometry``, ``op_level_bytes``), ``resolve_schedule`` and
  ``describe_levels`` give the JAX values;
- the lowered-schedule lints (``lint_schedule``: ADT520 on a flat reduce
  across hosts, silence on leader subgroups and on the hierarchical
  composition, ADT521 on a strided group, ADT523 over a level's budget,
  ADT525 on a device outside the topology), ``schedule_level_bytes`` and
  ``StaticCollectiveProfile.from_schedule``'s level rows give the JAX
  diagnostics, messages included, and bytes;
- the plan-level pass (``verify_topology``, ``plan_level_bytes``, the
  cost model's per-level pricing) over one variable list under every
  schedule pin gives the JAX results, and ``lint_stage_composition``
  (ADT522) judges the synthesized compositions as JAX does;
- a malformed topology raises the JAX ``TopologyConfigError`` and its
  ADT524 diagnostic.
"""
import collections

import pytest
import torch

from autodist_tpu.analysis import topology as jtopo
from autodist_tpu.model_item import VarInfo as JVarInfo
from autodist_tpu.parallel import collectives as jcoll
from autodist_tpu.resource_spec import ResourceSpec as JSpec
from autodist_tpu.resource_spec import Topology as JTopology
from autodist_tpu.resource_spec import \
    TopologyConfigError as JTopologyConfigError
from autodist_tpu.simulator.cost_model import CostModel as JCostModel
from autodist_tpu.simulator.cost_model import \
    StaticCollectiveProfile as JProfile
from autodist_tpu.strategy import AllReduce as JAllReduce
from autodist_tpu.strategy import ZeroSharded as JZeroSharded
from autodist_tpu_torch.analysis import topology as topo
from autodist_tpu_torch.model_item import VarInfo
from autodist_tpu_torch.parallel import collectives as coll
from autodist_tpu_torch.resource_spec import ResourceSpec, Topology
from autodist_tpu_torch.resource_spec import TopologyConfigError
from autodist_tpu_torch.simulator.cost_model import (CostModel,
                                                     StaticCollectiveProfile)
from autodist_tpu_torch.strategy import AllReduce, ZeroSharded

POD64 = {"hosts": 8, "chips_per_host": 8,
         "levels": [{"name": "ici", "bandwidth_gbps": 400},
                    {"name": "dcn", "bandwidth_gbps": 25}]}
BUDGET = dict(POD64, levels=[POD64["levels"][0],
                             dict(POD64["levels"][1], budget_ms=1e-9)])
FLAT64 = (tuple(range(64)),)
LEADERS = (tuple(range(0, 64, 8)),)
INTRA = tuple(tuple(range(h * 8, (h + 1) * 8)) for h in range(8))
STRIDED = (tuple(range(0, 64, 8)) + tuple(range(1, 64, 8)),)

Op = collections.namedtuple(
    "Op", "kind op payload_bytes replica_groups lineno group_size")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sched(*entries):
    return [Op(k, k, b, g, i, len(g[0]) if g else 1)
            for i, (k, b, g) in enumerate(entries)]


def _diags(ds):
    return [(d.code, int(d.severity), d.var, d.message, d.fixit) for d in ds]


def _both(d):
    return JTopology.from_dict(d), Topology.from_dict(d)


SCHEDULES = {
    "flat": _sched(("reduce", 4096, FLAT64)),
    "leaders": _sched(("reduce", 4096, LEADERS)),
    "hier": _sched(("scatter", 4096, INTRA), ("reduce", 512, LEADERS),
                   ("gather", 512, INTRA)),
    "strided": _sched(("gather", 256, STRIDED)),
    "outside": _sched(("reduce", 256, ((0, 1, 2, 999),))),
    "ungrouped": _sched(("reduce", 1024, ())),
}


@pytest.mark.parametrize("budget", [False, True])
@pytest.mark.parametrize("name", list(SCHEDULES))
def test_lowered_schedule_lints_and_bytes_equal_jax(name, budget):
    jt, t = _both(BUDGET if budget else POD64)
    sched = SCHEDULES[name]
    assert _diags(topo.lint_schedule(sched, t, label="a.hlo")) == \
        _diags(jtopo.lint_schedule(sched, jt, label="a.hlo"))
    for k in (1, 16):
        assert topo.schedule_level_bytes(sched, t, k) == \
            jtopo.schedule_level_bytes(sched, jt, k)
    got = StaticCollectiveProfile.from_schedule(sched, 8, topology=t)
    want = JProfile.from_schedule(sched, 8, topology=jt)
    assert vars(got) == vars(want)
    assert topo.describe_levels(got.level_wire_bytes, t) == \
        jtopo.describe_levels(want.level_wire_bytes, jt)


def test_byte_algebra_equals_jax():
    jt, t = _both(POD64)
    for args in [(4096.0, 64, 8), (4096.0, 8, 8), (10.0, 1, 0)]:
        assert topo.flat_inter_bytes(*args) == jtopo.flat_inter_bytes(*args)
    for args in [(4096.0, 8, 8), (4096.0, 8, 1), (1.0, 1, 4)]:
        assert topo.hier_inter_bytes(*args) == jtopo.hier_inter_bytes(*args)
    for group in FLAT64 + LEADERS + INTRA[:2] + STRIDED + ((0, 999),):
        assert topo.group_geometry(group, t) == \
            jtopo.group_geometry(group, jt)
    for kind in ("reduce", "gather", "scatter", "permute", "alltoall"):
        for groups in (FLAT64, INTRA, LEADERS):
            assert topo.op_level_bytes(kind, 2048.0, groups, t) == \
                jtopo.op_level_bytes(kind, 2048.0, groups, jt)
    for choice in ("auto", "ring", "rhd", "hier", None):
        for t_, jt_ in ((t, jt), (None, None)):
            for n in (1, 8, 64):
                assert topo.resolve_schedule(choice, t_, n) == \
                    jtopo.resolve_schedule(choice, jt_, n)


def test_stage_compositions_judged_as_jax():
    cands = coll.synthesize_collective_candidates(
        "g0", ("ici", "dcn"), intra_axes=("ici",), inter_axes=("dcn",))
    jcands = jcoll.synthesize_collective_candidates(
        "g0", ("ici", "dcn"), intra_axes=("ici",), inter_axes=("dcn",))
    wrong = coll.CollectiveOp(kind="all_gather", unit="g0", axes=("dcn",))
    jwrong = jcoll.CollectiveOp(kind="all_gather", unit="g0", axes=("dcn",))
    for stages, jstages in [
            (cands["hier"], jcands["hier"]), (cands["rhd"], jcands["rhd"]),
            (cands["hier"][:2], jcands["hier"][:2]),
            (cands["hier"][:2] + (wrong,), jcands["hier"][:2] + (jwrong,))]:
        assert _diags(topo.lint_stage_composition(
            stages, cands["ring"][0], var="w")) == _diags(
            jtopo.lint_stage_composition(jstages, jcands["ring"][0],
                                         var="w"))


class _Item:
    def __init__(self, infos):
        self.var_infos = {i.name: i for i in infos}
        self.trainable_var_names = list(self.var_infos)

    def total_bytes(self):
        return sum(i.byte_size for i in self.var_infos.values())


def _pod(topology=POD64):
    """The pod's spec (one node a host, 8 devices each) in both packages,
    with the topology attached."""
    d = {"nodes": [{"address": "10.0.0.%d" % (h + 1), "chief": h == 0,
                    "cpus": list(range(topology["chips_per_host"]))}
                   for h in range(topology["hosts"])]}
    jt, t = _both(topology)
    return (JSpec.from_dict(d).set_topology(jt),
            ResourceSpec.from_dict(d).set_topology(t))


VARS = [("W", (256, 256)), ("b", (256,)), ("E", (64, 32))]


def _pin(plan, schedule):
    for node in plan.node_config:
        sync = node.synchronizer
        if sync is not None and sync.kind == "AllReduce":
            sync.schedule = schedule
    return plan


@pytest.mark.parametrize("builder", ["AllReduce", "ZeroSharded"])
@pytest.mark.parametrize("schedule",
                         ["auto", "ring", "rhd", "hier", "bogus"])
def test_plan_level_pass_equals_jax(schedule, builder):
    jspec, spec = _pod()
    jitem = _Item([JVarInfo(n, s, "float32") for n, s in VARS])
    item = _Item([VarInfo(n, s, "float32") for n, s in VARS])
    jb, b = {"AllReduce": (JAllReduce(), AllReduce()),
             "ZeroSharded": (JZeroSharded(), ZeroSharded())}[builder]
    jplan = _pin(jb.build(jitem, jspec), schedule)
    plan = _pin(b.build(item, spec), schedule)
    assert _diags(topo.verify_topology(plan, item, spec)) == \
        _diags(jtopo.verify_topology(jplan, jitem, jspec))
    assert topo.plan_level_bytes(plan, item, spec.topology()) == \
        jtopo.plan_level_bytes(jplan, jitem, jspec.topology())
    if schedule != "bogus":
        kw = dict(chip_kind="cpu", flops_per_step=1e9)
        want = JCostModel(jitem, jspec, **kw)
        got = CostModel(item, spec, **kw)
        want._act_cache = got._act_cache = (1e6, 1e5, 1e4)
        assert vars(got.estimate(plan)) == vars(want.estimate(jplan))
    if schedule == "ring" and builder == "AllReduce":
        assert "ADT520" in {d.code for d in topo.verify_topology(
            plan, item, spec)}


def test_replicas_beyond_the_topology_are_adt525():
    jspec, spec = _pod()
    small = {"hosts": 2, "chips_per_host": 2, "levels": POD64["levels"]}
    jitem = _Item([JVarInfo(n, s, "float32") for n, s in VARS])
    item = _Item([VarInfo(n, s, "float32") for n, s in VARS])
    jplan, plan = JAllReduce().build(jitem, jspec), AllReduce().build(
        item, spec)
    jt, t = _both(small)
    jspec.set_topology(jt)
    spec.set_topology(t)
    got = topo.verify_topology(plan, item, spec)
    assert _diags(got) == _diags(jtopo.verify_topology(jplan, jitem, jspec))
    assert [d.code for d in got] == ["ADT525"]


@pytest.mark.parametrize("bad", [
    {"hosts": 0, "chips_per_host": 8},
    {"hosts": 2, "chips_per_host": 8,
     "levels": [{"name": "ici", "bandwidth_gbps": -25}]},
    {"hosts": 2, "chips_per_host": 8, "chips": 63}])
def test_malformed_topology_raises_the_jax_error(bad):
    with pytest.raises(JTopologyConfigError) as want:
        JTopology.from_dict(bad)
    with pytest.raises(TopologyConfigError) as got:
        Topology.from_dict(bad)
    assert str(got.value) == str(want.value)
    assert _diags([topo.diagnostic_for_config_error(got.value)]) == \
        _diags([jtopo.diagnostic_for_config_error(want.value)])
