"""autodist_tpu_torch's rhd and hierarchical all-reduce schedules against
the JAX package's.

The port's ranks are spawned processes in one gloo group
(``tests/torch_dist_worker.py``'s ``schedule`` job): one 2-rank job and
one 4-rank job whose resource spec puts two ranks on each of two hosts
(``127.0.0.1`` and ``localhost``). The JAX side runs in the pytest
process on the session's virtual CPU devices.

Cases:

- the sums themselves: ``collectives.rhd_psum`` over 4 ranks against the
  JAX ``rhd_psum`` on a 4-device ``data`` mesh, and
  ``collectives.hierarchical_psum`` over 2 hosts x 2 ranks
  (``parallel/mesh.py::HostGroups``) against the JAX
  ``hierarchical_psum(x, ("ici",), ("dcn",))`` on a ``(dcn, ici) = (2,
  2)`` mesh, f32, 2e-6, on a length that does not divide by the ranks
  (the padding) and one that does; at N = 2 ``rhd_psum`` equals the ring
  (``all_reduce``) bit for bit (a sum of two terms has one order);
- the lowering: ``AllReduce()`` with its synchronizers pinned to
  ``schedule="rhd"`` trains at N = 2 bit-equal to the ring and within
  1e-5 of the JAX runner pinned to rhd (the JAX
  ``test_schedule_rhd_trains_identically_to_ring``); pinned to
  ``schedule="hier"`` and to ``spec="DCN"`` at N = 4 across the two
  hosts it trains within 2e-6 of the ring with the ranks bit-equal. The
  transform raises on neither.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import autodist_tpu as jadt
from autodist_tpu.parallel import collectives as jcollectives
from autodist_tpu.strategy.base import (AllReduceSynchronizer as JARSync,
                                        GraphConfig, Strategy,
                                        StrategyBuilder, VarConfig)
from torch_dist_worker import launch

HOSTS4 = ["127.0.0.1", "127.0.0.1", "localhost", "localhost"]
LR = 0.05
STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(world, shape, seed):
    return np.random.RandomState(seed).standard_normal(
        (world,) + shape).astype(np.float32)


def _jax_rhd(xs):
    n = xs.shape[0]
    mesh = Mesh(np.array(jax.devices()[:n]), ("data",))
    f = jax.jit(jax.shard_map(
        lambda x: jcollectives.rhd_psum(x[0], ("data",)), mesh=mesh,
        in_specs=P("data"), out_specs=P(), check_vma=False))
    return np.asarray(f(xs))


def _jax_hier(xs):
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dcn", "ici"))
    f = jax.jit(jax.shard_map(
        lambda x: jcollectives.hierarchical_psum(x[0], ("ici",), ("dcn",)),
        mesh=mesh, in_specs=P(("dcn", "ici")), out_specs=P(),
        check_vma=False))
    return np.asarray(f(xs))


def _problem():
    rng = np.random.RandomState(0)
    params = {"w": rng.randn(8, 4).astype(np.float32),
              "b": np.zeros((4,), np.float32)}
    batch = {"x": rng.randn(16, 8).astype(np.float32),
             "y": rng.randn(16, 4).astype(np.float32)}
    return params, [batch] * STEPS


def _jax_pinned_losses(schedule, params, batches):
    def loss_fn(p, b):
        return jnp.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)

    class Pinned(StrategyBuilder):
        def build(self, model_item, resource_spec):
            return Strategy(
                node_config=[VarConfig(var_name=n,
                                       synchronizer=JARSync(
                                           schedule=schedule))
                             for n in ("b", "w")],
                graph_config=GraphConfig(
                    replicas=[d.name_string()
                              for d in resource_spec.devices]))
    try:
        ad = jadt.AutoDist(strategy_builder=Pinned())
        runner = ad.build(loss_fn, optax.sgd(LR), params, batches[0])
        runner.init(params)
        return [float(runner.run(b)["loss"]) for b in batches]
    finally:
        jadt.reset()


def _train(schedule, params, batches, hosts, spec="AUTO"):
    return {"kind": "train", "loss": "lin", "schedule": schedule,
            "spec": spec, "hosts": hosts, "init": params,
            "batches": batches,
            "optimizer": {"cls": "SGD", "kw": {"lr": LR}}}


@pytest.fixture(scope="module")
def refs():
    params, batches = _problem()
    xs_odd, xs_even = _inputs(4, (7, 3), 1), _inputs(4, (4, 6), 2)
    return {"params": params, "batches": batches,
            "xs": (xs_odd, xs_even), "xs2": _inputs(2, (5, 3), 3),
            "rhd": [_jax_rhd(x) for x in (xs_odd, xs_even)],
            "hier": [_jax_hier(x) for x in (xs_odd, xs_even)],
            "jax_rhd_losses": _jax_pinned_losses("rhd", params, batches)}


@pytest.fixture(scope="module")
def runs(refs, tmp_path_factory):
    params, batches = refs["params"], refs["batches"]
    two = [{"kind": "psum", "x": refs["xs2"], "hosts": ["127.0.0.1"] * 2},
           _train("rhd", params, batches, ["127.0.0.1"]),
           _train("ring", params, batches, ["127.0.0.1"])]
    four = [{"kind": "psum", "x": x, "hosts": HOSTS4} for x in refs["xs"]]
    four += [_train("hier", params, batches, ["127.0.0.1", "localhost"]),
             _train("ring", params, batches, ["127.0.0.1", "localhost"]),
             _train("auto", params, batches, ["127.0.0.1", "localhost"],
                    spec="DCN")]
    return {2: launch("schedule", 2, tmp_path_factory.mktemp("sched2"), two),
            4: launch("schedule", 4, tmp_path_factory.mktemp("sched4"),
                      four)}


@pytest.mark.parametrize("which", [0, 1], ids=["padded", "even"])
def test_rhd_and_hier_sums_match_the_jax_schedules(refs, runs, which):
    """Four ranks, two hosts of two: every rank's rhd and hierarchical
    sums against the JAX schedules on 4 virtual devices, f32 2e-6; both
    equal the ring's sum to rounding."""
    for rank, res in enumerate(runs[4]):
        case = res[which]
        assert case["groups"] == (2, 2)
        np.testing.assert_allclose(case["rhd"], refs["rhd"][which],
                                   rtol=2e-6, atol=2e-6)
        np.testing.assert_allclose(case["hier"], refs["hier"][which],
                                   rtol=2e-6, atol=2e-6)
        np.testing.assert_allclose(case["hier"], case["ring"], rtol=2e-6,
                                   atol=2e-6)
    # every rank holds the same sum, bit for bit (each element summed on
    # one rank and gathered as it is)
    for key in ("rhd", "hier"):
        first = runs[4][0][which][key]
        for res in runs[4][1:]:
            np.testing.assert_array_equal(res[which][key], first)


def test_rhd_equals_the_ring_bit_for_bit_at_two_ranks(refs, runs):
    """At N = 2 the reduce-scatter + all-gather sums each element's two
    terms once, as the ring does: bit-equal, and equal to the JAX
    ``rhd_psum`` to rounding."""
    want = _jax_rhd(refs["xs2"])
    for res in runs[2]:
        np.testing.assert_array_equal(res[0]["rhd"], res[0]["ring"])
        np.testing.assert_allclose(res[0]["rhd"], want, rtol=2e-6,
                                   atol=2e-6)


def test_rhd_schedule_trains_as_the_ring_and_the_jax_runner(refs, runs):
    """``schedule="rhd"`` at N = 2 lowers (no refusal), trains bit-equal
    to the ring, and within 1e-5 of the JAX runner pinned to rhd."""
    for res in runs[2]:
        rhd, ring = res[1], res[2]
        assert rhd["losses"] == ring["losses"]
        for n, want in ring["params"].items():
            np.testing.assert_array_equal(rhd["params"][n], want)
        assert rhd["ranks_equal"]
        np.testing.assert_allclose(rhd["losses"], refs["jax_rhd_losses"],
                                   rtol=1e-5, atol=1e-6)
    assert runs[2][0][1]["losses"][-1] < runs[2][0][1]["losses"][0]


@pytest.mark.parametrize("which", [2, 4], ids=["hier", "dcn_spec"])
def test_hierarchical_schedule_trains_as_the_ring(runs, which):
    """``schedule="hier"`` (and ``spec="DCN"``) at N = 4 across two hosts
    lowers to the hierarchical sum: within 2e-6 of the ring's training,
    the ranks bit-equal."""
    for res in runs[4]:
        hier, ring = res[which], res[3]
        np.testing.assert_allclose(hier["losses"], ring["losses"],
                                   rtol=2e-6, atol=2e-6)
        for n, want in ring["params"].items():
            np.testing.assert_allclose(hier["params"][n], want, rtol=2e-6,
                                       atol=2e-6)
        assert hier["ranks_equal"]


def test_one_host_hier_is_the_ring():
    """``schedule="hier"`` with every rank on one host has nothing to
    make hierarchical: the synchronizer keeps the ring (the JAX
    resolver's fallback), and no host groups are made."""
    from autodist_tpu_torch.kernel.graph_transformer import GraphTransformer
    from autodist_tpu_torch.kernel.replicator import ReplicaInfo
    from autodist_tpu_torch.model_item import ModelItem
    from autodist_tpu_torch.resource_spec import ResourceSpec
    from autodist_tpu_torch.strategy.base import StrategyCompiler
    from torch_dist_worker import lin_loss, pinned
    params, batches = _problem()
    item = ModelItem(loss_fn=lin_loss, params={
        n: torch.as_tensor(v) for n, v in params.items()},
        example_batch=batches[0],
        optimizer=functools.partial(torch.optim.SGD, lr=LR)).prepare()
    spec = ResourceSpec.from_dict({"nodes": [
        {"address": "127.0.0.1", "chief": True, "cpus": [0, 1]}]})
    plan = StrategyCompiler(item, spec).compile(pinned("hier").build(item,
                                                                     spec))
    dstep = GraphTransformer(plan, item, "cpu", ReplicaInfo(2, 0)).transform()
    assert dstep.host_groups is None
    assert all(not s._scheduled() for s in dstep.syncs.values())
