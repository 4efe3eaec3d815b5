"""autodist_tpu_torch's sharded storage beside a model-parallel mesh axis,
against the JAX package.

One 4-rank gloo job (``mesh_job`` in ``tests/torch_dist_worker.py``)
trains each case through the entry points a user calls: a
``TensorParallel``, ``PipelineParallel``, ``ExpertParallel`` or
``SequenceParallelAR`` plan whose nodes pin some variables to
``ZeroShardedSynchronizer``, host-resident PS or a partitioner
(``storage_plan``). The JAX runner trains the same pinned plan on the
session's 8 virtual CPU devices (its mesh spans every device, so its data
axis is 8 / (model-parallel size), the port's 4 / that): the same mean
gradient, reduced in another order. Two Adam steps (eps 1e-6, as in
``tests/test_torch_sequence_parallel.py``): losses 1e-5, gathered params
and gathered optimizer state rtol 2e-5 / atol 2e-6.

Cases: ``tp_lm`` under ``TensorParallel(2)`` with ZeRO on the LayerNorms
and ``pos_embed`` partitioned ``"2,1"`` (its sharded save restores in the
JAX ``ShardedSaver``); the same with ``layer_0/mlp/b2`` on host PS — a
plan the JAX step cannot run (its ``fill_holes`` raises ``KeyError``), so
the port is held to the JAX plain ``TensorParallel`` runs, the same math
(each update under PS or ZeRO is its update under AllReduce); ``pipe_lm``
under ``PipelineParallel(2)`` with ZeRO beside the pipe axis; ``moe_lm``
under ``ExpertParallel(2)`` (no drops, aux loss off) with the embedding
table on host PS, its steps as one fused superstep (the table in the
device carry); ``tp_lm`` under ``SequenceParallelAR(2)`` (ring
attention) with ``pos_embed`` partitioned. Each rank stores its data
index's shard, and the ranks of one model line the same one.
"""
import concurrent.futures

import jax
import numpy as np
import optax
import pytest

import autodist_tpu as jadt
import autodist_tpu_torch as adt
from autodist_tpu import strategy as jstrategy
from autodist_tpu.checkpoint.sharded import ShardedSaver as JSharded
from autodist_tpu.kernel.common import variable_utils
from autodist_tpu.models import moe_lm as jmoe
from autodist_tpu.models import pipe_lm as jpipe
from autodist_tpu.models import tp_lm as jtp_lm
from autodist_tpu.strategy import base as jbase
from autodist_tpu_torch import convert
from torch_dist_worker import launch

STEPS = 2
LR = 1e-3
ADAM_EPS = 1e-6
E = jmoe.MoEConfig.tiny().num_experts
LNS = ["final_ln/scale", "final_ln/bias"] + [
    "layer_%d/%s/%s" % (i, ln, p) for i in range(2) for ln in ("ln1", "ln2")
    for p in ("scale", "bias")]


@pytest.fixture(autouse=True)
def _reset():
    yield
    adt.reset()
    jadt.reset()


def jax_pinned(base, zero=(), ps=(), part=None):
    """The JAX builder ``base`` with the worker's ``storage_plan`` pins."""
    part = dict(part or {})

    class Pinned(jbase.StrategyBuilder):
        def build(self, model_item, resource_spec):
            plan = base.build(model_item, resource_spec)
            for node in plan.node_config:
                n = node.var_name
                if n in zero:
                    node.synchronizer = jbase.ZeroShardedSynchronizer()
                elif n in ps:
                    node.synchronizer = jbase.PSSynchronizer(
                        reduction_destination="127.0.0.1")
                elif n in part:
                    node.partitioner = part[n]
                    node.part_configs = [
                        jbase.VarConfig(
                            var_name="%s/part_%d" % (n, i),
                            synchronizer=jbase.AllReduceSynchronizer())
                        for i in range(node.num_shards)]
            return plan
    return Pinned()


def _np_tree(tree):
    names, leaves, _ = variable_utils.flatten_named(
        jax.tree_util.tree_map(np.asarray, tree))
    return dict(zip(names, leaves))


def _flat(tree):
    return {n: t.numpy() for n, t in convert.tp_lm_params_from_jax(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


def _batches(batch, vocab, seed):
    rng = np.random.RandomState(seed)
    return [batch] + [{"tokens": rng.randint(
        0, vocab, batch["tokens"].shape).astype(np.int32)}
        for _ in range(STEPS - 1)]


def _jax_state(runner):
    dstep = runner.distributed_step
    return {"params": _flat(runner.gather_params()),
            "opt_jax": _np_tree(dstep.gather_opt_state(runner.state))}


def _jax_run(setup, builder, meta=None):
    loss_fn, params, batches = setup
    try:
        runner = jadt.AutoDist(strategy_builder=builder).build(
            loss_fn, optax.adam(LR, eps=ADAM_EPS), params, batches[0],
            mp_meta=meta)
        runner.init(params)
        losses = [float(runner.run(b)["loss"]) for b in batches]
        return dict(_jax_state(runner), losses=losses)
    finally:
        jadt.reset()


# --------------------------------------------------------------- cases


def _tp_setup():
    loss_fn, params, batch, _ = jtp_lm.make_train_setup(
        jtp_lm.TPLMConfig.tiny(), seq_len=16, batch_size=8, seed=3)
    return loss_fn, params, _batches(batch, 64, 4)


def _sp_setup():
    loss_fn, params, batch, _ = jtp_lm.make_train_setup(
        jtp_lm.TPLMConfig.tiny(), seq_len=16, batch_size=8, seed=1,
        attention="ring")
    return loss_fn, params, _batches(batch, 64, 2)


def _pipe_setup():
    loss_fn, params, batch, _ = jpipe.make_train_setup(
        jpipe.TPLMConfig.tiny(num_layers=4), seq_len=16, batch_size=8,
        seed=1, n_microbatches=2, schedule="gpipe")
    return loss_fn, params, _batches(batch, 64, 2)


def _moe_setup():
    loss_fn, params, batch, _ = jmoe.make_train_setup(
        jmoe.MoEConfig.tiny(capacity_factor=float(E)), seq_len=16,
        batch_size=8, seed=2, aux_coef=0.0)
    return loss_fn, params, _batches(batch, 64, 3)


TP_PINS = {"zero": LNS, "part": {"pos_embed": "2,1"}}
PS_PINS = dict(TP_PINS, ps=["layer_0/mlp/b2"])
PIPE_PINS = {"zero": ["final_ln/scale", "final_ln/bias", "pos_embed"]}
MOE_PINS = {"ps": ["embed"]}
SP_PINS = {"part": {"pos_embed": "2,1"}}


def _tp_builder(pins):
    return jax_pinned(jstrategy.TensorParallel(2, jtp_lm.tp_rules()),
                      **pins)


# (name, setup, JAX builder, port case keywords)
CASES = {
    "tp_zero_part": (_tp_setup, lambda: _tp_builder(TP_PINS),
                     dict(model="tp_lm", builder="TensorParallel",
                          kw={"tp_shards": 2}, **TP_PINS)),
    # the JAX step raises for PS beside ZeRO: the plain plan's runs
    "tp_zero_ps": (_tp_setup, lambda: jstrategy.TensorParallel(
        2, jtp_lm.tp_rules()),
        dict(model="tp_lm", builder="TensorParallel", kw={"tp_shards": 2},
             **PS_PINS)),
    "pipe_zero": (_pipe_setup, lambda: jax_pinned(jstrategy.PipelineParallel(
        pp_shards=2, n_microbatches=2, schedule="gpipe",
        mp_rules=jpipe.pp_rules(model_axis=None)), **PIPE_PINS),
        dict(model="pipe_lm", builder="PipelineParallel", layers=4,
             kw={"pp_shards": 2, "n_microbatches": 2, "schedule": "gpipe"},
             **PIPE_PINS)),
    "moe_ps": (_moe_setup, lambda: jax_pinned(jstrategy.ExpertParallel(
        ep_shards=2, mp_rules=jmoe.ep_rules()), **MOE_PINS),
        dict(model="moe_lm", builder="ExpertParallel",
             cfg={"capacity_factor": float(E)}, kw={"ep_shards": 2},
             fuse=True, **MOE_PINS)),
    "sp_part": (_sp_setup, lambda: jax_pinned(jstrategy.SequenceParallelAR(
        seq_shards=2), **SP_PINS),
        dict(model="tp_lm", builder="SequenceParallelAR",
             attention="ring", kw={"seq_shards": 2}, **SP_PINS)),
}
PIPE_META = {"pp_schedule": "gpipe", "pp_microbatches": 2}


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("mesh_ckpt"))


@pytest.fixture(scope="module")
def job(tmp_path_factory, ckpt_dir):
    """The JAX references and every case's ranks, from one 4-rank job run
    in a thread while the references compute."""
    setups, payload = {}, []
    for name, (setup, _, kw) in CASES.items():
        setups[name] = setup()
        _, params, batches = setups[name]
        case = dict(kw, name=name, kind="train", init=_flat(params),
                    batches=batches, lr=LR, eps=ADAM_EPS)
        if name == "tp_zero_part":
            case["save_dir"] = ckpt_dir
        payload.append(case)
    tmp = tmp_path_factory.mktemp("mesh")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch, "mesh", 4, tmp, payload)
        refs = {name: _jax_run(setups[name], builder(),
                               PIPE_META if name == "pipe_zero" else None)
                for name, (_, builder, _) in CASES.items()}
        ranks = ranks.result()
    return refs, ranks


def _close(got, want, what):
    assert sorted(got) == sorted(want), what
    for n, w in want.items():
        np.testing.assert_allclose(np.asarray(got[n]), np.asarray(w),
                                   rtol=2e-5, atol=2e-6,
                                   err_msg="%s %s" % (what, n))


@pytest.mark.parametrize("case", sorted(CASES))
def test_training_matches_the_jax_runner(job, case):
    """Every rank's losses and gathered params against the JAX runner's
    under the same pinned plan (``tp_zero_ps``: the plain plan)."""
    refs, ranks = job
    ref = refs[case]
    for r in ranks:
        got = r[case]
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5,
                                   atol=1e-5)
        _close(got["params"], ref["params"], case + " params")


@pytest.mark.parametrize("case", sorted(CASES))
def test_gathered_opt_state_matches_jax(job, case):
    """``gather_opt_state`` — ZeRO moments rebuilt from the data axis's
    shards, partitioned ones gathered over it, host-PS ones from the
    store — equals the JAX ``gather_opt_state``, by the JAX saver's
    names, on every rank."""
    refs, ranks = job
    for r in ranks:
        _close(r[case]["opt_jax"], refs[case]["opt_jax"], case + " opt")


@pytest.mark.parametrize("case,axis", [("tp_zero_part", "model"),
                                       ("pipe_zero", "pipe"),
                                       ("moe_ps", "expert"),
                                       ("sp_part", "seq")])
def test_each_rank_stores_its_data_index_shard(job, case, axis):
    """The plan's mesh puts the data axis beside ``axis`` (2 x 2); each
    rank stores half of each ZeRO moment (its data index's flat shard)
    and half of each partitioned variable, the ranks of one ``axis``
    line the same half; the ZeRO wire counters count each step's
    reduce-scatter over the data axis; host-PS variables live in the
    store, off the device state."""
    _, ranks = job
    for rank, r in enumerate(ranks):
        got = r[case]
        assert got["mesh"][axis] == 2 and got["mesh"]["data"] == 2
        kw = CASES[case][2]
        assert sorted(got["partitioned"]) == sorted(kw.get("part", {}))
        for n, shape in got["partitioned"].items():
            assert shape[0] == 64 // 2, n         # pos_embed's 64 rows
        assert sorted(got["zero_shard"]) == sorted(kw.get("zero", ()))
        assert got["metadata"]["zero_sharded"] == sorted(kw.get("zero", ()))
        assert got["ps"] == sorted(kw.get("ps", ()))
        if kw.get("zero"):
            assert got["counters"]["zero.rs_bytes"] == \
                STEPS * got["metadata"]["zero_rs_bytes_per_step"] > 0
    # the ranks of one data index hold the same shard size; data indexes
    # split the variable
    for r in ranks:
        assert r[case]["zero_shard"] == ranks[0][case]["zero_shard"]


def test_sharded_save_restores_in_the_jax_saver(job, ckpt_dir):
    """The port's sharded save at ``{data: 2, model: 2}`` (ZeRO rows at
    the JAX ``leading_stride``, the partitioned shards over the data
    axis) restores in the JAX ``ShardedSaver`` on its ``{data: 4, model:
    2}`` mesh: params and both Adam moments equal the port's gathered
    state bit for bit."""
    _, ranks = job
    at_save = ranks[0]["tp_zero_part"]
    loss_fn, params, batches = _tp_setup()
    runner = jadt.AutoDist(strategy_builder=_tp_builder(TP_PINS)).build(
        loss_fn, optax.adam(LR, eps=ADAM_EPS), params, batches[0])
    runner.init(params)
    _, step = JSharded(ckpt_dir).restore(runner)
    assert step == STEPS
    got = _jax_state(runner)
    for n, w in at_save["params"].items():
        np.testing.assert_array_equal(got["params"][n], w, err_msg=n)
    for n, w in at_save["opt_jax"].items():
        np.testing.assert_array_equal(got["opt_jax"][n], w, err_msg=n)


def test_ps_beside_zero_fails_in_the_jax_step():
    """The reference's fault that the port does not inherit: a plan with a
    host-PS and a ZeRO variable raises ``KeyError`` in the JAX step
    (``ps_lib.fill_holes`` of the ZeRO deltas finds the PS hole), even on
    a data axis alone; the port runs it (``tp_zero_ps``)."""
    loss_fn, params, batches = _tp_setup()
    runner = jadt.AutoDist(strategy_builder=jax_pinned(
        jstrategy.AllReduce(), zero=["final_ln/scale"],
        ps=["layer_0/mlp/b2"])).build(
            loss_fn, optax.adam(LR, eps=ADAM_EPS), params, batches[0])
    runner.init(params)
    with pytest.raises(KeyError, match="layer_0/mlp/b2"):
        runner.run(batches[0])
