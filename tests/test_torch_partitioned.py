"""autodist_tpu_torch's partitioned (reduce-scatter) layouts
(``strategy.PartitionedAR``, ``strategy.RandomAxisPartitionAR``,
``kernel/partitioner.py``) against the JAX package's, on the CPU.

- The plans serialize to the JAX builders' JSON bytes for the same
  variable list and spec (RandomAxisPartitionAR's seeded ``random`` picks
  the same axes).
- N = 2: two gloo ranks of the port (one 2-rank job of
  ``tests/torch_dist_worker.py`` for every case) against the JAX runner on
  2 virtual CPU devices, 3 Adam (1e-3) steps from the JAX init: lm tiny
  (lean head, flash attention through the kernels' plain versions) under
  both builders and bert tiny (ragged key padding) under PartitionedAR.
  Losses within 1e-5, params within 1e-4 (the attention key biases,
  whose gradient is zero analytically: 2 x steps x lr), the gathered Adam
  moments within 1e-4 relative / 1e-7 absolute. Each rank stores half of
  every partitioned variable and of its moments (the split axis padded
  to an even length); ``gather_params`` and ``gather_opt_state`` give
  the original layout; the two ranks agree bit for bit, and the port's
  own AllReduce run of lm from the same init is bit-equal to its
  PartitionedAR run.
- ``VarLayout``'s pad, shard and unpad on any axis, with no collective.
"""
import functools
import json

import jax
import numpy as np
import optax
import pytest
import torch

import autodist_tpu as jadt
import autodist_tpu_torch as adt
from autodist_tpu import strategy as jstrategy
from autodist_tpu.model_item import VarInfo as JVarInfo
from autodist_tpu.models import bert as jbert
from autodist_tpu.models import lm as jlm
from autodist_tpu.resource_spec import ResourceSpec as JSpec
from autodist_tpu_torch import strategy
from autodist_tpu_torch.convert import params_from_jax
from autodist_tpu_torch.kernel.partitioner import VarLayout
from autodist_tpu_torch.model_item import VarInfo
from autodist_tpu_torch.resource_spec import ResourceSpec
from torch_dist_worker import LR, launch

STEPS = 3
LM_SEQ, LM_BATCH = 16, 8
BERT_SEQ, BERT_BATCH = 32, 4
TWO = {"nodes": [{"address": "127.0.0.1", "chief": True, "cpus": [0, 1]}]}
FOUR = {"nodes": [{"address": "127.0.0.1", "chief": True,
                   "cpus": [0, 1, 2, 3]}]}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; one thread keeps
    these tests from contending with the suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reset_port():
    yield
    adt.reset()


class _Item:
    def __init__(self, infos):
        self.var_infos = {i.name: i for i in infos}
        self.trainable_var_names = [i.name for i in infos]


VARS = [("embed/embedding", (1000, 64), True), ("dense/kernel", (63, 64),
                                                 False),
        ("dense/bias", (64,), False), ("head/kernel", (64, 9), False),
        ("conv/kernel", (3, 3, 16, 32), False), ("scalar", (), False)]


@pytest.mark.parametrize("name", ["PartitionedAR", "RandomAxisPartitionAR"])
@pytest.mark.parametrize("spec", [TWO, FOUR], ids=["two", "four"])
def test_partitioned_plan_bytes_match_jax(name, spec):
    jitem = _Item([JVarInfo(n, s, "float32", sparse=sp) for n, s, sp in VARS])
    titem = _Item([VarInfo(n, s, "float32", sparse=sp) for n, s, sp in VARS])
    kw = {"chunk_size": 2} if name == "PartitionedAR" else {"seed": 3}
    jplan = getattr(jstrategy, name)(**kw).build(jitem, JSpec.from_dict(spec))
    tplan = getattr(strategy, name)(**kw).build(titem,
                                                ResourceSpec.from_dict(spec))
    tplan.id = jplan.id
    dump = lambda p: json.dumps(p.to_dict(), sort_keys=True)  # noqa: E731
    assert dump(tplan) == dump(jplan)
    assert any(n.partitioner for n in tplan.node_config)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_var_layout_pads_shards_and_unpads_any_axis(axis):
    t = torch.arange(5 * 7 * 3, dtype=torch.float32).reshape(5, 7, 3)
    dim = t.shape[axis]
    padded = -(-dim // 2) * 2
    lay = VarLayout("w", partitioned=True, axis=axis, orig_dim=dim,
                    padded_dim=padded)
    parts = [lay.local(t, r, 2) for r in range(2)]
    assert all(p.shape[axis] == padded // 2 for p in parts)
    assert torch.equal(lay.unpad(torch.cat(parts, dim=axis)), t)
    assert torch.equal(lay.pad(t).narrow(axis, 0, dim), t)
    if padded > dim:
        assert not lay.pad(t).narrow(axis, dim, padded - dim).any()


def _lm_batches(seed=1):
    rng = np.random.RandomState(seed)
    return [{"tokens": rng.randint(0, 128, (LM_BATCH, LM_SEQ + 1)).astype(
        np.int32)} for _ in range(STEPS)]


def _bert_batches(seed=11):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(STEPS):
        shape = (BERT_BATCH, BERT_SEQ)
        lengths = rng.randint(BERT_SEQ // 2, BERT_SEQ + 1, BERT_BATCH)
        lengths[0] = BERT_SEQ
        mask = (np.arange(BERT_SEQ)[None] < lengths[:, None]).astype(np.int32)
        out.append({
            "input_ids": rng.randint(0, 128, shape).astype(np.int32),
            "token_type_ids": rng.randint(0, 2, shape).astype(np.int32),
            "attention_mask": mask,
            "labels": rng.randint(0, 128, shape).astype(np.int32),
            "mlm_weights": (rng.rand(*shape) < 0.3).astype(np.float32)
            * mask})
    return out


def _jax_run(loss_fn, params, example, batches, builder):
    try:
        ad = jadt.AutoDist(strategy_builder=builder,
                           resource_spec=JSpec.from_dict(TWO))
        runner = ad.build(loss_fn, optax.adam(LR), params, example)
        runner.init(params)
        losses = [float(runner.run(b)["loss"]) for b in batches]
        host = functools.partial(jax.tree_util.tree_map, np.asarray)
        adam = host(runner.distributed_step.gather_opt_state(runner.state))[0]
        return {"losses": losses,
                "params": params_from_jax(host(runner.gather_params())),
                "mu": params_from_jax(adam.mu), "nu": params_from_jax(adam.nu)}
    finally:
        jadt.reset()


CASES = {
    "lm_partitioned": ("lm", "PartitionedAR"),
    "lm_random_axis": ("lm", "RandomAxisPartitionAR"),
    "bert_partitioned": ("bert", "PartitionedAR"),
}


def _setup(model):
    if model == "lm":
        loss_fn, jparams, example, _ = jlm.make_train_setup(
            jlm.LMConfig.tiny(), seq_len=LM_SEQ, batch_size=LM_BATCH,
            attention="flash", lean_head=True)
        return (loss_fn, jparams, example, _lm_batches(),
                {"model": "lm", "seq_len": LM_SEQ, "batch_size": LM_BATCH,
                 "attention": "flash"})
    loss_fn, jparams, example, _ = jbert.make_train_setup(
        jbert.BertConfig.tiny(), seq_len=BERT_SEQ, batch_size=BERT_BATCH,
        attention="xla")
    return (loss_fn, jparams, example, _bert_batches(),
            {"model": "bert", "seq_len": BERT_SEQ, "batch_size": BERT_BATCH,
             "attention": "xla"})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jax_out, payload = {}, []
    for case, (model, name) in CASES.items():
        loss_fn, jparams, example, batches, setup = _setup(model)
        init = {n: t.numpy() for n, t in params_from_jax(
            jax.tree_util.tree_map(np.asarray, jparams)).items()}
        jax_out[case] = _jax_run(loss_fn, jparams, example, batches,
                                 getattr(jstrategy, name)())
        jax_out[case]["init"] = init
        payload.append(dict(setup, builder=name, init=init, batches=batches))
    payload.append(dict(payload[0], builder="AllReduce"))
    ranks = launch("train", 2, tmp_path_factory.mktemp("part"), payload)
    out = {case: (jax_out[case], [r[i] for r in ranks])
           for i, case in enumerate(CASES)}
    out["allreduce"] = [r[len(CASES)] for r in ranks]
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_match_the_jax_partitioned_runner(runs, case):
    ref, ranks = runs[case]
    for out in ranks:
        np.testing.assert_allclose(out["losses"], ref["losses"], atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(out["eval"], ref["losses"][0], atol=1e-5,
                                   rtol=1e-5)
    final = ranks[0]["params"]
    assert final.keys() == ref["params"].keys()
    for name, value in final.items():
        assert value.shape == ref["init"][name].shape, name
        tol = 2 * STEPS * LR if name.endswith("key.bias") else 1e-4
        np.testing.assert_allclose(value, ref["params"][name].numpy(),
                                   atol=tol, rtol=0, err_msg=name)
        assert not np.array_equal(value, ref["init"][name]), name
    for slot in ("mu", "nu"):
        for name, value in ranks[0]["opt"][slot].items():
            assert value.shape == ref["init"][name].shape, name
            if not name.endswith("key.bias"):
                np.testing.assert_allclose(
                    value, ref[slot][name].numpy(), rtol=1e-4, atol=1e-7,
                    err_msg="%s %s" % (slot, name))


@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_stores_half_and_ranks_agree(runs, case):
    ref, (r0, r1) = runs[case]
    assert r0["losses"] == r1["losses"]
    partitioned = r0["metadata"]["partitioned"]
    assert partitioned and r0["buckets"] == [] and "sync_state" in r0
    for name, value in r0["params"].items():
        assert np.array_equal(value, r1["params"][name]), name
        full = value.size
        if name in partitioned:
            # an odd split axis pads by one row before halving
            assert r0["stored"][name] == r0["stored_mu"][name]
            assert full / 2 <= r0["stored"][name] < full / 2 + full / 4, name
        else:
            assert r0["stored"][name] == full, name


def test_partitioned_is_bit_equal_to_the_ports_allreduce(runs):
    _, ranks = runs["lm_partitioned"]
    for part, ar in zip(ranks, runs["allreduce"]):
        assert part["losses"] == ar["losses"]
        for name, value in ar["params"].items():
            assert np.array_equal(part["params"][name], value), name


@pytest.mark.parametrize("name,kw", [
    ("PartitionedAR", {}), ("RandomAxisPartitionAR", {"seed": 3}),
    ("PartitionedPS", {}), ("UnevenPartitionedPS", {})],
    ids=["PartitionedAR", "RandomAxisPartitionAR", "PartitionedPS",
         "UnevenPartitionedPS"])
def test_real_model_plans_partition_as_the_jax_plans(name, kw):
    """C8: the partitioned builders size and split each variable by the
    JAX item's (flax) shape, so on the port's own items — Dense weights
    ``[out, in]``, DenseGeneral projections flattened to 2-D — every node
    partitions as the JAX plan's node of the same variable (a 2-D
    ``prediction.weight [1, 16]`` is flax's ``[16, 1]``: split, where the
    port's shape alone would not split it)."""
    from autodist_tpu.model_item import ModelItem as JModelItem
    from autodist_tpu.models import ncf as jncf
    from autodist_tpu_torch.model_item import ModelItem
    from autodist_tpu_torch.models import bert as tbert
    from autodist_tpu_torch.models import ncf as tncf
    spec = {"nodes": [{"address": "127.0.0.1", "chief": True,
                       "cpus": [0, 1, 2, 3]}]}
    setups = [
        (jncf.make_train_setup(jncf.NCFConfig.tiny(), batch_size=8),
         tncf.make_train_setup(tncf.NCFConfig.tiny(), batch_size=8)),
        (jbert.make_train_setup(jbert.BertConfig.tiny(), seq_len=BERT_SEQ,
                                batch_size=BERT_BATCH),
         tbert.make_train_setup(tbert.BertConfig.tiny(), seq_len=BERT_SEQ,
                                batch_size=BERT_BATCH))]
    split = 0
    for (jl, jp, jb, _), (tl, tp, tb, _) in setups:
        jitem = JModelItem(loss_fn=jl, params=jp, example_batch=jb).prepare()
        titem = ModelItem(loss_fn=tl, params=tp, example_batch=tb).prepare()
        jplan = getattr(jstrategy, name)(**kw).build(
            jitem, JSpec.from_dict(spec))
        tplan = getattr(strategy, name)(**kw).build(
            titem, ResourceSpec.from_dict(spec))
        jnodes = {n.var_name: n for n in jplan.node_config}
        assert len(jnodes) == len(tplan.node_config)
        for node in tplan.node_config:
            jnode = jnodes[titem.var_infos[node.var_name].collective_name]
            assert (node.partitioner, node.shard_sizes) == \
                (jnode.partitioner, jnode.shard_sizes), node.var_name
            split += node.partitioner is not None
    assert split
