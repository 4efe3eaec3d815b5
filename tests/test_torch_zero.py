"""autodist_tpu_torch's ZeRO-sharded update (``strategy.ZeroSharded``,
``kernel/synchronization/zero_synchronizer.py``) against the JAX
package's, on the CPU.

- The plan: ``ZeroSharded()`` and ``ZeroSharded(wire_dtype="int8")``
  serialize to the JAX builder's JSON bytes for the same variable list
  and spec.
- N = 2: two gloo ranks of the port (one 2-rank job of
  ``tests/torch_dist_worker.py`` for every case of this file) against the
  JAX runner on 2 virtual CPU devices, 3 Adam (1e-3) steps from the JAX
  init: lm tiny (lean head, flash attention through the kernels' plain
  versions) with the fp32 and the int8 wire, and bert tiny (ragged key
  padding). Losses within 1e-5, params within 1e-4 (the attention key
  biases, whose gradient is zero analytically so Adam turns its rounding
  noise into a step of up to lr: 2 x steps x lr), the gathered Adam
  moments within 1e-4 relative / 1e-7 absolute. The int8 wire is held to
  the same bounds, because the port shards each variable in the JAX
  element order, so the same elements share each scale block in both;
  its moments alone get 2e-5 absolute, one quantization bin of a
  gradient (absmax / 127 of a block, ~1e-4 here) times Adam's 1 - b1:
  XLA's CPU backend contracts the JAX side's dequant-accumulate into
  fused multiply-adds, so an element can round into the next bin.
  The two ranks hold bit-equal params; the ZeRO variables, their
  per-rank shard sizes and the ``zero.rs_bytes``/``zero.ag_bytes``
  counters are the JAX package's; the port's own AllReduce run from the
  same init is bit-equal to its ZeroSharded run (a reduce-scatter of two
  ranks adds the same two numbers an all-reduce adds).
- One replica: ZeroSharded degrades to AllReduce, bit for bit.
- The ADT312 refusals, with the JAX messages.
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
from autodist_tpu.strategy.zero_sharded_strategy import \
    ZeroSharded as JZeroSharded
from autodist_tpu_torch import strategy
from autodist_tpu_torch.convert import jax_name, params_from_jax
from autodist_tpu_torch.model_item import VarInfo
from autodist_tpu_torch.models import lm as tlm
from autodist_tpu_torch.resource_spec import ResourceSpec
from torch_dist_worker import LR, launch

STEPS = 3
LM_SEQ, LM_BATCH = 16, 8
BERT_SEQ, BERT_BATCH = 32, 4
TWO = {"nodes": [{"address": "127.0.0.1", "chief": True, "cpus": [0, 1]}]}


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


VARS = [("embed/embedding", (1000, 64), True), ("dense/kernel", (64, 64),
                                                 False),
        ("dense/bias", (64,), False), ("head/kernel", (64, 8), False),
        ("scalar", (1,), False)]


def _dump(plan):
    return json.dumps(plan.to_dict(), sort_keys=True)


@pytest.mark.parametrize("wire", ["fp32", "int8"])
def test_zero_plan_bytes_match_jax(wire):
    jitem = _Item([JVarInfo(n, s, "float32", sparse=sp) for n, s, sp in VARS])
    titem = _Item([VarInfo(n, s, "float32", sparse=sp) for n, s, sp in VARS])
    jplan = JZeroSharded(chunk_size=2, wire_dtype=wire).build(
        jitem, JSpec.from_dict(TWO))
    tplan = strategy.ZeroSharded(chunk_size=2, wire_dtype=wire).build(
        titem, ResourceSpec.from_dict(TWO))
    tplan.id = jplan.id
    assert _dump(tplan) == _dump(jplan)
    kinds = [n.synchronizer.kind for n in tplan.node_config]
    assert kinds == ["AllReduce", "ZeroSharded", "ZeroSharded",
                     "ZeroSharded", "AllReduce"]


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
        meta = runner.distributed_step.metadata
        return {"losses": losses,
                "params": params_from_jax(host(runner.gather_params())),
                "mu": params_from_jax(adam.mu), "nu": params_from_jax(adam.nu),
                "zero_sharded": meta["zero_sharded"],
                "rs": meta["zero_rs_bytes_per_step"],
                "ag": meta["zero_ag_bytes_per_step"],
                "shards": {n: zs.shard_elems for n, zs in
                           runner.distributed_step.zero_syncs.items()}}
    finally:
        jadt.reset()


CASES = {
    "lm_fp32": ("lm", {}),
    "lm_int8": ("lm", {"wire_dtype": "int8"}),
    "bert_fp32": ("bert", {}),
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
    """Every case's JAX 2-device run and both port ranks' results, and
    the port's AllReduce run of lm from the same init, from one 2-rank
    job."""
    jax_out, payload = {}, []
    for case, (model, kw) in CASES.items():
        loss_fn, jparams, example, batches, setup = _setup(model)
        init = {n: t.numpy() for n, t in params_from_jax(
            jax.tree_util.tree_map(np.asarray, jparams)).items()}
        jax_out[case] = _jax_run(loss_fn, jparams, example, batches,
                                 jstrategy.ZeroSharded(**kw))
        jax_out[case]["init"] = init
        payload.append(dict(setup, builder="ZeroSharded", strategy=kw,
                            init=init, batches=batches))
    payload.append(dict(payload[0], builder="AllReduce", strategy={}))
    ranks = launch("train", 2, tmp_path_factory.mktemp("zero"), payload)
    out = {case: (jax_out[case], [r[i] for r in ranks])
           for i, case in enumerate(CASES)}
    out["allreduce"] = [r[len(CASES)] for r in ranks]
    return out


def _close(got, want, init):
    for name, value in got.items():
        tol = 2 * STEPS * LR if name.endswith("key.bias") else 1e-4
        np.testing.assert_allclose(value, want[name].numpy(), atol=tol,
                                   rtol=0, err_msg=name)
        assert not np.array_equal(value, init[name]), name


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_match_the_jax_zero_runner(runs, case):
    ref, ranks = runs[case]
    for out in ranks:
        np.testing.assert_allclose(out["losses"], ref["losses"], atol=1e-5,
                                   rtol=1e-5)
        assert out["steps"] == STEPS
    final = ranks[0]["params"]
    assert final.keys() == ref["params"].keys()
    _close(final, ref["params"], ref["init"])
    atol = 2e-5 if case == "lm_int8" else 1e-7
    for slot in ("mu", "nu"):
        got = ranks[0]["opt"][slot]
        assert got.keys() == ref[slot].keys()
        for name, value in got.items():
            if name.endswith("key.bias"):
                continue
            np.testing.assert_allclose(value, ref[slot][name].numpy(),
                                       rtol=1e-4, atol=atol,
                                       err_msg="%s %s" % (slot, name))
    assert int(ranks[0]["opt"]["count"]) == STEPS


@pytest.mark.parametrize("case", list(CASES))
def test_ranks_bit_equal_and_shards_as_jax_lays_them(runs, case):
    ref, (r0, r1) = runs[case]
    assert r0["losses"] == r1["losses"]
    for name in r0["params"]:
        assert np.array_equal(r0["params"][name], r1["params"][name]), name
    meta = r0["metadata"]
    shapes = {n: np.shape(v) for n, v in r0["params"].items()}
    assert sorted(jax_name(n, shapes[n]) for n in meta["zero_sharded"]) == \
        sorted(ref["zero_sharded"])
    assert {jax_name(n, shapes[n]): k for n, k in r0["zero_shards"].items()} \
        == ref["shards"]
    # the optimizer state of a ZeRO variable is this rank's shard only
    assert not set(meta["zero_sharded"]) & set(r0["stored_mu"])
    assert meta["zero_rs_bytes_per_step"] == ref["rs"] > 0
    assert meta["zero_ag_bytes_per_step"] == ref["ag"] > 0
    assert r0["counters"]["zero.rs_bytes"] == STEPS * ref["rs"]
    assert r0["counters"]["zero.ag_bytes"] == STEPS * ref["ag"]
    assert r0["sync_state"]["zero"] == sorted(meta["zero_sharded"])
    want_int8 = meta["zero_sharded"] if case == "lm_int8" else []
    assert sorted(meta["zero_wire_int8"]) == sorted(
        n for n in want_int8 if np.prod(shapes[n]) >= 2 * 256)


def test_zero_is_bit_equal_to_the_ports_allreduce_at_two_ranks(runs):
    _, ranks = runs["lm_fp32"]
    for zero, ar in zip(ranks, runs["allreduce"]):
        assert zero["losses"] == ar["losses"]
        for name, value in ar["params"].items():
            assert np.array_equal(zero["params"][name], value), name
        for slot in ("mu", "nu"):
            for name, value in ar["opt"][slot].items():
                assert np.array_equal(zero["opt"][slot][name], value), name


def _lm_port(builder, steps=3):
    loss_fn, params, batch, _ = tlm.make_train_setup(
        tlm.LMConfig.tiny(), seq_len=LM_SEQ, batch_size=4)
    ad = adt.AutoDist(strategy_builder=builder, device="cpu")
    runner = ad.build(loss_fn, functools.partial(torch.optim.Adam, lr=LR),
                      params, batch)
    runner.init(params)
    losses = [float(runner.run(batch)["loss"]) for _ in range(steps)]
    out = (losses, runner.gather_params(),
           runner.distributed_step.gather_opt_state(runner.state),
           runner.distributed_step)
    adt.reset()
    return out


def test_zero_at_one_replica_degrades_to_allreduce():
    zl, zp, zo, zstep = _lm_port(strategy.ZeroSharded())
    al, ap, ao, _ = _lm_port(strategy.AllReduce())
    assert zl == al
    for n in ap:
        assert torch.equal(zp[n], ap[n]), n
        assert torch.equal(zo["mu"][n], ao["mu"][n]), n
    assert zstep.zero_syncs == {} and zstep.metadata["zero_sharded"] == []
    assert zstep.metadata["zero_rs_bytes_per_step"] == 0


def _transform(mutate):
    from autodist_tpu_torch.kernel.graph_transformer import GraphTransformer
    from autodist_tpu_torch.kernel.replicator import ReplicaInfo
    from autodist_tpu_torch.model_item import ModelItem
    from autodist_tpu_torch.strategy.base import StrategyCompiler
    loss_fn, params, batch, _ = tlm.make_train_setup(
        tlm.LMConfig.tiny(), seq_len=LM_SEQ, batch_size=4)
    item = ModelItem(loss_fn=loss_fn, params=params,
                     example_batch=batch,
                     optimizer=torch.optim.Adam).prepare()
    spec = ResourceSpec.from_dict(TWO)
    plan = StrategyCompiler(item, spec).compile(
        strategy.ZeroSharded().build(item, spec))
    mutate(plan)
    return GraphTransformer(plan, item, "cpu", ReplicaInfo(2, 0)).transform()


def test_adt312_refusals_carry_the_jax_messages():
    from autodist_tpu_torch.strategy.base import ZeroShardedSynchronizer

    def on_table(plan):
        plan.find("embed.embedding").synchronizer = ZeroShardedSynchronizer()

    def partitioned(plan):
        plan.find("final_ln.weight").partitioner = "2"
    with pytest.raises(ValueError, match=r"var embed.embedding: ZeroSharded "
                                         r"on a sparse .*\(ADT312\)"):
        _transform(on_table)
    with pytest.raises(ValueError, match=r"var final_ln.weight: ZeroSharded "
                                         r"cannot combine with partitioner "
                                         r"storage \(ADT312\)"):
        _transform(partitioned)


def test_zero_shards_relay_across_replica_counts_as_jax_does():
    """A ``sync_state['zero']`` leaf saved at 4 replicas re-laid for 2 (a
    restore at another replica count): the JAX package's re-layout of
    the same leaf, element for element; the count row broadcasts."""
    from autodist_tpu.kernel.synchronization.zero_synchronizer import (
        ZeroSynchronizer as JZero, relayout_zero_sync_leaf as jrelayout)
    from autodist_tpu.strategy.base import ZeroShardedSynchronizer as JCfg
    from autodist_tpu_torch.kernel.synchronization.zero_synchronizer import (
        ZeroSynchronizer, relayout_zero_sync_leaf)
    from autodist_tpu_torch.strategy.base import ZeroShardedSynchronizer
    shape = (7, 5)
    old = ZeroSynchronizer("w", ZeroShardedSynchronizer(), shape, "float32",
                           4, 0, 4)
    new = ZeroSynchronizer("w", ZeroShardedSynchronizer(), shape, "float32",
                           2, 0, 2)
    jnew = JZero("w", JCfg(), shape, np.float32, "data", 2, (), 2)
    saved = np.arange(4 * old.shard_elems, dtype=np.float32).reshape(4, -1)
    saved[-1, 35 - 3 * old.shard_elems:] = 0     # the padding is zeros
    got = relayout_zero_sync_leaf(saved, 4, new, 2)
    want = jrelayout(saved, ("data",), (4,), "data", jnew,
                     (2, new.shard_elems), np.float32)
    assert np.array_equal(got, want)
    counts = np.full((4,), 3, np.int32)
    assert np.array_equal(relayout_zero_sync_leaf(counts, 4, new, 2),
                          np.full((2,), 3, np.int32))
