"""autodist_tpu_torch's data parallelism: N = 2 ranks of the port against
the JAX package's AllReduce runner on 2 virtual CPU devices.

The port's ranks are two spawned processes in one gloo group (a
``FileStore`` in the test's temporary directory), driven through the
entry points a user calls (``AutoDist(...).build`` -> ``Runner.init`` ->
``Runner.run``) with the host-global batches; the JAX-free job lives in
``tests/torch_dist_worker.py``. One 2-rank job runs every case of this
file. From the JAX init, converted with ``convert.params_from_jax``,
three Adam (1e-3) steps each:

- lm tiny (lean head, flash attention through the kernels' plain
  versions), seq 16, global batch 8: the fp32 wire and
  ``wire_dtype="int8"`` (the int8 two-phase codec in buckets with error
  feedback);
- bert tiny (plain attention), seq 32, global batch 4 with ragged key
  padding and ``mlm_weights`` on real tokens: drift point (a), BERT's
  per-shard weight-sum normalisation, which the JAX step averages over
  devices and the port over ranks.

Routes. At N = 2 the JAX lowering sends a lookup table over its sparse
(ids, values) wire when that undercuts the dense gradient, and so does
the port (``ops/embedding.py``: the pairs all-gathered over the ranks and
scatter-added), outside the buckets. In these setups JAX takes the sparse wire for lm's
``pos_embed`` (16 ids x 2 x 33 < 64 x 32) and keeps ``embed`` dense
(64 ids x 2 x 33 >= 128 x 32); for bert it keeps every table dense (the
position table by a hair: 32 ids x 2 x 33 >= 64 x 32). The test reads
JAX's routing from its lowering and holds the port's to it. On both routes the tables' synced gradient is the same
mean, so they are held to the same bounds as the rest.

Tolerances. Per-step losses within 1e-5 (two frameworks, two summation
orders; observed ~1e-7). Parameters: 1e-4, except the attention key
biases, whose gradient is zero analytically, so Adam turns its rounding
noise into a step of up to lr (``tests/test_torch_train.py``): 2 x steps
x lr. The int8 wire is held to the same bounds: the port lays a bucket
out in the JAX package's element order (flax kernels [in, out]), so the
same elements share each scale block in both. Both ranks' params are
bit-equal to each other.
"""
import functools

import jax
import numpy as np
import optax
import pytest
import torch

import autodist_tpu as jadt
import autodist_tpu_torch as adt
from autodist_tpu import strategy as jstrategy
from autodist_tpu.models import bert as jbert
from autodist_tpu.models import lm as jlm
from autodist_tpu.resource_spec import ResourceSpec as JSpec
from autodist_tpu_torch import strategy
from autodist_tpu_torch.convert import params_from_jax
from autodist_tpu_torch.models import lm as tlm
from autodist_tpu_torch.resource_spec import ResourceSpec
from torch_dist_worker import LR, launch

STEPS = 3
LM_SEQ, LM_BATCH = 16, 8
BERT_SEQ, BERT_BATCH = 32, 4
TWO = {"nodes": [{"address": "127.0.0.1", "chief": True, "cpus": [0, 1]}]}


@pytest.fixture(autouse=True)
def _reset_port():
    yield
    adt.reset()


def _lm_batches(seed=1):
    rng = np.random.RandomState(seed)
    return [{"tokens": rng.randint(0, 128, (LM_BATCH, LM_SEQ + 1)).astype(
        np.int32)} for _ in range(STEPS)]


def _bert_batches(seed=11):
    """Ragged batches: key-padding lengths in [SEQ/2, SEQ] (row 0 full),
    ``mlm_weights`` on real tokens only."""
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


def _jax_run(loss_fn, params, example, batches, **strategy_kw):
    """STEPS JAX AllReduce steps on 2 devices: losses, converted final
    params and the sparse-wire routing of the lowering."""
    try:
        ad = jadt.AutoDist(strategy_builder=jstrategy.AllReduce(
            **strategy_kw), resource_spec=JSpec.from_dict(TWO))
        runner = ad.build(loss_fn, optax.adam(LR), params, example)
        runner.init(params)
        losses = [float(runner.run(b)["loss"]) for b in batches]
        final = params_from_jax(jax.tree_util.tree_map(
            np.asarray, runner.gather_params()))
        routed = runner.distributed_step.metadata["sparse_wire"]
    finally:
        jadt.reset()
    return {"losses": losses, "params": final, "sparse_wire": routed}


CASES = {
    "lm_fp32": ("lm", {}),
    "lm_int8": ("lm", {"wire_dtype": "int8"}),
    "bert_ragged": ("bert", {}),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case: the JAX 2-device run and both port ranks' results,
    from one 2-rank job."""
    jax_out, payload = {}, []
    for case, (model, kw) in CASES.items():
        if model == "lm":
            loss_fn, jparams, example, _ = jlm.make_train_setup(
                jlm.LMConfig.tiny(), seq_len=LM_SEQ, batch_size=LM_BATCH,
                attention="flash", lean_head=True)
            batches, seq, batch, attention = (_lm_batches(), LM_SEQ,
                                              LM_BATCH, "flash")
        else:
            loss_fn, jparams, example, _ = jbert.make_train_setup(
                jbert.BertConfig.tiny(), seq_len=BERT_SEQ,
                batch_size=BERT_BATCH, attention="xla")
            batches, seq, batch, attention = (_bert_batches(), BERT_SEQ,
                                              BERT_BATCH, "xla")
        init = {n: t.numpy() for n, t in params_from_jax(
            jax.tree_util.tree_map(np.asarray, jparams)).items()}
        jax_out[case] = _jax_run(loss_fn, jparams, example, batches, **kw)
        jax_out[case]["init"] = init
        payload.append({"model": model, "seq_len": seq, "batch_size": batch,
                        "attention": attention, "strategy": kw,
                        "init": init, "batches": batches})
    ranks = launch("train", 2, tmp_path_factory.mktemp("dp"), payload)
    return {case: (jax_out[case], [r[i] for r in ranks])
            for i, case in enumerate(CASES)}


def _jax_name_of(port_name):
    from autodist_tpu_torch.convert import jax_name
    return jax_name(port_name, (2, 2))


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_match_the_jax_two_device_runner(runs, case):
    ref, ranks = runs[case]
    for out in ranks:
        np.testing.assert_allclose(out["losses"], ref["losses"], atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(out["eval"], ref["losses"][0], atol=1e-5,
                                   rtol=1e-5)
        assert out["steps"] == STEPS
    final = ranks[0]["params"]
    assert final.keys() == ref["params"].keys()
    for name, value in final.items():
        tol = 2 * STEPS * LR if name.endswith("key.bias") else 1e-4
        np.testing.assert_allclose(value, ref["params"][name].numpy(),
                                   atol=tol, rtol=0, err_msg=name)
        assert not np.array_equal(value, ref["init"][name]), name


@pytest.mark.parametrize("case", list(CASES))
def test_both_ranks_hold_bit_equal_params_and_metrics(runs, case):
    _, (r0, r1) = runs[case]
    assert r0["losses"] == r1["losses"] and r0["eval"] == r1["eval"]
    for name in r0["params"]:
        assert np.array_equal(r0["params"][name], r1["params"][name]), name


@pytest.mark.parametrize("case", list(CASES))
def test_sparse_wire_tables_route_as_jax_routes_them(runs, case):
    ref, ranks = runs[case]
    for out in ranks:
        assert [_jax_name_of(n) for n in out["sparse_wire"]] == \
            ref["sparse_wire"]
    want = {"lm_fp32": ["params/pos_embed/embedding"],
            "lm_int8": ["params/pos_embed/embedding"],
            "bert_ragged": []}
    assert ref["sparse_wire"] == want[case]


def test_int8_wire_buckets_and_error_feedback_state(runs):
    """wire_dtype="int8": one Int8CompressorEF bucket (chunk 128 over lm
    tiny's 38 variables), without the embedding tables (C2) or the
    variables under one scale block; its EF residual in sync_state."""
    _, ranks = runs["lm_int8"]
    for out in ranks:
        (key, members), = out["buckets"]
        assert key == "g0_Int8CompressorEF_float32_AUTO"
        assert not any("embed" in n for n in members)
        assert all(not n.endswith(("bias", "LayerNorm_0.weight"))
                   for n in members)
        assert out["sync_state"] == {"bucket": [key]}
    _, ranks = runs["lm_fp32"]
    assert ranks[0]["buckets"] == [] and ranks[0]["sync_state"] == {}


def test_one_replica_issues_no_collective(monkeypatch):
    """With no process group the step is the one-replica step of PR 2: no
    collective, no sync state."""
    def refuse(*a, **k):
        raise AssertionError("a collective was issued")
    for name in ("all_reduce", "broadcast", "all_to_all_single",
                 "all_gather"):
        monkeypatch.setattr(torch.distributed, name, refuse)
    loss_fn, params, batch, _ = tlm.make_train_setup(
        tlm.LMConfig.tiny(), seq_len=LM_SEQ, batch_size=4)
    ad = adt.AutoDist(strategy_builder=strategy.AllReduce(wire_dtype="int8"),
                      device="cpu")
    runner = ad.build(loss_fn, functools.partial(torch.optim.Adam, lr=LR),
                      params, batch)
    runner.init(params)
    assert np.isfinite(float(runner.run(batch)["loss"]))
    assert runner.distributed_step.num_replicas == 1
    assert runner.state.sync_state == {}


def test_plan_replicas_must_equal_the_world_size():
    loss_fn, params, batch, _ = tlm.make_train_setup(
        tlm.LMConfig.tiny(), seq_len=LM_SEQ, batch_size=4)
    ad = adt.AutoDist(strategy_builder=strategy.AllReduce(), device="cpu",
                      resource_spec=ResourceSpec.from_dict(TWO))
    with pytest.raises(ValueError, match="2 replicas but the process group "
                                         "has 1 ranks"):
        ad.build(loss_fn, functools.partial(torch.optim.Adam, lr=LR),
                 params, batch)


def _rhd(plan):
    plan.node_config[0].synchronizer.schedule = "rhd"


def _ps(plan):
    from autodist_tpu_torch.strategy.base import PSSynchronizer
    plan.node_config[0].synchronizer = PSSynchronizer(
        reduction_destination="127.0.0.1:CPU:0", staleness=2)


@pytest.mark.parametrize("mutate,roadmap_item", [(_rhd, 7), (_ps, 8)],
                         ids=["rhd", "ps"])
def test_unported_features_raise_at_two_replicas(mutate, roadmap_item):
    """Features the port has not reached raise at N > 1, naming the
    ROADMAP item: the rhd all-reduce schedule (item 7) and a PS
    synchronizer's bounded staleness, the Runner's cross-process step
    window (item 8's control plane); nothing is silently ignored."""
    from autodist_tpu_torch.kernel.graph_transformer import GraphTransformer
    from autodist_tpu_torch.kernel.replicator import ReplicaInfo
    from autodist_tpu_torch.model_item import ModelItem
    from autodist_tpu_torch.strategy.base import StrategyCompiler
    loss_fn, params, batch, _ = tlm.make_train_setup(
        tlm.LMConfig.tiny(), seq_len=LM_SEQ, batch_size=4)
    item = ModelItem(loss_fn=loss_fn, params=params,
                     example_batch=batch).prepare()
    spec = ResourceSpec.from_dict(TWO)
    plan = StrategyCompiler(item, spec).compile(
        strategy.AllReduce().build(item, spec))
    mutate(plan)
    with pytest.raises(NotImplementedError,
                       match="ROADMAP A item %d" % roadmap_item):
        GraphTransformer(plan, item, "cpu", ReplicaInfo(2, 0)).transform()


def test_a_missing_card_raises_and_never_falls_back(monkeypatch):
    """A rank's card that is not visible raises; no other card, no CPU."""
    from autodist_tpu_torch.utils.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert resolve_device(None, 0) == torch.device("cuda:0")
    with pytest.raises(RuntimeError, match="cuda:1 does not exist"):
        resolve_device(None, 1)
    with pytest.raises(RuntimeError, match="cuda:3 does not exist"):
        resolve_device("cuda:3")


def test_resource_spec_lists_two_replicas_on_one_card():
    spec = ResourceSpec.from_dict({"nodes": [{
        "address": "127.0.0.1", "chief": True, "gpus": [0, 0]}]})
    assert [d.name_string() for d in spec.devices] == \
        ["127.0.0.1:GPU:0", "127.0.0.1:GPU:0"]
    plan = strategy.AllReduce().build(_OneVar(), spec)
    assert len(plan.graph_config.replicas) == 2


class _OneVar:
    def __init__(self):
        from autodist_tpu_torch.model_item import VarInfo
        self.var_infos = {"w": VarInfo("w", (4, 4), "float32")}
        self.trainable_var_names = ["w"]
