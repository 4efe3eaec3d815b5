"""autodist_tpu_torch's overlapped gradient-sync schedule
(``graph_config.overlap``; ``parallel/collectives.py``'s schedule IR and
``kernel/graph_transformer.py``'s backward hooks) against the JAX
package's, on the CPU.

- The schedule IR: for the same units the port's
  ``build_grad_sync_schedule`` gives the JAX package's stages, and
  ``describe()`` its text; ``validate()`` refuses what the JAX one
  refuses.
- N = 2: two gloo ranks of the port (one 2-rank job of
  ``tests/torch_dist_worker.py``) against the JAX runner on 2 virtual
  CPU devices, 3 Adam (1e-3) steps from the JAX init: lm tiny (lean
  head, flash attention through the kernels' plain versions) under
  ``AllReduce(overlap=True)`` and ``ZeroSharded(overlap=True)``, and bert
  tiny (ragged key padding) under ``AllReduce(overlap=True)``. Losses
  within 1e-5, params within 1e-4 (the attention key biases, whose
  gradient is zero analytically: 2 x steps x lr). The schedule has the
  JAX lowering's stages in its order (``overlap_schedule``, names mapped
  to the JAX names). Each overlapped run is BIT-EQUAL to the port's own
  epilogue run of the same plan without ``overlap`` (the same units with
  the same arithmetic; only the launch time moves), also with the int8
  wire's compressed buckets; the units launch in the schedule's order,
  the first ones while the backward is still running.
- One replica: the schedule disarms (``overlap_requested`` True,
  ``overlap`` False).
"""
import functools
import re

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
from autodist_tpu.parallel import collectives as jcollectives
from autodist_tpu.resource_spec import ResourceSpec as JSpec
from autodist_tpu_torch import strategy
from autodist_tpu_torch.convert import jax_name, params_from_jax
from autodist_tpu_torch.models import lm as tlm
from autodist_tpu_torch.parallel import collectives
from torch_dist_worker import LR, launch

STEPS = 3
LM_SEQ, LM_BATCH = 16, 8
BERT_SEQ, BERT_BATCH = 32, 4
TWO = {"nodes": [{"address": "127.0.0.1", "chief": True, "cpus": [0, 1]}]}

UNITS = [("bucket:g0_Int8CompressorEF_float32_AUTO", "reduce", ("a", "c"),
          300, "int8", ("data",)),
         ("var:b", "reduce", ("b",), 7, "fp32", ("data",)),
         ("zero:d", "reduce_scatter", ("d",), 64, "int8", ("data",)),
         ("var:e", "reduce", ("e",), 3, "fp32", ("data",))]
POSITIONS = {"a": 0, "b": 4, "c": 2, "d": 3, "e": 1}


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


def test_schedule_ir_matches_jax():
    got = collectives.build_grad_sync_schedule(UNITS, POSITIONS)
    want = jcollectives.build_grad_sync_schedule(UNITS, POSITIONS)
    assert got.describe() == want.describe()
    assert [dict(vars(s), ops=[vars(o) for o in s.ops])
            for s in got.stages] == \
        [dict(vars(s), ops=[vars(o) for o in s.ops]) for s in want.stages]
    assert (got.num_stages, got.num_collectives) == (4, 4)
    assert [s.ops[0].unit for s in got.stages] == \
        ["var:b", "zero:d", "bucket:g0_Int8CompressorEF_float32_AUTO",
         "var:e"]


def test_schedule_ir_validation_refuses_as_jax_does():
    bad = [collectives.ScheduleStage(index=0, ops=(collectives.CollectiveOp(
        kind="reduce", unit="var:a", axes=("data",)),), ready_rank=0),
        collectives.ScheduleStage(index=1, ops=(collectives.CollectiveOp(
            kind="reduce", unit="var:b", axes=("data",)),), ready_rank=5)]
    with pytest.raises(ValueError, match="reverse-readiness"):
        collectives.GradSyncSchedule(stages=tuple(bad)).validate()
    with pytest.raises(ValueError, match="unknown unit kind"):
        collectives.build_grad_sync_schedule(
            [("var:a", "broadcast", ("a",), 1, "fp32", ("data",))], {})


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
        meta = runner.distributed_step.metadata
        return {"losses": losses,
                "params": params_from_jax(jax.tree_util.tree_map(
                    np.asarray, runner.gather_params())),
                "stages": meta["overlap_stages"],
                "schedule": meta["overlap_schedule"]}
    finally:
        jadt.reset()


# case: (model, builder, its kwargs); each runs with overlap=True against
# the JAX runner and without it in the port
CASES = {
    "lm_allreduce": ("lm", "AllReduce", {}),
    "lm_zero": ("lm", "ZeroSharded", {}),
    "bert_allreduce": ("bert", "AllReduce", {}),
    "lm_int8_buckets": ("lm", "AllReduce", {"wire_dtype": "int8",
                                            "chunk_size": 8}),
}
AGAINST_JAX = ("lm_allreduce", "lm_zero", "bert_allreduce")


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
    """Per case: the JAX run (or None) and each rank's (overlapped,
    epilogue) results, from one 2-rank job."""
    jax_out, payload = {}, []
    for case, (model, name, kw) in CASES.items():
        loss_fn, jparams, example, batches, setup = _setup(model)
        init = {n: t.numpy() for n, t in params_from_jax(
            jax.tree_util.tree_map(np.asarray, jparams)).items()}
        jax_out[case] = None
        if case in AGAINST_JAX:
            jax_out[case] = _jax_run(
                loss_fn, jparams, example, batches,
                getattr(jstrategy, name)(overlap=True, **kw))
            jax_out[case]["init"] = init
        for overlap in (True, False):
            payload.append(dict(setup, builder=name, init=init,
                                batches=batches,
                                strategy=dict(kw, overlap=overlap)))
    ranks = launch("train", 2, tmp_path_factory.mktemp("overlap"), payload)
    return {case: (jax_out[case], [(r[2 * i], r[2 * i + 1]) for r in ranks])
            for i, case in enumerate(CASES)}


def _to_jax_names(text, params):
    names = {n: jax_name(n, np.shape(v)) for n, v in params.items()}
    return re.sub(r"\b(var|zero):([^,)\s]+)",
                  lambda m: "%s:%s" % (m.group(1), names[m.group(2)]), text)


@pytest.mark.parametrize("case", AGAINST_JAX)
def test_two_ranks_overlapped_match_the_jax_schedule(runs, case):
    ref, ranks = runs[case]
    for over, _ in ranks:
        np.testing.assert_allclose(over["losses"], ref["losses"], atol=1e-5,
                                   rtol=1e-5)
    final = ranks[0][0]["params"]
    for name, value in final.items():
        tol = 2 * STEPS * LR if name.endswith("key.bias") else 1e-4
        np.testing.assert_allclose(value, ref["params"][name].numpy(),
                                   atol=tol, rtol=0, err_msg=name)
    meta = ranks[0][0]["metadata"]
    assert meta["overlap"] and meta["overlap_stages"] == ref["stages"] >= 2
    assert _to_jax_names(meta["overlap_schedule"], final) == ref["schedule"]
    assert ranks[0][0]["counters"]["overlap.buckets"] == ref["stages"]


@pytest.mark.parametrize("case", list(CASES))
def test_overlap_is_bit_equal_to_the_epilogue(runs, case):
    _, ranks = runs[case]
    for over, epi in ranks:
        assert over["losses"] == epi["losses"]
        assert over["eval"] == epi["eval"]
        for name, value in epi["params"].items():
            assert np.array_equal(over["params"][name], value), name
        for slot in ("mu", "nu"):
            for name, value in epi["opt"][slot].items():
                assert np.array_equal(over["opt"][slot][name], value), name
        assert not epi["metadata"]["overlap"] and epi["overlap_log"] == []
    assert ranks[0][0]["losses"] == ranks[1][0]["losses"]


@pytest.mark.parametrize("case", list(CASES))
def test_units_launch_in_schedule_order_during_the_backward(runs, case):
    _, ranks = runs[case]
    for over, _ in ranks:
        order = [line.split(": ", 1)[1].split("(", 1)[1].split(")")[0]
                 .split(",")[0]
                 for line in over["metadata"]["overlap_schedule"].splitlines()]
        log = over["overlap_log"]
        assert [u for u, _ in log] == order
        during = [d for _, d in log]
        # launched while the backward ran, then the rest after it
        assert during[0] and during == sorted(during, reverse=True)
    if case == "lm_int8_buckets":
        assert any(u.startswith("bucket:") for u, _ in ranks[0][0]
                   ["overlap_log"])


def test_overlap_disarms_at_one_replica():
    loss_fn, params, batch, _ = tlm.make_train_setup(
        tlm.LMConfig.tiny(), seq_len=LM_SEQ, batch_size=4)

    def run(builder):
        ad = adt.AutoDist(strategy_builder=builder, device="cpu")
        runner = ad.build(loss_fn, functools.partial(torch.optim.Adam,
                                                     lr=LR), params, batch)
        runner.init(params)
        losses = [float(runner.run(batch)["loss"]) for _ in range(2)]
        meta = runner.distributed_step.metadata
        adt.reset()
        return losses, meta
    got, meta = run(strategy.AllReduce(overlap=True))
    want, _ = run(strategy.AllReduce())
    assert got == want
    assert meta["overlap_requested"] and not meta["overlap"]
    assert meta["overlap_stages"] == 0 and meta["overlap_schedule"] == ""
