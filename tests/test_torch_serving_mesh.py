"""autodist_tpu_torch serving under a model or expert axis, against the JAX
package.

One 2-rank and one 4-rank gloo job (``mesh_job`` in
``tests/torch_dist_worker.py``) build the engines a user builds over a
runner of a mesh plan: rank 0 dispatches, the other ranks' loops run its
headers. A bucket (or the decode slots) splits over the batch axes only
(the data axis; data and expert under ``ExpertParallel``), the ranks of
one model line run the same rows with the model axis bound, and the rows
come back over the batch axes' group.

- ``InferenceEngine`` on ``tp_lm.tiny`` under ``TensorParallel(2)`` at 2
  ranks (``{data: 1, model: 2}``) and at 4 (``{data: 2, model: 2}``, with
  ``layer_0/mlp/b2`` on host PS: each rank serves the store's snapshot), and
  on ``moe_lm.tiny`` (no drops) under ``ExpertParallel(2)`` at 2 ranks
  (``{data: 1, expert: 2}``): each group's last-position logits (the
  vocab columns of a model line put together in the serve function)
  within 1e-5 of the JAX engine's under the same plan on its 8 virtual
  devices, same params, same buckets.
- ``DecodeEngine`` on ``lm.tiny`` under ``TensorParallel(2, [])`` (the
  model axis has size 2 and shards nothing: the JAX package has no
  model-parallel decode model) at 4 ranks: its tokens equal the JAX
  engine's, and each rank decodes 8 / 2 slots.
"""
import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import autodist_tpu as jadt
import autodist_tpu_torch as adt
from autodist_tpu import strategy as jstrategy
from autodist_tpu.models import lm as jlm
from autodist_tpu.models import moe_lm as jmoe
from autodist_tpu.models import tp_lm as jtp_lm
from autodist_tpu.parallel.sequence import axis_bound
from autodist_tpu.serving import InferenceEngine as JEngine
from autodist_tpu.serving import ServingConfig as JConfig
from autodist_tpu.serving.decode import DecodeConfig as JDecodeConfig
from autodist_tpu.serving.decode import DecodeEngine as JDecodeEngine
from autodist_tpu_torch import convert
from test_torch_mesh_storage import jax_pinned
from torch_dist_worker import launch

E = jmoe.MoEConfig.tiny().num_experts
PROMPT = 8


@pytest.fixture(autouse=True)
def _reset():
    yield
    adt.reset()
    jadt.reset()


def _flat(tree):
    return {n: t.numpy() for n, t in convert.tp_lm_params_from_jax(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


def _requests(vocab, n, seed):
    rng = np.random.RandomState(seed)
    return [{"tokens": rng.randint(0, vocab, (PROMPT,)).astype(np.int32)}
            for _ in range(n)]


def _tp_serve(cfg):
    def serve(p, b):
        logits = jtp_lm.forward(p, b["tokens"], cfg)[:, -1]
        if axis_bound("model"):
            logits = jax.lax.all_gather(logits, "model", axis=1, tiled=True)
        return {"logits": logits}
    return serve


def _moe_serve(cfg):
    return lambda p, b: {"logits": jmoe.forward(p, b["tokens"], cfg)[0][
        :, -1]}


def _jax_groups(builder, setup, serve, requests, buckets, groups):
    """Each group's logits from the JAX engine under ``builder``."""
    loss_fn, params, batch = setup
    try:
        runner = jadt.AutoDist(strategy_builder=builder).build(
            loss_fn, optax.adam(1e-3), params, batch)
        runner.init(params)
        engine = JEngine(runner, serve, requests[0],
                         JConfig(buckets=buckets))
        return [np.asarray(engine.run_batch(requests[:n])[0]["logits"])
                for n in groups]
    finally:
        jadt.reset()


def _engine_case(name, builder, kw, model, buckets, groups, ps=()):
    if model == "moe_lm":
        cfg = jmoe.MoEConfig.tiny(capacity_factor=float(E))
        loss_fn, params, batch, _ = jmoe.make_train_setup(
            cfg, seq_len=16, batch_size=8, seed=2, aux_coef=0.0)
        serve, jb = _moe_serve(cfg), jstrategy.ExpertParallel(
            ep_shards=2, mp_rules=jmoe.ep_rules())
    else:
        cfg = jtp_lm.TPLMConfig.tiny()
        loss_fn, params, batch, _ = jtp_lm.make_train_setup(
            cfg, seq_len=16, batch_size=8, seed=3)
        serve, jb = _tp_serve(cfg), jax_pinned(jstrategy.TensorParallel(
            2, jtp_lm.tp_rules()), ps=ps)
    requests = _requests(64, max(groups), 5)
    case = {"name": name, "kind": "engine", "model": model,
            "builder": builder, "kw": kw, "init": _flat(params),
            "batch": batch, "requests": requests, "buckets": buckets,
            "groups": groups, "ps": list(ps),
            "cfg": {"capacity_factor": float(E)}
            if model == "moe_lm" else {}}
    return case, lambda: _jax_groups(jb, (loss_fn, params, batch), serve,
                                     requests, buckets, groups)


def _decode_case():
    cfg = jlm.LMConfig.tiny()
    loss_fn, params, batch, _ = jlm.make_train_setup(
        cfg, seq_len=16, batch_size=8, lean_head=False)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, cfg.vocab_size, (1 + i % 6,)).astype(np.int32)
               for i in range(10)]
    caps = [2 + (i * 3) % 7 for i in range(10)]
    case = {"name": "decode", "kind": "decode", "model": "lm",
            "builder": "TensorParallel", "kw": {"tp_shards": 2},
            "jax_params": jax.tree_util.tree_map(np.asarray, params),
            "prompts": prompts, "caps": caps}
    return case, lambda: _jax_decode(cfg, loss_fn, params, batch, prompts,
                                     caps)


def _jax_decode(cfg, loss_fn, params, batch, prompts, caps):
    """Each prompt's tokens from the JAX engine under ``TensorParallel(2,
    [])``."""
    try:
        runner = jadt.AutoDist(strategy_builder=jstrategy.TensorParallel(
            2, [])).build(loss_fn, optax.adam(1e-3), params, batch)
        runner.init(params)
        engine = JDecodeEngine(runner, jlm.make_decode_setup(cfg),
                               JDecodeConfig(slots=8, max_new_tokens=8,
                                             prefill_len=8))
        futures = [engine.submit(p, max_new_tokens=m)
                   for p, m in zip(prompts, caps)]
        want = [list(map(int, f.result(timeout=120)["tokens"]))
                for f in futures]
        engine.close()
    finally:
        jadt.reset()
    return want


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """Both gloo jobs, run in a thread while the JAX engines compute."""
    refs, two, four = {}, [], []
    for name, world, builder, kw, model, buckets, groups, ps in (
            ("tp2", 2, "TensorParallel", {"tp_shards": 2}, "tp_lm",
             (4, 8), (3, 8), ()),
            ("ep2", 2, "ExpertParallel", {"ep_shards": 2}, "moe_lm",
             (8, 16), (3, 11), ()),
            ("dp2xtp2", 4, "TensorParallel", {"tp_shards": 2}, "tp_lm",
             (4, 8), (3, 8), ("layer_0/mlp/b2",))):
        case, refs[name] = _engine_case(name, builder, kw, model, buckets,
                                        groups, ps)
        (two if world == 2 else four).append(case)
    case, refs["decode"] = _decode_case()
    four.append(case)
    dirs = {w: tmp_path_factory.mktemp("smesh%d" % w) for w in (2, 4)}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jobs = {w: pool.submit(launch, "mesh", w, dirs[w], cases)
                for w, cases in ((2, two), (4, four))}
        want = {name: ref() for name, ref in refs.items()}
        ranks = {w: got.result() for w, got in jobs.items()}
    return ranks, want


@pytest.mark.parametrize("case,world,replicas", [("tp2", 2, 1),
                                                 ("ep2", 2, 2),
                                                 ("dp2xtp2", 4, 2)])
def test_engine_logits_equal_jax(job, case, world, replicas):
    """Each request group's logits within 1e-5 of the JAX engine's; the
    bucket splits over the batch replicas only (the rank's batch index:
    its data index, or data and expert), and every follower ran every
    dispatch the chief did."""
    ranks, want = job
    chief = ranks[world][0][case]
    for got, ref in zip(chief["groups"], want[case]):
        assert got["logits"].shape == ref.shape
        np.testing.assert_allclose(got["logits"], ref, rtol=1e-5, atol=1e-5)
    for rank, r in enumerate(ranks[world]):
        got = r[case]
        assert got["replicas"] == replicas
        assert got["ps"] == (["layer_0/mlp/b2"] if case == "dp2xtp2" else [])
        if got["ps"]:
            assert got["refreshes"] >= 1
        tp = world // replicas if case != "ep2" else 1
        assert got["batch_index"] == rank // tp
        assert got["batches"] == chief["batches"]
        if rank:
            assert got["followed"] is True


def test_decode_tokens_equal_jax_under_a_model_axis(job):
    """``DecodeEngine`` at ``{data: 2, model: 2}``: every request's tokens
    equal the JAX engine's under the same plan; each rank holds the
    caches of 8 / 2 slots, and every rank ran every step."""
    ranks, want = job
    chief = ranks[4][0]["decode"]
    for i, (r, exp) in enumerate(zip(chief["results"], want["decode"])):
        assert list(map(int, r["tokens"])) == exp, i
    for rank, r in enumerate(ranks[4]):
        got = r["decode"]
        assert got["cache_slots"] == 4
        assert got["steps"] == chief["steps"] > 0
        if rank:
            assert got["followed"] is True


def test_jax_plain_forward_agrees(job):
    """The JAX engines' logits are the plain, unsharded forward's on the
    same requests (the reference the engines are held to is the model)."""
    _, want = job
    cfg = jtp_lm.TPLMConfig.tiny()
    _, params, _, _ = jtp_lm.make_train_setup(cfg, seq_len=16, batch_size=8,
                                              seed=3)
    reqs = _requests(64, 8, 5)
    ids = jnp.asarray(np.stack([r["tokens"] for r in reqs]))
    plain = np.asarray(jtp_lm.forward(params, ids, cfg)[:, -1])
    for name in ("tp2", "dp2xtp2"):
        np.testing.assert_allclose(want[name][-1], plain, rtol=1e-5,
                                   atol=1e-5)
