"""autodist_tpu_torch's pipeline parallelism against the JAX package's.

The port's ranks are spawned processes in one gloo group
(``tests/torch_dist_worker.py``'s ``pp`` job), driven through the entry
points a user calls (``AutoDist(strategy_builder=PipelineParallel(...))
.build`` -> ``Runner.init`` -> ``Runner.run`` over the host-global
batches); one 2-rank and one 4-rank job run every multi-process case.
The JAX side runs in the pytest process on the session's 8 virtual CPU
devices. Its runner builds the PipelineParallel mesh over every device,
so it trains at ``{pipe: pp, data: 8 / (pp * tp)[, model: tp]}`` on the
same global batches: the same mean gradient as the port's ``{pipe: pp,
data: N / (pp * tp)[, model: tp]}``, over microbatches of other sizes.

Cases, f32:

- the primitives against the JAX ones inside ``shard_map``, forward and
  gradient in the raw S-inflated convention, 1e-5: ``ppermute`` over a
  chain, a ring and a reversed chain at S = 4; ``pipeline_apply`` at S =
  4, M = 2; ``pipeline_apply_interleaved`` at S = 2, V = 2, M = 4, bound
  and unbound with the hint; ``pipeline_loss_1f1b`` at S = 4, M = 8 (the
  stash wraps twice): loss, dstage, dhead and dx, with the stash's S
  slots; ``remat_chunks``: the same gradients within 1e-5 for under half
  the saved bytes (``torch.autograd.graph.saved_tensors_hooks``);
- ``pipe_lm.tiny`` (seq 16, global batch 8, Adam 1e-3 with eps 1e-6:
  ``ADAM_EPS``), three steps at
  pp 2, pp 4, pp 2 x tp 2 and dp 2 x pp 2 under gpipe, 1f1b and
  interleaved (V = 2) against the JAX runner: losses 1e-5, params rtol
  2e-5 / atol 2e-6; each rank's ``[L/S, ...]`` slice and mesh place;
- the plan's JSON bytes and layouts, ``init_params``, the unbound
  forward with the flash kernels' plain versions in ``attn_fn``, the
  setup's and the build's ``ValueError``s, each against JAX;
- the pp 2 sharded checkpoint restored at pp 1 by the port and at pp 2 by
  the JAX package; the sentinel's verdict at pp 2 seeing a NaN on one
  rank's slice (both ranks skip, bit-equal to a run without the step);
  ADT430 sending a pp job to the whole-job restart.
"""
import functools
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import autodist_tpu as jadt
import autodist_tpu_torch as adt
from autodist_tpu import strategy as jstrategy
from autodist_tpu.models import pipe_lm as jpipe_lm
from autodist_tpu.models.tp_lm import TPLMConfig as JConfig
from autodist_tpu.parallel import pipeline as jpl
from autodist_tpu.resource_spec import ResourceSpec as JSpec
from autodist_tpu_torch import const, convert, strategy
from autodist_tpu_torch.models import pipe_lm
from autodist_tpu_torch.parallel import pipeline
from autodist_tpu_torch.resource_spec import ResourceSpec
from torch_dist_worker import launch

STEPS = 3
LR = 1e-3
# Adam's first step moves each element by lr * g / (|g| + eps): for an
# element whose gradient is near eps, the packages' f32 reduction-order
# difference in g (~1e-9 here) becomes a parameter difference of up to
# lr * 1e-9 / eps, 1e-4 at the default eps 1e-8 (one blocks/attn/wo
# element with g = 6e-9 differed by 1.1e-5 after three steps); at 1e-6
# the bound is 1e-6, under the params' atol of 2e-6, whatever the data
ADAM_EPS = 1e-6
PIPE = const.PIPELINE_AXIS
SCHEDULES = ("gpipe", "1f1b", "interleaved")
# (pp, tp, microbatches) of the JAX test_pp_lm_matches_single_device
CONFIGS = ((2, 1, 2), (4, 1, 4), (2, 2, 2))


def _spec(n):
    return {"nodes": [{"address": "127.0.0.1", "chief": True,
                       "cpus": list(range(n))}]}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reset_port():
    yield
    adt.reset()
    jadt.reset()


# ----------------------------------------------------- the primitives


def _pmesh(S):
    return Mesh(np.array(jax.devices()[:S]), (PIPE,))


def _block(w, h):
    return jnp.tanh(h @ w)


def _stage(w, h):
    return jpl.stacked_scan(_block, w, h)


def _prim_inputs():
    rng = np.random.RandomState(0)
    D = 6
    return {
        "ppermute": {"kind": "ppermute",
                     "x": rng.standard_normal((4, 3, 5)).astype(np.float32),
                     "w": rng.standard_normal((4, 3, 5)).astype(np.float32),
                     "perms": [[(i, i + 1) for i in range(3)],
                               [(i, (i + 1) % 4) for i in range(4)],
                               [(i + 1, i) for i in range(3)]]},
        "gpipe": {"kind": "gpipe", "M": 2,
                  "ws": (rng.standard_normal((4, D, D)) * 0.3
                         ).astype(np.float32),
                  "x": rng.standard_normal((8, D)).astype(np.float32)},
        # 8 layers per chunk, microbatches of 16 rows: the intra-chunk
        # activations dominate what the backward keeps
        "interleaved": {"kind": "interleaved", "M": 4, "V": 2,
                        "remat": True,
                        "ws": (rng.standard_normal((32, 8, 8)) * 0.2
                               ).astype(np.float32),
                        "x": rng.standard_normal((64, 8)).astype(
                            np.float32)},
        "1f1b": {"kind": "1f1b", "M": 8,
                 "ws": (rng.standard_normal((8, D, D)) * 0.3
                        ).astype(np.float32),
                 "hw": rng.standard_normal((D, 1)).astype(np.float32),
                 "x": rng.standard_normal((16, D)).astype(np.float32),
                 "y": rng.standard_normal((16, 1)).astype(np.float32)},
    }


def _jax_prims(inp):
    out = {}
    pp = inp["ppermute"]
    res = []
    for perm in pp["perms"]:
        def f(x, w, perm=perm):
            y, vjp = jax.vjp(lambda xx: jax.lax.ppermute(xx, PIPE, perm), x)
            return y, vjp(w)[0]
        y, g = jax.jit(jax.shard_map(
            f, mesh=_pmesh(4), in_specs=(P(PIPE), P(PIPE)),
            out_specs=(P(PIPE), P(PIPE)), check_vma=False))(
                pp["x"], pp["w"])
        res.append({"y": np.asarray(y), "g": np.asarray(g)})
    out["ppermute"] = res

    def apply_case(case, S, apply):
        def f(ws, x):
            def loss(w, xx):
                return jnp.sum(apply(w, xx) ** 2)
            val, (dws, dx) = jax.value_and_grad(loss, argnums=(0, 1))(ws, x)
            return val, dws, dx[None], apply(ws, x)
        loss, dws, dx, y = jax.jit(jax.shard_map(
            f, mesh=_pmesh(S), in_specs=(P(PIPE), P()),
            out_specs=(P(), P(PIPE), P(PIPE), P()), check_vma=False))(
                case["ws"], case["x"])
        return {"loss": np.asarray(loss), "dstage": np.asarray(dws),
                "dx": np.asarray(dx), "y": np.asarray(y)}
    g = inp["gpipe"]
    out["gpipe"] = apply_case(g, 4, lambda w, x: jpl.pipeline_apply(
        _stage, w, x, g["M"]))
    il = inp["interleaved"]
    out["interleaved"] = apply_case(
        il, 2, lambda w, x: jpl.pipeline_apply_interleaved(
            _stage, w, x, il["M"], il["V"]))
    ob = inp["1f1b"]

    def head(hp, h, y):
        return jnp.mean((h @ hp - y) ** 2)

    def f1(ws, hw, x):
        def loss(w, h, xx):
            return jpl.pipeline_loss_1f1b(_stage, head, w, h, xx, ob["y"],
                                          ob["M"])
        val, (dws, dhw, dx) = jax.value_and_grad(
            loss, argnums=(0, 1, 2))(ws, hw, x)
        return val, dws, dhw, dx[None]
    loss, dws, dhw, dx = jax.jit(jax.shard_map(
        f1, mesh=_pmesh(4), in_specs=(P(PIPE), P(), P()),
        out_specs=(P(), P(PIPE), P(), P(PIPE)), check_vma=False))(
            ob["ws"], ob["hw"], ob["x"])
    out["1f1b"] = {"loss": np.asarray(loss), "dstage": np.asarray(dws),
                   "dhead": np.asarray(dhw), "dx": np.asarray(dx)}
    return out


# ---------------------------------------------------------- training


def _cfg_kw(pp):
    # two layers a stage, so that the interleaved schedule's V = 2 chunks
    # each hold one
    return {"num_layers": 2 * pp}


def _setup_kw(pp, micro, schedule):
    kw = {"n_microbatches": micro, "schedule": schedule}
    if schedule == "interleaved":
        kw.update(virtual_stages=2, pp_shards=pp)
    return kw


def _lm(pp, micro, schedule):
    loss_fn, params, batch, _ = jpipe_lm.make_train_setup(
        JConfig.tiny(**_cfg_kw(pp)), seq_len=16, batch_size=8, seed=1,
        **_setup_kw(pp, micro, schedule))
    rng = np.random.RandomState(2)
    batches = [batch] + [{"tokens": rng.randint(
        0, 64, batch["tokens"].shape).astype(np.int32)}
        for _ in range(STEPS - 1)]
    return loss_fn, params, batches


def _flat(tree):
    return {n: t.numpy() for n, t in convert.pipe_lm_params_from_jax(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


def _jax_builder(pp, tp, micro, schedule):
    return jstrategy.PipelineParallel(
        pp_shards=pp, tp_shards=tp, n_microbatches=micro,
        schedule=schedule, virtual_stages=2,
        mp_rules=jpipe_lm.pp_rules(
            model_axis=const.MODEL_AXIS if tp > 1 else None))


def _jax_run(pp, tp, micro, schedule):
    """The JAX PipelineParallel runner on the session's 8 devices:
    losses, gathered params (flat numpy) and each variable's mp layout."""
    loss_fn, params, batches = _lm(pp, micro, schedule)
    try:
        runner = jadt.AutoDist(strategy_builder=_jax_builder(
            pp, tp, micro, schedule)).build(
                loss_fn, optax.adam(LR, eps=ADAM_EPS), params, batches[0])
        runner.init(params)
        losses = [float(runner.run(b)["loss"]) for b in batches]
        layouts = {n: lay.mp_axes for n, lay in
                   runner.distributed_step.layouts.items() if lay.mp_axes}
        return {"losses": losses, "params": _flat(runner.gather_params()),
                "mp_axes": layouts, "init": _flat(params),
                "batches": batches}
    finally:
        jadt.reset()


def _train(ref, pp, tp, micro, schedule, **kw):
    case = {"kind": "train", "pp": pp, "tp": tp, "M": micro,
            "schedule": schedule, "layers": _cfg_kw(pp)["num_layers"],
            "init": ref["init"], "batches": ref["batches"], "lr": LR,
            "eps": ADAM_EPS}
    case.update(kw)
    return case


@pytest.fixture(scope="module")
def refs():
    out = {"prims": _prim_inputs()}
    out["jax_prims"] = _jax_prims(out["prims"])
    for pp, tp, micro in CONFIGS:
        for schedule in SCHEDULES:
            out[pp, tp, schedule] = _jax_run(pp, tp, micro, schedule)
    return out


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("pp_ckpt"))


def _two(refs, ckpt_dir):
    prims = refs["prims"]
    g2 = refs[2, 1, "gpipe"]
    skip = dict(g2, batches=[g2["batches"][0], g2["batches"][2]])
    cases = [("interleaved_prim", prims["interleaved"])]
    for schedule in SCHEDULES:
        kw = {"save_dir": ckpt_dir} if schedule == "gpipe" else {}
        cases.append(("pp2_" + schedule, _train(
            refs[2, 1, schedule], 2, 1, 2, schedule, **kw)))
    nan = [{"var": "blocks/attn/wq", "mode": "nan", "step": 1}]
    cases += [("sentinel_nan", _train(g2, 2, 1, 2, "gpipe", sentinel=True,
                                      plan=nan, plan_ranks=[1])),
              ("sentinel_clean", _train(skip, 2, 1, 2, "gpipe",
                                        sentinel=True)),
              ("pp2_restore", _train(g2, 2, 1, 2, "gpipe",
                                     restore_dir=ckpt_dir))]
    return cases


def _four(refs):
    prims = refs["prims"]
    cases = [(k + "_prim", prims[k]) for k in ("ppermute", "gpipe", "1f1b")]
    for schedule in SCHEDULES:
        cases += [
            ("pp4_" + schedule, _train(refs[4, 1, schedule], 4, 1, 4,
                                       schedule)),
            ("pp2xtp2_" + schedule, _train(refs[2, 2, schedule], 2, 2, 2,
                                           schedule)),
            ("dp2xpp2_" + schedule, _train(refs[2, 1, schedule], 2, 1, 2,
                                           schedule))]
    return cases


@pytest.fixture(scope="module")
def runs(refs, tmp_path_factory, ckpt_dir):
    """Each case's ranks' results, by case name: one 2-rank and one
    4-rank job."""
    out = {}
    for world, cases in ((2, _two(refs, ckpt_dir)), (4, _four(refs))):
        ranks = launch("pp", world, tmp_path_factory.mktemp("pp%d" % world),
                       [c for _, c in cases])
        for i, (name, _) in enumerate(cases):
            out[name] = [r[i] for r in ranks]
    return out


# ----------------------------------------------------------------- tests


def test_ppermute_matches_jax(refs, runs):
    """Each rank gets its source's tensor (zeros where no pair ends) and
    the gradient moves along the inverse permutation."""
    want = refs["jax_prims"]["ppermute"]
    for rank, got in enumerate(runs["ppermute_prim"]):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["y"], w["y"][rank])
            np.testing.assert_array_equal(g["g"], w["g"][rank])


@pytest.mark.parametrize("case,S", [("gpipe", 4), ("interleaved", 2)])
def test_pipelined_apply_matches_jax(refs, runs, case, S):
    """The output on every rank, the loss and the gradients in the raw
    S-inflated convention (each rank's stage slice; dx on rank 0 only)."""
    want = refs["jax_prims"][case]
    ranks = runs[case + "_prim"]
    assert len(ranks) == S
    for rank, got in enumerate(ranks):
        assert got["stages"] == S
        np.testing.assert_allclose(got["y"], want["y"], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["dx"], want["dx"][rank], rtol=1e-5,
                                   atol=1e-5)
        if rank:
            assert not got["dx"].any()
    dstage = np.concatenate([r["dstage"] for r in ranks])
    np.testing.assert_allclose(dstage, want["dstage"], rtol=1e-5, atol=1e-5)


def test_interleaved_unbound_with_the_hint_matches_jax(refs):
    """One process: the hint's logical layer order, forward and gradient,
    against the JAX degenerate path; without the hint the plain stack."""
    il = refs["prims"]["interleaved"]

    def tstage(w, h):
        return pipeline.stacked_scan(lambda p, hh: torch.tanh(hh @ p), w, h)
    ws = torch.as_tensor(il["ws"]).requires_grad_()
    x = torch.as_tensor(il["x"])
    y = pipeline.pipeline_apply_interleaved(tstage, ws, x, il["M"], il["V"],
                                            pp_shards_hint=2)
    g, = torch.autograd.grad((y ** 2).sum(), ws)

    def jloss(w):
        return jnp.sum(jpl.pipeline_apply_interleaved(
            _stage, w, il["x"], il["M"], il["V"], pp_shards_hint=2) ** 2)
    jy = jpl.pipeline_apply_interleaved(_stage, il["ws"], il["x"], il["M"],
                                        il["V"], pp_shards_hint=2)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(jax.grad(jloss)(
        il["ws"])), rtol=1e-5, atol=1e-6)
    assert pipeline.num_stages() == 1
    plain = pipeline.pipeline_apply_interleaved(tstage, ws, x, il["M"],
                                                il["V"])
    np.testing.assert_array_equal(plain.detach().numpy(),
                                  tstage(ws, x).detach().numpy())
    # the pipelined program computes the hint's order, not the plain one
    np.testing.assert_allclose(refs["jax_prims"]["interleaved"]["y"],
                               np.asarray(jy), rtol=1e-5, atol=1e-6)


def test_remat_chunks_same_grads_under_half_the_saved_bytes(runs):
    """remat_chunks keeps each slot's input only: the same loss and
    gradients within 1e-5, under half the bytes the forward saves for
    the backward."""
    for got in runs["interleaved_prim"]:
        remat = got["remat"]
        np.testing.assert_allclose(remat["dstage"], got["dstage"],
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(remat["dx"], got["dx"], rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(remat["loss"], got["loss"], rtol=1e-6)
        assert 0 < remat["saved_bytes"] < 0.5 * got["saved_bytes"], \
            (remat["saved_bytes"], got["saved_bytes"])


def test_1f1b_matches_jax_and_its_stash_holds_s_slots(refs, runs):
    """S = 4, M = 8: the loss on every rank, the stage gradients
    (S-inflated), the head gradients (uniform) and dx (rank 0 only)
    against the JAX fused schedule; the stash has S slots, never more
    than S live, while M microbatches pass."""
    want = refs["jax_prims"]["1f1b"]
    ranks = runs["1f1b_prim"]
    for rank, got in enumerate(ranks):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["dhead"], want["dhead"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got["dx"], want["dx"][rank], rtol=1e-5,
                                   atol=1e-6)
        assert got["stash_slots"] == 4 and got["stash_peak"] <= 4 < 8
    dstage = np.concatenate([r["dstage"] for r in ranks])
    np.testing.assert_allclose(dstage, want["dstage"], rtol=1e-5, atol=1e-6)


TRAIN = ["pp2_" + s for s in SCHEDULES] + ["pp4_" + s for s in SCHEDULES] \
    + ["pp2xtp2_" + s for s in SCHEDULES] \
    + ["dp2xpp2_" + s for s in SCHEDULES]


def _key(case):
    shape, schedule = case.split("_")
    pp, tp = {"pp2": (2, 1), "pp4": (4, 1), "pp2xtp2": (2, 2),
              "dp2xpp2": (2, 1)}[shape]
    return pp, tp, schedule


@pytest.mark.parametrize("case", TRAIN)
def test_training_matches_the_jax_runner(refs, runs, case):
    """Three Adam steps: every rank's losses and gathered params against
    the JAX PipelineParallel runner's; the same mp layouts."""
    ref = refs[_key(case)]
    for r in runs[case]:
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=1e-5,
                                   atol=1e-5)
        assert sorted(r["params"]) == sorted(ref["params"])
        for n, want in ref["params"].items():
            np.testing.assert_allclose(r["params"][n], want, rtol=2e-5,
                                       atol=2e-6, err_msg=n)
        assert {n: tuple(map(tuple, a)) for n, a in r["mp_axes"].items()} \
            == ref["mp_axes"]
        assert r["ranks_equal"]


@pytest.mark.parametrize("case", ["pp2_gpipe", "pp4_1f1b",
                                  "pp2xtp2_interleaved", "dp2xpp2_gpipe"])
def test_each_rank_holds_its_layer_slice(refs, runs, case):
    """Rank r sits at pipe index r // (data * tp), data index r // tp %
    data, model index r % tp (the JAX device grid); it stores its
    ``[L/S, ...]`` slice of each block variable (heads and hidden dims
    split by tp too) and of its Adam moments; the moves are counted."""
    pp, tp, _ = _key(case)
    ranks = runs[case]
    world = len(ranks)
    dp = world // (pp * tp)
    full = {n: v.shape for n, v in refs[_key(case)]["init"].items()}
    for rank, r in enumerate(ranks):
        mesh = {"pipe": pp, "data": dp}
        if tp > 1:
            mesh["model"] = tp
        assert r["mesh"] == mesh
        assert r["coords"]["pipe"] == rank // (dp * tp)
        assert r["coords"]["data"] == rank // tp % dp
        for n, shape in full.items():
            want = list(shape)
            for dim, axis in r["mp_axes"].get(n, ()):
                want[dim] //= {"pipe": pp, "model": tp}[axis]
            assert r["local_shapes"][n] == tuple(want), n
            assert r["opt_shapes"][n] == tuple(want), n
        assert r["local_shapes"]["blocks/attn/wq"][0] == \
            full["blocks/attn/wq"][0] // pp
        assert r["counters"]["pp.p2p_sends"] > 0
        assert r["counters"]["pp.p2p_bytes"] > 0


def test_sentinel_sees_a_nan_on_one_pipe_ranks_slice(runs):
    """A NaN in rank 1's slice of ``blocks/attn/wq`` at step 1: both
    ranks' verdicts say bad (the pipe-sharded gradients' sums reach
    every rank), both skip the step, and the params and the losses
    after it are bit-equal to a run without that batch."""
    bad, clean = runs["sentinel_nan"], runs["sentinel_clean"]
    for r, c in zip(bad, clean):
        assert [v["ok"] for v in r["verdicts"]] == [1.0, 0.0, 1.0]
        assert r["verdicts"][1]["bad_grads"] > 0
        assert r["ranks_equal"]
        assert [r["losses"][0], r["losses"][2]] == c["losses"]
        for n, want in c["params"].items():
            np.testing.assert_array_equal(r["params"][n], want, err_msg=n)


def _port_item(pp, micro, schedule):
    from autodist_tpu_torch.model_item import ModelItem
    loss_fn, params, batch, _ = pipe_lm.make_train_setup(
        pipe_lm.TPLMConfig.tiny(**_cfg_kw(pp)), seq_len=16, batch_size=8,
        seed=1, **_setup_kw(pp, micro, schedule))
    return ModelItem(loss_fn=loss_fn, params=params,
                     example_batch=batch).prepare()


def _jax_item(pp, micro, schedule):
    from autodist_tpu.model_item import ModelItem as JModelItem
    loss_fn, params, batches = _lm(pp, micro, schedule)
    return JModelItem(loss_fn=loss_fn, params=params,
                      example_batch=batches[0]).prepare()


@pytest.mark.parametrize("pp,tp,micro,world,schedule", [
    (2, 1, 2, 2, "gpipe"), (4, 1, 4, 4, "1f1b"), (2, 2, 2, 4, "interleaved"),
    (2, 1, 2, 4, "gpipe")])
def test_plan_bytes_and_layouts_match_jax(pp, tp, micro, world, schedule):
    """The PipelineParallel plan over the same variable list and spec is
    the JAX builder's, byte for byte; the partitioner gives the JAX
    layouts (``blocks/attn/wq`` over pipe and, at tp 2, model)."""
    from autodist_tpu.kernel.partitioner import VariablePartitioner as JVP
    from autodist_tpu_torch.kernel.partitioner import VariablePartitioner
    titem, jitem = _port_item(pp, micro, schedule), \
        _jax_item(pp, micro, schedule)
    model_axis = const.MODEL_AXIS if tp > 1 else None
    jplan = _jax_builder(pp, tp, micro, schedule).build(
        jitem, JSpec.from_dict(_spec(world)))
    tplan = strategy.PipelineParallel(
        pp_shards=pp, tp_shards=tp, n_microbatches=micro, schedule=schedule,
        mp_rules=pipe_lm.pp_rules(model_axis=model_axis)).build(
            titem, ResourceSpec.from_dict(_spec(world)))
    tplan.id = jplan.id
    dump = lambda p: json.dumps(p.to_dict(), sort_keys=True)  # noqa: E731
    assert dump(tplan) == dump(jplan)
    sizes = dict(tplan.graph_config.mesh_shape)
    got = VariablePartitioner.apply(tplan, titem.var_infos, world, sizes)
    want = JVP.apply(jplan, jitem.var_infos, sizes["data"],
                     mesh_axis_sizes=sizes)
    assert {n: lay.mp_axes for n, lay in got.items()} == \
        {n: lay.mp_axes for n, lay in want.items()}
    wq = ((0, PIPE), (2, const.MODEL_AXIS)) if tp > 1 else ((0, PIPE),)
    assert got["blocks/attn/wq"].mp_axes == wq


def test_pipeline_parallel_argument_checks_match_jax():
    for kw in (dict(pp_shards=0), dict(tp_shards=0),
               dict(n_microbatches=0), dict(schedule="zigzag"),
               dict(schedule="interleaved", virtual_stages=1),
               dict(schedule="interleaved", n_microbatches=3)):
        args = dict(pp_shards=2, mp_rules=pipe_lm.pp_rules())
        args.update(kw)
        with pytest.raises(ValueError) as want:
            jstrategy.PipelineParallel(**args)
        with pytest.raises(ValueError) as got:
            strategy.PipelineParallel(**args)
        assert str(got.value) == str(want.value)


def test_pipe_lm_init_params_are_the_jax_ones():
    for cfg in (dict(), dict(d_model=64, num_heads=2, num_layers=4)):
        jparams = jpipe_lm.init_params(JConfig.tiny(**cfg), seed=5)
        got = pipe_lm.init_params(pipe_lm.TPLMConfig.tiny(**cfg), seed=5)
        want = convert.pipe_lm_params_from_jax(jparams)
        assert sorted(got) == sorted(want)
        for n in want:
            assert got[n].dtype == torch.float32
            assert torch.equal(got[n], want[n]), n
        assert got.jax_names == {n: n for n in got}


def test_pipe_lm_forward_with_flash_matches_jax():
    """One process: ``forward`` with the flash kernels' plain versions in
    ``attn_fn`` against the JAX ``pipe_lm`` forward (its plain causal
    attention) at seq 128, f32 2e-5; and without ``attn_fn``; the
    interleaved forward with the hint against the JAX one."""
    from autodist_tpu_torch.ops import flash_attention as tfa
    kw = dict(d_model=64, num_heads=2, max_seq_len=128, num_layers=4)
    jcfg, tcfg = JConfig.tiny(**kw), pipe_lm.TPLMConfig.tiny(**kw)
    jparams = jpipe_lm.init_params(jcfg, seed=1)
    params = pipe_lm.init_params(tcfg, seed=1)
    ids = np.random.RandomState(2).randint(0, 64, (2, 128)).astype(np.int32)
    want = np.asarray(jpipe_lm.forward(jparams, ids, jcfg))
    tflash = tfa.make_flash_attn_fn(causal=True)
    with torch.no_grad():
        got = pipe_lm.forward(params, torch.as_tensor(ids), tcfg,
                              attn_fn=lambda q, k, v: tflash(q, k, v))
        plain = pipe_lm.forward(params, torch.as_tensor(ids), tcfg)
        inter = pipe_lm.forward(params, torch.as_tensor(ids), tcfg,
                                virtual_stages=2, pp_shards=2)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(plain.numpy(), want, rtol=2e-5, atol=2e-5)
    jinter = np.asarray(jpipe_lm.forward(jparams, ids, jcfg,
                                         virtual_stages=2, pp_shards=2))
    np.testing.assert_allclose(inter.numpy(), jinter, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("kw,match", [
    (dict(schedule="zigzag"), "schedule must be"),
    (dict(schedule="gpipe", remat_chunks=True), "remat_chunks=True"),
    (dict(schedule="interleaved", virtual_stages=2), "requires pp_shards"),
    (dict(schedule="interleaved", pp_shards=1), "requires pp_shards")])
def test_setup_value_errors_match_jax(kw, match):
    cfg = dict(num_layers=4)
    with pytest.raises(ValueError, match=match) as want:
        jpipe_lm.make_train_setup(JConfig.tiny(**cfg), **kw)
    with pytest.raises(ValueError, match=match) as got:
        pipe_lm.make_train_setup(pipe_lm.TPLMConfig.tiny(**cfg), **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("case", ["schedule", "microbatches", "shards"])
def test_build_rejects_pp_knob_mismatches_as_jax(case):
    """The knob guard (JAX ``test_build_rejects_schedule_loss_mismatch`` and
    ``test_build_rejects_pp_knob_mismatches``), the JAX message word for
    word."""
    cfg = dict(num_layers=4)
    if case == "shards":
        setup = dict(n_microbatches=4, schedule="interleaved",
                     virtual_stages=2, pp_shards=2)
        build = dict(pp_shards=4, n_microbatches=4, schedule="interleaved",
                     virtual_stages=2)
        meta = {"pp_schedule": "interleaved", "pp_microbatches": 4,
                "pp_virtual": 2, "pp_shards": 2}
        match = "pp_shards"
    else:
        setup = dict(n_microbatches=2, schedule="gpipe")
        build = dict(pp_shards=2, n_microbatches=2, schedule="1f1b") \
            if case == "schedule" else dict(pp_shards=2, n_microbatches=4)
        meta = {"pp_schedule": "gpipe"} if case == "schedule" else \
            {"pp_schedule": "gpipe", "pp_microbatches": 2}
        match = "rebuild the model's loss" if case == "schedule" \
            else "pp_microbatches"
    jloss, jparams, jbatch, _ = jpipe_lm.make_train_setup(
        JConfig.tiny(**cfg), seq_len=16, batch_size=8, **setup)
    with pytest.raises(ValueError, match=match) as want:
        jadt.AutoDist(strategy_builder=jstrategy.PipelineParallel(
            mp_rules=jpipe_lm.pp_rules(), **build)).build(
                jloss, optax.sgd(0.05), jparams, jbatch, mp_meta=meta)
    jadt.reset()
    loss_fn, params, batch, _ = pipe_lm.make_train_setup(
        pipe_lm.TPLMConfig.tiny(**cfg), seq_len=16, batch_size=8, **setup)
    spec = ResourceSpec.from_dict(_spec(build["pp_shards"]))
    with pytest.raises(ValueError, match=match) as got:
        adt.AutoDist(strategy_builder=strategy.PipelineParallel(
            mp_rules=pipe_lm.pp_rules(), **build), resource_spec=spec,
            device="cpu").build(loss_fn, functools.partial(
                torch.optim.SGD, lr=0.05), params, batch, mp_meta=meta)
    assert str(got.value) == str(want.value)


def test_a_pp2_sharded_checkpoint_restores_everywhere(runs, ckpt_dir):
    """The pp 2 gpipe job's ShardedSaver save: each rank wrote its layer
    slice (``P|blocks/...|0:2,...`` on rank 0, ``2:4`` on rank 1; the
    replicated leaves once, on rank 0); the port restores it at pp 2
    (each rank its slice) and at pp 1 in one process, and the JAX
    package at pp 2 on its {pipe: 2, data: 4} mesh, all bit-equal to the
    gathered params."""
    from autodist_tpu.checkpoint.sharded import ShardedSaver as JSharded
    from autodist_tpu_torch.checkpoint import ShardedSaver
    ranks = runs["pp2_gpipe"]
    gathered = ranks[0]["params"]
    for r in runs["pp2_restore"]:
        assert r["restored_step"] == STEPS
        assert r["local_shapes"]["blocks/attn/wq"][0] == 2
        for n, want in gathered.items():
            np.testing.assert_array_equal(r["params"][n], want, err_msg=n)
    base = ranks[0]["saved"]
    assert base and base == ranks[1]["saved"]
    with open(base + ".shard-meta.json") as f:
        meta = json.load(f)
    assert meta["mesh"] == {"axes": ["pipe", "data"], "shape": [2, 1]}
    owners = {}
    for key, pid in meta["keys"].items():
        owners.setdefault(key.split("|")[1], set()).add(pid)
    assert owners["blocks/attn/wq"] == {0, 1}
    assert owners["embed"] == {0}
    assert meta["keys"]["P|blocks/attn/wq|0:2,0:32,0:4,0:8"] == 0
    assert meta["keys"]["P|blocks/attn/wq|2:4,0:32,0:4,0:8"] == 1
    loss_fn, params, batch, _ = pipe_lm.make_train_setup(
        pipe_lm.TPLMConfig.tiny(**_cfg_kw(2)), seq_len=16, batch_size=8,
        seed=1, n_microbatches=2)
    runner = adt.AutoDist(strategy_builder=strategy.PipelineParallel(
        pp_shards=1, n_microbatches=2, mp_rules=pipe_lm.pp_rules()),
        resource_spec=ResourceSpec.from_dict(_spec(1)), device="cpu").build(
            loss_fn, functools.partial(torch.optim.Adam, lr=LR,
                                       eps=ADAM_EPS), params, batch)
    runner.init(params)
    _, step = ShardedSaver(ckpt_dir).restore(runner)
    assert step == STEPS
    got = runner.gather_params()
    for n, want in gathered.items():
        np.testing.assert_array_equal(got[n].numpy(), want, err_msg=n)
    adt.reset()
    jloss, jparams, jbatches = _lm(2, 2, "gpipe")
    try:
        jrunner = jadt.AutoDist(strategy_builder=_jax_builder(
            2, 1, 2, "gpipe")).build(jloss, optax.adam(LR, eps=ADAM_EPS),
                                     jparams, jbatches[0])
        jrunner.init(jparams)
        _, jstep = JSharded(ckpt_dir).restore(jrunner)
        jgot = _flat(jrunner.gather_params())
    finally:
        jadt.reset()
    assert jstep == STEPS
    for n, want in gathered.items():
        np.testing.assert_array_equal(jgot[n], want, err_msg=n)


def test_adt430_sends_a_pp_job_to_the_whole_job_restart():
    """The pp plan pins the pipe axis: ADT430 as the JAX rule reports it,
    and the coordinator's shrink decision refuses the in-run shrink with
    its message (the caller then restarts the whole job)."""
    from autodist_tpu.analysis import rules as jrules
    from autodist_tpu_torch.analysis import rules
    from autodist_tpu_torch.runtime.coordinator import Coordinator
    from autodist_tpu_torch.strategy.base import Strategy
    titem, jitem = _port_item(2, 2, "gpipe"), _jax_item(2, 2, "gpipe")
    tplan = strategy.PipelineParallel(
        pp_shards=2, n_microbatches=2, mp_rules=pipe_lm.pp_rules()).build(
            titem, ResourceSpec.from_dict(_spec(2)))
    jplan = _jax_builder(2, 1, 2, "gpipe").build(
        jitem, JSpec.from_dict(_spec(2)))
    got = rules.verify_elastic(tplan, dead_worker="localhost")
    want = jrules.verify_elastic(jplan, dead_worker="localhost")
    assert [(d.code, d.message) for d in got] == \
        [(d.code, d.message) for d in want]
    assert [d.code for d in got] == ["ADT430"]
    tplan.serialize()
    fake = types.SimpleNamespace(_strategy_id=tplan.id)
    reason = Coordinator._shrink_unsound_reason(fake, "localhost")
    assert reason == got[0].message
    assert Strategy.deserialize(tplan.id).graph_config.mesh_shape == \
        {"pipe": 2, "data": 1}
