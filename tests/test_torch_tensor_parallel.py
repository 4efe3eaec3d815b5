"""autodist_tpu_torch's tensor parallelism against the JAX package's.

The port's ranks are spawned processes in one gloo group
(``tests/torch_dist_worker.py``'s ``tp`` job), driven through the entry
points a user calls (``AutoDist(strategy_builder=TensorParallel(tp,
rules)).build`` -> ``Runner.init`` -> ``Runner.run`` over the host-global
batches); one 2-rank and one 4-rank job run every multi-process case.
The JAX side runs in the pytest process on the session's 8 virtual CPU
devices. Its runner builds a TensorParallel mesh over every device of
the session (``parallel/mesh.py::mesh_from_strategy``), so it trains at
``{data: 8 / tp, model: tp}`` on the same global batches: the same mean
gradient as the port's ``{data: N / tp, model: tp}``, summed in another
order.

Cases: the vocab-parallel embedding, logits and cross-entropy (with
out-of-range ids and targets) at tp 2 and 4 against the JAX ops inside
``shard_map``, f32 1e-5/1e-6, the cross-entropy's gradient in the JAX
raw-primitive convention (the psum transpose inflates it by tp on both
sides); the MLP of ``tests/test_tensor_parallel.py`` (Adam 1e-2) and
``tp_lm.tiny()`` (seq 16, global batch 8, Adam 1e-3), three steps each at
tp 2, tp 4 and dp 2 x tp 2: losses 1e-5, params rtol 2e-5 / atol 2e-6
(observed ~2e-7); the frozen embedding (JAX
``test_tp_frozen_embed_matches_single_device``); the plan's JSON bytes and
layouts; ``tp_lm``'s init and its forward with the flash kernels' plain
versions in the attention slot against the JAX forward with the Pallas
kernels (interpret mode); a checkpoint saved at tp 2 restored by the port
at tp 1 and by the JAX package under ``AllReduce()``, bit-equal to the
gathered params; and the refusal of an unknown mesh axis, by its ROADMAP
item.
"""
import json

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
from autodist_tpu.models import tp_lm as jtp_lm
from autodist_tpu.parallel import tensor as jtensor
from autodist_tpu.resource_spec import ResourceSpec as JSpec
from autodist_tpu_torch import const, convert, strategy
from autodist_tpu_torch.models import tp_lm
from autodist_tpu_torch.parallel import mesh as tmesh
from autodist_tpu_torch.resource_spec import ResourceSpec
from torch_dist_worker import MLP_RULES, launch

STEPS = 3
LM_LR, MLP_LR = 1e-3, 1e-2
V, D, B, S = 16, 8, 2, 6


def _spec(n):
    return {"nodes": [{"address": "127.0.0.1", "chief": True,
                       "cpus": list(range(n))}]}


@pytest.fixture(autouse=True)
def _reset_port():
    yield
    adt.reset()


# ------------------------------------------------------------ references


def _ops_inputs():
    rng = np.random.RandomState(2)
    table = rng.standard_normal((V, D)).astype(np.float32)
    ids = rng.randint(0, V, (B, S)).astype(np.int32)
    ids[0, 2], ids[1, 4] = V + 3, -1            # owned by no rank
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    targets = rng.randint(0, V, (B, S)).astype(np.int32)
    targets[0, 1], targets[1, 0] = -1, V + 2     # clamped
    return {"table": table, "ids": ids, "x": x, "targets": targets}


def _jax_ops(tp, inp):
    mesh = Mesh(np.array(jax.devices()[:tp]), (const.MODEL_AXIS,))

    def f(tb, ids, x, t):
        emb = jtensor.vocab_parallel_embed(tb, ids)
        return emb, jtensor.vocab_parallel_xent(
            jtensor.vocab_parallel_logits(x, tb), t)
    emb, nll = jax.jit(jax.shard_map(
        f, mesh=mesh, in_specs=(P(const.MODEL_AXIS), P(), P(), P()),
        out_specs=(P(), P()), check_vma=False))(
            inp["table"], inp["ids"], inp["x"], inp["targets"])
    logits = inp["x"] @ inp["table"].T
    grad = jax.jit(jax.shard_map(
        jax.grad(lambda lg, t: jnp.sum(jtensor.vocab_parallel_xent(lg, t))),
        mesh=mesh, in_specs=(P(None, None, const.MODEL_AXIS), P()),
        out_specs=P(None, None, const.MODEL_AXIS), check_vma=False))(
            logits, inp["targets"])
    return np.asarray(emb), np.asarray(nll), np.asarray(grad)


def _mlp_setup():
    rng = np.random.RandomState(0)
    params = {"fc1": {"w": rng.standard_normal((8, 16)).astype(
                  np.float32) * 0.3, "b": np.zeros((16,), np.float32)},
              "fc2": {"w": rng.standard_normal((16, 4)).astype(
                  np.float32) * 0.3, "b": np.zeros((4,), np.float32)}}
    batches = [{"x": rng.standard_normal((8, 8)).astype(np.float32),
                "y": rng.standard_normal((8, 4)).astype(np.float32)}
               for _ in range(STEPS)]
    return params, batches


def _jax_mlp_loss(p, batch):
    h = jax.nn.relu(jtensor.column_parallel_dense(
        batch["x"], p["fc1"]["w"], p["fc1"]["b"]))
    y = jtensor.row_parallel_dense(h, p["fc2"]["w"], p["fc2"]["b"])
    return jnp.mean((y - batch["y"]) ** 2)


def _lm_setup(seed=3):
    loss_fn, params, batch, _ = jtp_lm.make_train_setup(
        jtp_lm.TPLMConfig.tiny(), seq_len=16, batch_size=8, seed=seed)
    rng = np.random.RandomState(4)
    batches = [batch] + [{"tokens": rng.randint(
        0, 64, batch["tokens"].shape).astype(np.int32)}
        for _ in range(STEPS - 1)]
    return loss_fn, params, batches


def _flat(tree):
    return {n: t.numpy() for n, t in convert.tp_lm_params_from_jax(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


def _jax_tp_run(tp, loss_fn, params, batches, lr, rules, freeze=None):
    """The JAX TensorParallel runner on the session's 8 devices: losses,
    gathered params (flat numpy) and each variable's mp layout."""
    try:
        ad = jadt.AutoDist(strategy_builder=jstrategy.TensorParallel(
            tp, rules))
        runner = ad.build(loss_fn, optax.adam(lr), params, batches[0],
                          trainable_filter=(lambda n: n != freeze)
                          if freeze else None)
        runner.init(params)
        losses = [float(runner.run(b)["loss"]) for b in batches]
        layouts = {n: lay.mp_axes for n, lay in
                   runner.distributed_step.layouts.items() if lay.mp_axes}
        return {"losses": losses, "params": _flat(runner.gather_params()),
                "mp_axes": layouts}
    finally:
        jadt.reset()


# ------------------------------------------------------------- the jobs


@pytest.fixture(scope="module")
def refs():
    mlp_params, mlp_batches = _mlp_setup()
    lm_loss, lm_params, lm_batches = _lm_setup()
    out = {"ops": _ops_inputs(), "mlp_init": _flat(mlp_params),
           "mlp_batches": mlp_batches, "lm_init": _flat(lm_params),
           "lm_batches": lm_batches, "lm_jparams": lm_params,
           "lm_loss": lm_loss}
    for tp in (2, 4):
        out["mlp", tp] = _jax_tp_run(tp, _jax_mlp_loss, mlp_params,
                                     mlp_batches, MLP_LR, MLP_RULES)
        out["lm", tp] = _jax_tp_run(tp, lm_loss, lm_params, lm_batches,
                                    LM_LR, jtp_lm.tp_rules())
    out["frozen"] = _jax_tp_run(2, lm_loss, lm_params, lm_batches, LM_LR,
                                jtp_lm.tp_rules(), freeze="embed")
    return out


def _train_case(refs, model, tp, **kw):
    case = {"kind": "train", "model": model, "tp": tp, "cfg": {},
            "init": refs[model + "_init"], "batches": refs[model + "_batches"],
            "lr": MLP_LR if model == "mlp" else LM_LR}
    case.update(kw)
    return case


# (name, world, case keywords, the JAX reference's key)
TWO = [("ops2", {"kind": "ops"}, None),
       ("mlp_tp2", ("mlp", 2), ("mlp", 2)),
       ("lm_tp2", ("lm", 2), ("lm", 2))]
FOUR = [("ops4", {"kind": "ops"}, None),
        ("mlp_tp4", ("mlp", 4), ("mlp", 4)),
        ("mlp_dp2xtp2", ("mlp", 2), ("mlp", 2)),
        ("lm_tp4", ("lm", 4), ("lm", 4)),
        ("lm_dp2xtp2", ("lm", 2), ("lm", 2)),
        ("frozen_dp2xtp2", ("lm", 2), "frozen")]


def _payload(refs, cases, save_dir=None):
    out = []
    for name, case, _ in cases:
        if isinstance(case, dict):
            out.append(dict(case, **refs["ops"]))
            continue
        extra = {}
        if name.startswith("frozen"):
            extra["freeze"] = "embed"
        if name == "lm_tp2" and save_dir is not None:
            extra["save_dir"] = save_dir
        out.append(_train_case(refs, *case, **extra))
    return out


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("tp_ckpt"))


@pytest.fixture(scope="module")
def runs(refs, tmp_path_factory, ckpt_dir):
    """Each case's ranks' results, by case name: one 2-rank and one
    4-rank job."""
    out = {}
    for world, cases in ((2, TWO), (4, FOUR)):
        ranks = launch("tp", world, tmp_path_factory.mktemp("tp%d" % world),
                       _payload(refs, cases, ckpt_dir))
        for i, (name, _, ref) in enumerate(cases):
            out[name] = ([r[i] for r in ranks], ref)
    return out


# ----------------------------------------------------------------- tests


@pytest.mark.parametrize("case", ["ops2", "ops4"])
def test_vocab_parallel_ops_match_jax(refs, runs, case):
    """Embed (NaN rows for ids no rank owns), the xent (clamped targets)
    and its gradient on each rank's logits, against the JAX ops inside
    shard_map at the same tp."""
    ranks, _ = runs[case]
    tp = len(ranks)
    emb, nll, grad = _jax_ops(tp, refs["ops"])
    assert np.isnan(emb[0, 2]).all() and np.isnan(emb[1, 4]).all()
    for r in ranks:
        np.testing.assert_allclose(r["emb"], emb, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["nll"], nll, rtol=1e-5, atol=1e-6)
    got = np.concatenate([r["grad"] for r in ranks], axis=-1)
    np.testing.assert_allclose(got, grad, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", ["mlp_tp2", "mlp_tp4", "mlp_dp2xtp2",
                                  "lm_tp2", "lm_tp4", "lm_dp2xtp2",
                                  "frozen_dp2xtp2"])
def test_training_matches_the_jax_runner(refs, runs, case):
    """Three steps: every rank's losses and gathered params against the
    JAX TensorParallel runner's; the same mp layouts."""
    ranks, key = runs[case]
    ref = refs[key]
    for r in ranks:
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=1e-5,
                                   atol=1e-5)
        assert sorted(r["params"]) == sorted(ref["params"])
        for n, want in ref["params"].items():
            np.testing.assert_allclose(r["params"][n], want, rtol=2e-5,
                                       atol=2e-6, err_msg=n)
        assert {n: tuple(map(tuple, a)) for n, a in r["mp_axes"].items()} \
            == ref["mp_axes"]
    if case.startswith("frozen"):
        for r in ranks:
            np.testing.assert_array_equal(r["params"]["embed"],
                                          refs["lm_init"]["embed"])


@pytest.mark.parametrize("case", ["lm_tp2", "lm_tp4", "lm_dp2xtp2"])
def test_each_rank_holds_its_slice(refs, runs, case):
    """Rank r sits at data index r // tp and model index r % tp; it stores
    its 1/tp slice of each model-parallel variable (and of its Adam
    moments), the rest whole; the ranks of a model line train on the same
    rows; the forward runs 2 all-reduces a layer, the embedding's 2 and
    the xent's 3 a step."""
    ranks, _ = runs[case]
    world = len(ranks)
    tp = 4 if case == "lm_tp4" else 2
    full = {n: v.shape for n, v in refs["lm_init"].items()}
    for rank, r in enumerate(ranks):
        assert r["coords"] == {"data": rank // tp, "model": rank % tp}
        assert r["metadata"]["mesh"] == {"data": world // tp, "model": tp}
        for n, shape in full.items():
            want = list(shape)
            for dim, _ in r["mp_axes"].get(n, ()):
                want[dim] //= tp
            assert r["local_shapes"][n] == tuple(want), n
            assert r["opt_shapes"][n] == tuple(want), n
        mp = sum(np.prod(r["local_shapes"][n]) for n in r["mp_axes"])
        whole = sum(np.prod(s) for n, s in full.items()
                    if n not in r["mp_axes"])
        assert r["stats"]["param_bytes"] == 4 * (mp + whole)
        tel = r["stats"]["telemetry"]
        assert tel["tp_fwd_allreduces"] == STEPS * (2 * 2 + 2 + 3)


def _port_item(model, refs):
    from autodist_tpu_torch.model_item import ModelItem
    from torch_dist_worker import mlp_loss
    if model == "mlp":
        params = convert.jax_named({n: torch.as_tensor(v) for n, v in
                                    refs["mlp_init"].items()})
        return ModelItem(loss_fn=mlp_loss, params=params,
                         example_batch=refs["mlp_batches"][0]).prepare()
    loss_fn, params, batch, _ = tp_lm.make_train_setup(
        tp_lm.TPLMConfig.tiny(), seq_len=16, batch_size=8, seed=3)
    return ModelItem(loss_fn=loss_fn, params=params,
                     example_batch=batch).prepare()


def _jax_item(model, refs):
    from autodist_tpu.model_item import ModelItem as JModelItem
    if model == "mlp":
        params, batches = _mlp_setup()
        return JModelItem(loss_fn=_jax_mlp_loss, params=params,
                          example_batch=batches[0]).prepare()
    return JModelItem(loss_fn=refs["lm_loss"], params=refs["lm_jparams"],
                      example_batch=refs["lm_batches"][0]).prepare()


@pytest.mark.parametrize("tp,world", [(2, 2), (2, 4), (4, 4)])
@pytest.mark.parametrize("model", ["mlp", "lm"])
def test_plan_bytes_and_layouts_match_jax(refs, model, tp, world):
    """The TensorParallel plan over the same variable list and spec is the
    JAX builder's, byte for byte; the partitioner gives the JAX layouts
    (``fc2/b`` and the LayerNorms replicated)."""
    from autodist_tpu.kernel.partitioner import VariablePartitioner as JVP
    from autodist_tpu_torch.kernel.partitioner import VariablePartitioner
    titem, jitem = _port_item(model, refs), _jax_item(model, refs)
    rules = MLP_RULES if model == "mlp" else jtp_lm.tp_rules()
    jplan = jstrategy.TensorParallel(tp, rules).build(
        jitem, JSpec.from_dict(_spec(world)))
    tplan = strategy.TensorParallel(tp, rules).build(
        titem, ResourceSpec.from_dict(_spec(world)))
    tplan.id = jplan.id
    dump = lambda p: json.dumps(p.to_dict(), sort_keys=True)  # noqa: E731
    assert dump(tplan) == dump(jplan)
    sizes = dict(tplan.graph_config.mesh_shape)
    got = VariablePartitioner.apply(tplan, titem.var_infos, world, sizes)
    want = JVP.apply(jplan, jitem.var_infos, world // tp,
                     mesh_axis_sizes=sizes)
    assert {n: lay.mp_axes for n, lay in got.items()} == \
        {n: lay.mp_axes for n, lay in want.items()}
    if model == "mlp":
        assert got["fc2/b"].mp_axes == ()
        assert got["fc1/w"].mp_axes == ((1, "model"),)


def test_tp_lm_init_params_are_the_jax_ones():
    for cfg in (dict(), dict(d_model=64, num_heads=2, num_layers=3)):
        jparams = jtp_lm.init_params(jtp_lm.TPLMConfig.tiny(**cfg), seed=5)
        got = tp_lm.init_params(tp_lm.TPLMConfig.tiny(**cfg), seed=5)
        want = convert.tp_lm_params_from_jax(jparams)
        assert sorted(got) == sorted(want)
        for n in want:
            assert got[n].dtype == torch.float32
            assert torch.equal(got[n], want[n]), n
        assert got.jax_names == {n: n for n in got}


def test_tp_lm_forward_with_flash_matches_jax():
    """One process: ``forward`` with the flash kernels' plain versions in
    ``attn_fn`` against the JAX forward with its Pallas flash (interpret
    mode) at seq 128, f32 2e-5; and against the plain causal
    attention."""
    from autodist_tpu.ops import flash_attention as jfa
    from autodist_tpu_torch.ops import flash_attention as tfa
    kw = dict(d_model=64, num_heads=2, max_seq_len=128)
    jcfg, tcfg = jtp_lm.TPLMConfig.tiny(**kw), tp_lm.TPLMConfig.tiny(**kw)
    jparams = jtp_lm.init_params(jcfg, seed=1)
    params = tp_lm.init_params(tcfg, seed=1)
    ids = np.random.RandomState(2).randint(0, 64, (2, 128)).astype(np.int32)
    jflash = jfa.make_flash_attn_fn(causal=True)
    want = np.asarray(jtp_lm.forward(
        jparams, ids, jcfg, attn_fn=lambda q, k, v: jflash(q, k, v)))
    tflash = tfa.make_flash_attn_fn(causal=True)
    with torch.no_grad():
        got = tp_lm.forward(params, torch.as_tensor(ids), tcfg,
                            attn_fn=lambda q, k, v: tflash(q, k, v))
        plain = tp_lm.forward(params, torch.as_tensor(ids), tcfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(plain.numpy(), want, rtol=2e-5, atol=2e-5)


def test_a_tp2_checkpoint_restores_at_tp1_and_in_jax(refs, runs, ckpt_dir):
    """The tp 2 job saved after its steps (rank 0 writes, the
    model-parallel variables gathered whole in the JAX layout): the port
    restores it at tp 1 in one process, and the JAX package under
    ``AllReduce()`` on one device, both bit-equal to the gathered params
    and moments."""
    from autodist_tpu.checkpoint.saver import Saver as JSaver
    from autodist_tpu_torch.checkpoint import Saver
    ranks, _ = runs["lm_tp2"]
    assert ranks[0]["saved"] and ranks[1]["saved"] is None
    gathered = ranks[0]["params"]
    loss_fn, params, batch, _ = tp_lm.make_train_setup(
        tp_lm.TPLMConfig.tiny(), seq_len=16, batch_size=8, seed=3)
    ad = adt.AutoDist(strategy_builder=strategy.TensorParallel(
        1, tp_lm.tp_rules()), resource_spec=ResourceSpec.from_dict(
            _spec(1)), device="cpu")
    runner = ad.build(loss_fn, torch.optim.Adam, params, batch)
    runner.init(params)
    _, step = Saver(ckpt_dir).restore(runner)
    assert step == STEPS
    got = runner.gather_params()
    for n, want in gathered.items():
        assert np.array_equal(got[n].numpy(), want), n
    adt.reset()
    jloss = refs["lm_loss"]
    jparams = refs["lm_jparams"]
    try:
        jad = jadt.AutoDist(strategy_builder=jstrategy.AllReduce(),
                            resource_spec=JSpec.from_dict(_spec(1)))
        jrunner = jad.build(jloss, optax.adam(LM_LR), jparams,
                            refs["lm_batches"][0])
        jrunner.init(jparams)
        _, jstep = JSaver(directory=ckpt_dir).restore(jrunner)
        jgot = _flat(jrunner.gather_params())
    finally:
        jadt.reset()
    assert jstep == STEPS
    for n, want in gathered.items():
        assert np.array_equal(jgot[n], want), n


def test_process_mesh_is_the_jax_device_grid():
    """Rank r of a {data, model} mesh, and of a PipelineParallel {pipe,
    data[, model]} mesh, sits where the JAX package's build_mesh puts
    device r (row-major, major to minor); the lines of each axis are the
    JAX mesh's rows and columns."""
    from autodist_tpu.parallel import mesh as jmesh
    for axes in ({"data": 2, "model": 2}, {"data": 4, "model": 2},
                 {"data": 1, "model": 4}, {"data": 8},
                 {"pipe": 2, "data": 4}, {"pipe": 4, "data": 2},
                 {"pipe": 2, "data": 2, "model": 2},
                 {"pipe": 2, "data": 1, "model": 2}):
        devs = jmesh.ordered_devices(int(np.prod(list(axes.values()))))
        jm = jmesh.build_mesh(axes=dict(axes), devices=devs)
        ids = np.vectorize(lambda d: devs.index(d))(jm.devices)
        for rank in range(ids.size):
            m = tmesh.ProcessMesh(axes, rank)
            where = dict(zip(axes, np.argwhere(ids == rank)[0].tolist()))
            assert m.coords == where
            for axis in axes:
                i = list(axes).index(axis)
                line = np.moveaxis(ids, i, -1).reshape(-1, axes[axis])
                assert [list(map(int, ln)) for ln in line] == m.lines(axis)


def test_replica_info_splits_the_batch_over_the_data_axis():
    from autodist_tpu_torch.kernel.replicator import ReplicaInfo
    for rank in range(4):
        info = ReplicaInfo(4, rank, mesh=tmesh.ProcessMesh(
            {"data": 2, "model": 2}, rank))
        assert (info.num_processes, info.process_rank) == (4, rank)
        assert (info.num_replicas, info.rank) == (2, rank // 2)
        assert info.local_rows(8) == slice(4 * (rank // 2),
                                           4 * (rank // 2) + 4)
        assert info.local_shape((8, 17)) == (4, 17)
    with pytest.raises(ValueError, match="does not cover"):
        ReplicaInfo(4, 1, mesh=tmesh.ProcessMesh({"data": 2, "model": 1}, 1))
    assert not tmesh.axis_bound(const.MODEL_AXIS)
    with tmesh.bind(tmesh.ProcessMesh({"data": 2, "model": 1}, 0)):
        assert not tmesh.axis_bound(const.MODEL_AXIS)    # size 1: unbound


@pytest.mark.parametrize("mp_axes,shape,code", [
    ({1: "model"}, (8, 6), None), ({0: "model"}, (8, 6), None),
    ({1: "model"}, (8, 5), "ADT206"), ({2: "model"}, (8, 6), "ADT206"),
    ({0: "seq"}, (8, 6), "ADT205"),
    ({0: "model", 1: "model"}, (8, 6), "ADT207")])
def test_mp_axes_rule_matches_jax(mp_axes, shape, code):
    """ADT205/206/207 as the JAX rule reports them; the partitioner raises
    the first error."""
    from autodist_tpu.analysis.rules import check_mp_axes_node as jcheck
    from autodist_tpu_torch.analysis.diagnostics import DiagnosticError
    from autodist_tpu_torch.analysis.rules import check_mp_axes_node
    from autodist_tpu_torch.kernel.partitioner import VariablePartitioner
    from autodist_tpu_torch.model_item import VarInfo
    from autodist_tpu_torch.strategy.base import Strategy, VarConfig
    sizes = {"data": 1, "model": 2}
    got = check_mp_axes_node("w", mp_axes, shape, sizes)
    want = jcheck("w", mp_axes, shape, sizes)
    assert [(d.code, d.message) for d in got] == \
        [(d.code, d.message) for d in want]
    plan = Strategy(node_config=[VarConfig(var_name="w", mp_axes=mp_axes)])
    infos = {"w": VarInfo("w", shape, "float32")}
    if code is None:
        lay = VariablePartitioner.apply(plan, infos, 2, sizes)["w"]
        assert lay.mp_axes == tuple(sorted(mp_axes.items()))
    else:
        with pytest.raises(DiagnosticError, match=code):
            VariablePartitioner.apply(plan, infos, 2, sizes)


def _plan(nodes, mesh=None, **gc):
    from autodist_tpu_torch.strategy.base import (AllReduceSynchronizer,
                                                  GraphConfig, Strategy,
                                                  VarConfig)
    out = []
    for name, kw in nodes:
        kw = dict(kw)
        kw.setdefault("synchronizer", AllReduceSynchronizer())
        out.append(VarConfig(var_name=name, **kw))
    return Strategy(node_config=out, graph_config=GraphConfig(
        replicas=["127.0.0.1:CPU:%d" % i for i in range(4)],
        mesh_shape=mesh, **gc))


def _refusal(case):
    return {
        "unknown_axis": _plan([("w", {"mp_axes": {1: "model"}})],
                              {"data": 2, "replica": 2}),
    }[case]


@pytest.mark.parametrize("case", ["unknown_axis"])
def test_unported_mesh_features_raise_naming_item_9(case):
    """A mesh axis other than data, model, pipe, seq and expert raises at 4
    processes, naming ROADMAP A item 9; nothing is ignored. (A model,
    pipe, seq or expert axis beside host PS, ZeRO or partitioned storage
    trains: ``tests/test_torch_mesh_storage.py``.)"""
    from autodist_tpu_torch.kernel.graph_transformer import GraphTransformer
    from autodist_tpu_torch.kernel.replicator import ReplicaInfo
    from autodist_tpu_torch.model_item import ModelItem
    params = {"w": torch.zeros(4, 4), "b": torch.zeros(4)}
    item = ModelItem(loss_fn=lambda p, b: (p["w"].sum() + p["b"].sum()),
                     params=params).prepare()
    with pytest.raises(NotImplementedError, match="ROADMAP A item 9"):
        GraphTransformer(_refusal(case), item, "cpu",
                         ReplicaInfo(4, 0)).transform()


def test_sequence_parallel_entry_points_raise_naming_item_9():
    """The sequence-parallel entry points that raised before they were
    ported now build and match JAX: ``TensorParallel(seq_shards=2)``'s
    plan, byte for byte (mesh ``{data, seq, model}``); ``make_train_setup(
    attention="ring" | "ulysses")``'s params and ``[B, S]`` tokens; the
    unbound loss (JAX's on a one-device seq mesh) and
    ``forward(seq_parallel=True)``, 1e-5. (The
    multi-process runs: ``tests/test_torch_sequence_parallel.py``.)"""
    from autodist_tpu.model_item import ModelItem as JModelItem
    from autodist_tpu_torch.model_item import ModelItem
    cfg, jcfg = tp_lm.TPLMConfig.tiny(), jtp_lm.TPLMConfig.tiny()
    for attention in ("ring", "ulysses"):
        jloss, jparams, jbatch, _ = jtp_lm.make_train_setup(
            jcfg, seq_len=16, batch_size=8, attention=attention)
        loss, params, batch, _ = tp_lm.make_train_setup(
            cfg, seq_len=16, batch_size=8, attention=attention)
        np.testing.assert_array_equal(batch["tokens"], jbatch["tokens"])
        assert batch["tokens"].shape == (8, 16)
        want = convert.tp_lm_params_from_jax(jparams)
        assert all(torch.equal(params[n], want[n]) for n in want)
        with torch.no_grad():
            got = float(loss(params, batch))
        # the JAX loss needs its seq axis bound: a one-device seq mesh
        one = jax.jit(jax.shard_map(
            jloss, mesh=Mesh(np.array(jax.devices()[:1]), ("seq",)),
            in_specs=(P(), P()), out_specs=P(), check_vma=False))
        np.testing.assert_allclose(got, float(one(jparams, jbatch)),
                                   rtol=1e-5)
    jplan = jstrategy.TensorParallel(
        2, jtp_lm.tp_rules(), seq_shards=2).build(
            JModelItem(loss_fn=jloss, params=jparams,
                       example_batch=jbatch).prepare(),
            JSpec.from_dict(_spec(4)))
    tplan = strategy.TensorParallel(2, tp_lm.tp_rules(), seq_shards=2).build(
        ModelItem(loss_fn=loss, params=params,
                  example_batch=batch).prepare(),
        ResourceSpec.from_dict(_spec(4)))
    tplan.id = jplan.id
    assert json.dumps(tplan.to_dict(), sort_keys=True) == \
        json.dumps(jplan.to_dict(), sort_keys=True)
    assert tplan.graph_config.mesh_shape == {"data": 1, "seq": 2,
                                             "model": 2}
    ids = batch["tokens"][:2]
    with torch.no_grad():
        got = tp_lm.forward(params, torch.as_tensor(ids), cfg,
                            seq_parallel=True)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jtp_lm.forward(jparams, ids, jcfg,
                                               seq_parallel=True)),
        rtol=1e-5, atol=1e-5)


def test_mp_axes_on_a_port_layout_that_is_not_the_jax_one_raise():
    """mp_axes index the JAX layout: a Dense ``weight [out, in]`` the port
    holds transposed cannot be sharded as it is."""
    from autodist_tpu_torch.kernel.partitioner import VariablePartitioner
    from autodist_tpu_torch.model_item import ModelItem
    item = ModelItem(loss_fn=lambda p, b: p["fc.weight"].sum(),
                     params={"fc.weight": torch.zeros(4, 6)}).prepare()
    plan = _plan([("fc.weight", {"mp_axes": {1: "model"}})],
                 {"data": 2, "model": 2})
    with pytest.raises(ValueError, match="JAX layout"):
        VariablePartitioner.apply(plan, item.var_infos, 4,
                                  {"data": 2, "model": 2})
