"""autodist_tpu_torch's expert parallelism against the JAX package's.

The port's ranks are spawned processes in one gloo group
(``tests/torch_dist_worker.py``'s ``ep`` job), driven through the entry
points a user calls (``AutoDist(strategy_builder=ExpertParallel(ep,
moe_lm.ep_rules())).build`` -> ``Runner.init`` -> ``Runner.run`` over
the host-global batches); a 2-rank and a 4-rank job run the cases that
keep every token, an 8-rank job the case with drops. The JAX side runs in
the pytest process on the session's 8 virtual CPU devices: the
primitives inside ``shard_map`` over as many devices as the port has
ranks; the runners build their mesh over every device, so they train at
``{data: 8 / ep, expert: ep}``. A rank's capacity counts its own tokens,
so where the device counts differ (2 and 4 ranks) the cases route with
``capacity_factor = E`` (no token is dropped) and the aux loss off (its
mean is rank-local), as JAX's ``test_ep_lm_matches_single_device`` does;
the case with drops (``capacity_factor`` 0.5, so that each rank drops at
least half its tokens in every layer, and the aux loss on) runs at 8
ranks against the JAX runner on its 8 devices, the same mesh.

Cases, f32: ``moe_ffn`` sharded at ep 2 and 4 against the dense
(unbound) result and against the JAX function inside ``shard_map``,
forward and gradients; ``top1_dispatch`` and the capacity drops;
``moe_lm.tiny`` at ep 2, ep 4, dp 2 x ep 2 and dp 2 x ep 4 (drops), three
Adam steps (eps 1e-6, ``ADAM_EPS`` of
``tests/test_torch_pipeline_parallel.py``) against the JAX runner:
losses 1e-5, params rtol 2e-5 / atol 2e-6, every rank's gathered params
equal, each rank's ``[E / ep, ...]`` slice; ``init_params`` and the
unbound forward against JAX's; the plan's JSON bytes and the builder's
``ValueError``s; the ep 2 sharded checkpoint restored at ep 1 by the
port and at ep 2 by the JAX package; ADT430.
"""
import concurrent.futures
import functools
import json
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
from autodist_tpu.models import moe_lm as jmoe
from autodist_tpu.parallel import expert as jexpert
from autodist_tpu.resource_spec import ResourceSpec as JSpec
from autodist_tpu_torch import convert, strategy
from autodist_tpu_torch.models import moe_lm
from autodist_tpu_torch.parallel import expert
from autodist_tpu_torch.resource_spec import ResourceSpec
from torch_dist_worker import launch

STEPS = 3
LR = 1e-3
ADAM_EPS = 1e-6       # see tests/test_torch_pipeline_parallel.py
EXPERT = "expert"
E = moe_lm.MoEConfig.tiny().num_experts
# (name, ranks, ep, capacity factor, aux coefficient)
TRAIN = (("ep2", 2, 2, float(E), 0.0), ("ep4", 4, 4, float(E), 0.0),
         ("dp2xep2", 4, 2, float(E), 0.0), ("dp2xep4_drops", 8, 4, 0.5,
                                            None))


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


def _moe_args(rng, d=8, f=16):
    """The JAX test's ``_moe_args``."""
    return dict(
        router_w=rng.standard_normal((d, E)).astype(np.float32) * 0.5,
        w1=rng.standard_normal((E, d, f)).astype(np.float32) * 0.3,
        b1=np.zeros((E, f), np.float32),
        w2=rng.standard_normal((E, f, d)).astype(np.float32) * 0.3,
        b2=np.zeros((E, d), np.float32))


def _moe_case(n):
    rng = np.random.RandomState(n)
    case = dict(_moe_args(rng), kind="moe", capacity_factor=float(E),
                x=rng.standard_normal((16, 8)).astype(np.float32))
    return case


def _jax_moe(n, case):
    """The JAX ``moe_ffn`` inside ``shard_map`` over ``n`` devices: the
    output, and the gradients of the local ``sum(y ** 2)`` in x, the
    router (each device's) and this device's w1 slice; and the dense
    (unbound) output."""
    spec = P(EXPERT)

    def f(x, router_w, w1, b1, w2, b2):
        def loss(x, r, w1):
            y, _ = jexpert.moe_ffn(x, r, w1, b1, w2, b2,
                                   capacity_factor=case["capacity_factor"])
            return jnp.sum(y ** 2), y
        (_, y), (gx, gr, gw1) = jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True)(x, router_w, w1)
        return y, gx, gr[None], gw1
    y, gx, gr, gw1 = jax.jit(jax.shard_map(
        f, mesh=Mesh(np.array(jax.devices()[:n]), (EXPERT,)),
        in_specs=(spec, P(), spec, spec, spec, spec),
        out_specs=(spec, spec, spec, spec), check_vma=False))(
            case["x"], case["router_w"], case["w1"], case["b1"],
            case["w2"], case["b2"])
    dense, _ = jexpert.moe_ffn(
        case["x"], case["router_w"], case["w1"], case["b1"], case["w2"],
        case["b2"], capacity_factor=case["capacity_factor"])
    return {"y": np.asarray(y), "gx": np.asarray(gx),
            "grouter": np.asarray(gr), "gw1": np.asarray(gw1),
            "dense": np.asarray(dense)}


# ---------------------------------------------------------- training


def _train_ref(ep, cf, aux):
    cfg = dict(capacity_factor=cf)
    loss_fn, params, batch, _ = jmoe.make_train_setup(
        jmoe.MoEConfig.tiny(**cfg), seq_len=16, batch_size=8, seed=2,
        aux_coef=aux)
    rng = np.random.RandomState(3)
    batches = [batch] + [{"tokens": rng.randint(
        0, 64, batch["tokens"].shape).astype(np.int32)}
        for _ in range(STEPS - 1)]
    case = {"kind": "train", "model": "moe_lm", "cfg": cfg,
            "aux_coef": aux, "init": params, "batches": batches,
            "builder": "ExpertParallel", "kw": {"ep_shards": ep},
            "lr": LR, "eps": ADAM_EPS}

    def want():
        try:
            runner = jadt.AutoDist(strategy_builder=jstrategy.ExpertParallel(
                ep_shards=ep, mp_rules=jmoe.ep_rules())).build(
                    loss_fn, optax.adam(LR, eps=ADAM_EPS), params,
                    batches[0])
            runner.init(params)
            losses = [float(runner.run(b)["loss"]) for b in batches]
            got = runner.gather_params()
            layouts = {n: lay.mp_axes for n, lay in
                       runner.distributed_step.layouts.items()
                       if lay.mp_axes}
        finally:
            jadt.reset()
        return {"losses": losses, "mp_axes": layouts,
                "params": {k: v.numpy() for k, v in
                           convert.moe_lm_params_from_jax(jax.tree_util.
                                                          tree_map(
                               np.asarray, got)).items()}}
    return case, want


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("ep_ckpt"))


@pytest.fixture(scope="module")
def both(tmp_path_factory, ckpt_dir):
    """The cases' JAX results (``refs``) and each case's ranks' results
    by key (``runs``): a 2-, a 4- and an 8-rank job, run in a thread
    while this one computes the JAX results."""
    refs, jobs = {}, {2: [], 4: [], 8: []}
    for n in (2, 4):
        case = _moe_case(n)
        refs["moe", n] = (case, functools.partial(_jax_moe, n, case))
        jobs[n].append((("moe", n), case))
    for name, world, ep, cf, aux in TRAIN:
        case, want = _train_ref(ep, cf, aux)
        if name == "ep2":
            case = dict(case, save_dir=ckpt_dir)
        refs[name] = (case, want)
        jobs[world].append(((name,), case))
    dirs = {w: tmp_path_factory.mktemp("ep%d" % w) for w in jobs}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = {w: pool.submit(launch, "ep", w, dirs[w],
                                [c for _, c in cases])
                 for w, cases in jobs.items()}
        refs = {k: (case, want()) for k, (case, want) in refs.items()}
        runs = {}
        for world, cases in jobs.items():
            got = ranks[world].result()
            for i, (key, _) in enumerate(cases):
                runs[key] = [r[i] for r in got]
    return refs, runs


@pytest.fixture(scope="module")
def refs(both):
    return both[0]


@pytest.fixture(scope="module")
def runs(both):
    return both[1]


# ----------------------------------------------------------------- tests


@pytest.mark.parametrize("n", [2, 4])
def test_moe_ffn_sharded_matches_dense_and_jax(refs, runs, n):
    """Each rank's rows of ``moe_ffn`` with its expert slice: equal to the
    dense (unbound) result and to the JAX function inside ``shard_map``,
    1e-5; the gradients of the local ``sum(y ** 2)`` in x, the router
    and the rank's w1 slice as JAX's; two all-to-alls each way."""
    case, want = refs["moe", n]
    rows = case["x"].shape[0] // n
    per = E // n
    for rank, got in enumerate(runs["moe", n]):
        sl = slice(rank * rows, (rank + 1) * rows)
        np.testing.assert_allclose(got["y"], want["dense"][sl], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got["y"], want["y"][sl], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got["gx"], want["gx"][sl], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got["grouter"], want["grouter"][rank],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            got["gw1"], want["gw1"][rank * per:(rank + 1) * per],
            rtol=1e-5, atol=1e-6)
        # [E, C, d] f32 in, each way, forward and backward
        cap = int(np.ceil(rows / E * case["capacity_factor"]))
        assert got["a2a_bytes"] == 4 * E * cap * 8 * 4


def test_top1_dispatch_and_capacity_drops_match_jax():
    """``top1_dispatch`` (dispatch, combine, aux) and ``moe_ffn`` at
    capacity 1 per expert against JAX's, one process: at most E tokens
    survive and the dropped rows are exactly zero."""
    rng = np.random.RandomState(1)
    T = 16
    p = _moe_args(rng)
    x = rng.standard_normal((T, 8)).astype(np.float32)
    probs = jax.nn.softmax(jnp.asarray(x) @ p["router_w"])
    for cap in (1, 3, 8):
        want = jexpert.top1_dispatch(probs, cap)
        got = expert.top1_dispatch(torch.as_tensor(np.array(probs)), cap)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7)
    want, waux = jexpert.moe_ffn(x, capacity_factor=E / T, **p)
    got, aux = expert.moe_ffn(torch.as_tensor(x), capacity_factor=E / T,
                              **{k: torch.as_tensor(v) for k, v in p.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-6)
    zero_rows = int(np.sum(np.all(got.numpy() == 0.0, axis=-1)))
    assert zero_rows >= T - E, zero_rows


@pytest.mark.parametrize("name", [t[0] for t in TRAIN])
def test_training_matches_the_jax_runner(refs, runs, name):
    """Three Adam steps: every rank's losses and gathered params against
    the JAX ExpertParallel runner's; every rank gathered the same; the
    JAX layouts; rank r at data r // ep, expert r % ep, holding its
    ``[E / ep, ...]`` slice of each expert stack and of its moments."""
    case, want = refs[name]
    ep = case["kw"]["ep_shards"]
    ranks = runs[name,]
    for rank, r in enumerate(ranks):
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=1e-5,
                                   atol=1e-5)
        assert sorted(r["params"]) == sorted(want["params"])
        for n, w in want["params"].items():
            np.testing.assert_allclose(r["params"][n], w, rtol=2e-5,
                                       atol=2e-6, err_msg=n)
        assert r["ranks_equal"]
        assert {n: tuple(map(tuple, a)) for n, a in r["mp_axes"].items()} \
            == want["mp_axes"]
        assert r["mesh"] == {"data": len(ranks) // ep, "expert": ep}
        assert r["coords"] == {"data": rank // ep, "expert": rank % ep}
        for n in ("layer_0/moe/w1", "layer_1/moe/b2"):
            full = case["init"][n.split("/")[0]]["moe"][n.split("/")[-1]]
            want_shape = (E // ep,) + full.shape[1:]
            assert r["local_shapes"][n] == want_shape
            assert r["opt_shapes"][n] == want_shape
        assert r["local_shapes"]["layer_0/moe/router"] == (32, E)
        # the joint batch split: rank r takes rows [r B/N, (r+1) B/N)
        tokens = case["batches"][0]["tokens"]
        rows = tokens.shape[0] // len(ranks)
        np.testing.assert_array_equal(
            r["shard"]["tokens"], tokens[rank * rows:(rank + 1) * rows])
        assert r["counters"]["ep.a2a_bytes"] > 0


def _port_item():
    from autodist_tpu_torch.model_item import ModelItem
    loss_fn, params, batch, _ = moe_lm.make_train_setup(
        moe_lm.MoEConfig.tiny(), seq_len=16, batch_size=8)
    return ModelItem(loss_fn=loss_fn, params=params,
                     example_batch=batch).prepare()


def _jax_item():
    from autodist_tpu.model_item import ModelItem as JModelItem
    loss_fn, params, batch, _ = jmoe.make_train_setup(
        jmoe.MoEConfig.tiny(), seq_len=16, batch_size=8)
    return JModelItem(loss_fn=loss_fn, params=params,
                      example_batch=batch).prepare()


@pytest.mark.parametrize("ep,world", [(2, 4), (4, 8)])
def test_plan_bytes_and_layouts_match_jax(ep, world):
    """The ExpertParallel plan over the same variable list and spec is
    the JAX builder's, byte for byte (mesh, batch_axes, mp_axes); the
    partitioner gives the JAX layouts."""
    from autodist_tpu.kernel.partitioner import VariablePartitioner as JVP
    from autodist_tpu_torch.kernel.partitioner import VariablePartitioner
    titem, jitem = _port_item(), _jax_item()
    jplan = jstrategy.ExpertParallel(ep, jmoe.ep_rules()).build(
        jitem, JSpec.from_dict(_spec(world)))
    tplan = strategy.ExpertParallel(ep, moe_lm.ep_rules()).build(
        titem, ResourceSpec.from_dict(_spec(world)))
    tplan.id = jplan.id
    dump = lambda p: json.dumps(p.to_dict(), sort_keys=True)  # noqa: E731
    assert dump(tplan) == dump(jplan)
    assert tplan.graph_config.batch_axes == ["data", EXPERT]
    sizes = dict(tplan.graph_config.mesh_shape)
    got = VariablePartitioner.apply(tplan, titem.var_infos, world, sizes)
    want = JVP.apply(jplan, jitem.var_infos, sizes["data"],
                     mesh_axis_sizes=sizes)
    assert {n: lay.mp_axes for n, lay in got.items()} == \
        {n: lay.mp_axes for n, lay in want.items()}
    assert got["layer_0/moe/w1"].mp_axes == ((0, EXPERT),)
    assert got["layer_0/moe/router"].mp_axes == ()


@pytest.mark.parametrize("kw,world", [
    (dict(ep_shards=0), 4), (dict(ep_shards=3), 4)], ids=["ep0", "ep3_of_4"])
def test_builder_value_errors_match_jax(kw, world):
    with pytest.raises(ValueError) as want:
        jstrategy.ExpertParallel(mp_rules=jmoe.ep_rules(), **kw).build(
            _jax_item(), JSpec.from_dict(_spec(world)))
    with pytest.raises(ValueError) as got:
        strategy.ExpertParallel(mp_rules=moe_lm.ep_rules(), **kw).build(
            _port_item(), ResourceSpec.from_dict(_spec(world)))
    assert str(got.value) == str(want.value)


def test_moe_lm_init_params_and_forward_are_the_jax_ones():
    """``init_params`` bit for bit; the unbound forward (logits and aux)
    and the loss's gradients against JAX's, 1e-5."""
    jcfg = jmoe.MoEConfig.tiny(capacity_factor=0.5)
    tcfg = moe_lm.MoEConfig.tiny(capacity_factor=0.5)
    jparams = jmoe.init_params(jcfg, seed=5)
    got = moe_lm.init_params(tcfg, seed=5)
    want = convert.moe_lm_params_from_jax(jparams)
    assert sorted(got) == sorted(want)
    for n in want:
        assert torch.equal(got[n], want[n]), n
    assert got.jax_names == {n: n for n in got}
    ids = np.random.RandomState(6).randint(0, 64, (4, 17)).astype(np.int32)
    jlogits, jaux = jmoe.forward(jparams, ids[:, :-1], jcfg)
    with torch.no_grad():
        logits, aux = moe_lm.forward(got, torch.as_tensor(ids[:, :-1]), tcfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    jloss = jmoe.make_train_setup(jcfg, seed=5)[0]
    tloss = moe_lm.make_train_setup(tcfg, seed=5)[0]
    jl, jg = jax.jit(jax.value_and_grad(jloss))(jparams, {"tokens": ids})
    leaves = {n: t.clone().requires_grad_() for n, t in got.items()}
    tl = tloss(leaves, {"tokens": ids})
    tg = dict(zip(leaves, torch.autograd.grad(tl, list(leaves.values()))))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    jg = convert.moe_lm_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                               jg))
    for n in jg:
        np.testing.assert_allclose(tg[n].numpy(), jg[n].numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=n)


def test_an_ep2_sharded_checkpoint_restores_everywhere(runs, ckpt_dir):
    """The ep 2 job's ShardedSaver save: each rank wrote its expert slice
    (``P|layer_0/moe/w1|0:2,...`` on rank 0, ``2:4`` on rank 1; the
    replicated leaves once, on rank 0); the port restores it at ep 1 in
    one process and the JAX package at ep 2 on its {data: 4, expert: 2}
    mesh, both bit-equal to the gathered params."""
    from autodist_tpu.checkpoint.sharded import ShardedSaver as JSharded
    from autodist_tpu_torch.checkpoint import ShardedSaver
    ranks = runs["ep2",]
    gathered = ranks[0]["params"]
    base = ranks[0]["saved"]
    assert base and base == ranks[1]["saved"]
    with open(base + ".shard-meta.json") as f:
        meta = json.load(f)
    assert meta["mesh"] == {"axes": ["data", EXPERT], "shape": [1, 2]}
    assert meta["keys"]["P|layer_0/moe/w1|0:2,0:32,0:64"] == 0
    assert meta["keys"]["P|layer_0/moe/w1|2:4,0:32,0:64"] == 1
    owners = {}
    for key, pid in meta["keys"].items():
        owners.setdefault(key.split("|")[1], set()).add(pid)
    assert owners["embed"] == {0}
    loss_fn, params, batch, _ = moe_lm.make_train_setup(
        moe_lm.MoEConfig.tiny(capacity_factor=float(E)), seq_len=16,
        batch_size=8, seed=2, aux_coef=0.0)
    runner = adt.AutoDist(strategy_builder=strategy.ExpertParallel(
        ep_shards=1, mp_rules=moe_lm.ep_rules()),
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
    jloss, jparams, jbatch, _ = jmoe.make_train_setup(
        jmoe.MoEConfig.tiny(capacity_factor=float(E)), seq_len=16,
        batch_size=8, seed=2, aux_coef=0.0)
    try:
        jrunner = jadt.AutoDist(strategy_builder=jstrategy.ExpertParallel(
            ep_shards=2, mp_rules=jmoe.ep_rules())).build(
                jloss, optax.adam(LR, eps=ADAM_EPS), jparams, jbatch)
        jrunner.init(jparams)
        _, jstep = JSharded(ckpt_dir).restore(jrunner)
        jgot = convert.moe_lm_params_from_jax(jax.tree_util.tree_map(
            np.asarray, jrunner.gather_params()))
    finally:
        jadt.reset()
    assert jstep == STEPS
    for n, want in gathered.items():
        np.testing.assert_array_equal(jgot[n].numpy(), want, err_msg=n)


def test_adt430_sends_an_ep_job_to_the_whole_job_restart():
    """The ep plan pins the expert axis: ADT430 as the JAX rule reports
    it, and the coordinator's shrink decision refuses the in-run shrink
    with its message."""
    from autodist_tpu.analysis import rules as jrules
    from autodist_tpu_torch.analysis import rules
    from autodist_tpu_torch.runtime.coordinator import Coordinator
    tplan = strategy.ExpertParallel(2, moe_lm.ep_rules()).build(
        _port_item(), ResourceSpec.from_dict(_spec(2)))
    jplan = jstrategy.ExpertParallel(2, jmoe.ep_rules()).build(
        _jax_item(), JSpec.from_dict(_spec(2)))
    got = rules.verify_elastic(tplan, dead_worker="localhost")
    want = jrules.verify_elastic(jplan, dead_worker="localhost")
    assert [(d.code, d.message) for d in got] == \
        [(d.code, d.message) for d in want]
    assert [d.code for d in got] == ["ADT430"]
    tplan.serialize()
    fake = types.SimpleNamespace(_strategy_id=tplan.id)
    assert Coordinator._shrink_unsound_reason(fake, "localhost") == \
        got[0].message
