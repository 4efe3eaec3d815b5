"""The optax optimizers the JAX package trains with, in the port
(``autodist_tpu_torch/optim.py``), against optax on the JAX runner.

The optimizers: ``torch.optim.SGD`` as ``optax.sgd`` without and with
momentum, ``torch.optim.AdamW(weight_decay=...)`` as ``optax.adamw``, and
``optim.chain(optim.clip_by_global_norm(1.0), SGD(momentum=0.9))`` as the
imagenet example's ``optax.chain``, plus the same chain at a bound of
0.05, which NCF tiny's gradients cross in some trees and not in others
(its global norm is about 0.25, its variables' 0.03 to 0.13), so it
shows where each apply site takes the norm.

The apply sites, each on NCF tiny (the JAX init converted) for an
``evaluate`` and 3 steps of the same calls in both packages: the device
step (``AllReduce``, the norm over the device tree), ZeRO's per-shard
update (``ZeroSharded``, which degrades to the device step at N = 1;
the norm over one rank's flat shard at N = 2), the host store per shard
(``PS``: whole variables; ``PartitionedPS``: the norm over each shard),
and the fused carry (``PartitionedPS`` under ``fit(fuse_steps=3)``: the
norm over each full variable); at N = 2 also the device step over each
rank's shards of ``PartitionedAR``'s variables (AdamW and the tight
clip; the JAX package takes that norm on each device over its own
shards, so the devices' copies of a replicated variable part ways, and
each rank is held to the JAX device of its rank). At N = 1 in this
process against the JAX runner on one device;
at N = 2 on two gloo ranks
(``tests/torch_dist_worker.py``, one 2-rank job for every case) against
the JAX runner on 2 virtual devices.

Bounds, the Adam tests' (``tests/test_torch_recsys.py``): losses within
1e-5 relative, params and the optimizer state (as the JAX saver
flattens it) within 1e-6 absolute, the count and the store's counters
equal. The checkpoint files cross both ways with the same keys, shapes
and dtypes, and the item's spec serializes to the JAX item's bytes (a
chain to an unregistered ``optax.chain``'s: no name, no arguments).
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import autodist_tpu as jadt
import autodist_tpu_torch as adt
from autodist_tpu import strategy as jstrategy
from autodist_tpu.checkpoint.saver import Saver as JSaver
from autodist_tpu.checkpoint.saver import _tree_to_flat
from autodist_tpu.models import ncf as jncf
from autodist_tpu.resource_spec import ResourceSpec as JSpec
from autodist_tpu_torch import convert, optim, strategy
from autodist_tpu_torch.checkpoint import Saver
from autodist_tpu_torch.models import ncf as tncf
from autodist_tpu_torch.resource_spec import ResourceSpec
from torch_dist_worker import launch, make_optimizer

STEPS, BATCH = 3, 8
LOSS_RTOL, ATOL = 1e-5, 1e-6
ONE = {"nodes": [{"address": "127.0.0.1", "chief": True, "cpus": [0]}]}
TWO = {"nodes": [{"address": "127.0.0.1", "chief": True, "cpus": [0, 1]}]}
_SGD_M = {"lr": 0.1, "momentum": 0.9}
# case -> (the port's optimizer, as torch_dist_worker.make_optimizer
# takes it; the optax optimizer)
OPTS = {
    "sgd": ({"cls": "SGD", "kw": {"lr": 0.1}}, lambda: optax.sgd(0.1)),
    "sgd_momentum": ({"cls": "SGD", "kw": _SGD_M},
                     lambda: optax.sgd(0.1, momentum=0.9)),
    "adamw": ({"cls": "AdamW", "kw": {"lr": 1e-2, "weight_decay": 1e-2}},
              lambda: optax.adamw(1e-2, weight_decay=1e-2)),
    "clip_sgd_momentum": (
        {"cls": "SGD", "kw": _SGD_M, "clip": 1.0},
        lambda: optax.chain(optax.clip_by_global_norm(1.0),
                            optax.sgd(0.1, momentum=0.9))),
    "tight_clip_sgd_momentum": (
        {"cls": "SGD", "kw": _SGD_M, "clip": 0.05},
        lambda: optax.chain(optax.clip_by_global_norm(0.05),
                            optax.sgd(0.1, momentum=0.9))),
}
# site -> (builder class, fuse_steps)
SITES = {"AllReduce": ("AllReduce", 1), "ZeroSharded": ("ZeroSharded", 1),
         "PS": ("PS", 1), "PartitionedPS": ("PartitionedPS", 1),
         "fused": ("PartitionedPS", STEPS),
         "PartitionedAR": ("PartitionedAR", 1)}
CASES = [(o, s) for o in OPTS for s in SITES if s != "PartitionedAR"]
IDS = ["%s-%s" % c for c in CASES]
# at N = 2 the device step also runs on each rank's shards of the
# partitioned AllReduce variables (whose norm a tight clip shows)
TWO_CASES = CASES + [(o, "PartitionedAR") for o in
                     ("adamw", "tight_clip_sgd_momentum")]
TWO_IDS = ["%s-%s" % c for c in TWO_CASES]
STATS = ("pulls", "pushes", "bytes_pulled", "bytes_pushed")


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


def _setup():
    jl, jp, example, _ = jncf.make_train_setup(jncf.NCFConfig.tiny(),
                                               batch_size=BATCH)
    tl = tncf.make_train_setup(tncf.NCFConfig.tiny(), batch_size=BATCH)[0]
    batches = [tncf.make_train_setup(tncf.NCFConfig.tiny(),
                                     batch_size=BATCH, seed=s)[2]
               for s in range(1, STEPS + 1)]
    init = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return jl, jp, tl, init, example, batches


def _jax_run(opt, site, spec, save_dir=None):
    """The JAX runner's evaluate and 3 steps (or one fused superstep):
    losses, params, the optimizer state as its saver flattens it, the
    store's counters, and the item's spec and plan JSON."""
    jl, jp, _, _, example, batches = _setup()
    builder, fuse = SITES[site]
    try:
        ad = jadt.AutoDist(strategy_builder=getattr(jstrategy, builder)(),
                           resource_spec=JSpec.from_dict(spec))
        runner = ad.build(jl, OPTS[opt][1](), jp, example)
        runner.init(jp)
        ev = float(runner.evaluate(batches[:1])["loss"])
        if fuse > 1:
            losses = [float(m["loss"]) for m in
                      runner.fit(iter(batches), fuse_steps=fuse)]
        else:
            losses = [float(runner.run(b)["loss"]) for b in batches]
        dstep = runner.distributed_step
        store = dstep.ps_store
        out = {"eval": ev, "losses": losses,
               "params": {n: t.numpy() for n, t in convert.params_from_jax(
                   jax.tree_util.tree_map(np.asarray,
                                          runner.gather_params())).items()},
               "opt": {k: np.asarray(v) for k, v in _tree_to_flat(
                   dstep.gather_opt_state(runner.state)).items()},
               "stats": ({k: store.stats[k] for k in STATS}
                         if store is not None else None),
               "spec": dstep.model_item.serialize_spec().decode(),
               "plan": dstep.strategy.to_dict()}
        if site == "PartitionedAR":
            # a clip's norm is each device's own over its shards, so the
            # devices' copies of a replicated variable part ways: keep
            # the second device's (gather_params gives the first's)
            gathered = runner.gather_params()
            out["params_device1"] = {
                n: t.numpy() for n, t in convert.params_from_jax(
                    jax.tree_util.tree_map(
                        lambda g, st: np.asarray(
                            st.addressable_shards[1].data
                            if st.sharding.is_fully_replicated else g),
                        gathered, runner.state.params)).items()}
        if save_dir is not None:
            out["path"] = JSaver(directory=save_dir).save(runner)
    finally:
        jadt.reset()
    return out


def _port_run(opt, site, save_dir=None):
    """The port's run of :func:`_jax_run`'s calls, on the CPU."""
    _, _, tl, init, example, batches = _setup()
    builder, fuse = SITES[site]
    ad = adt.AutoDist(strategy_builder=getattr(strategy, builder)(),
                      resource_spec=ResourceSpec.from_dict(ONE),
                      device="cpu")
    runner = ad.build(tl, make_optimizer(OPTS[opt][0]), init, example)
    runner.init(init)
    ev = float(runner.evaluate(batches[:1])["loss"])
    if fuse > 1:
        losses = [float(m["loss"]) for m in
                  runner.fit(iter(batches), fuse_steps=fuse)]
    else:
        losses = [float(runner.run(b)["loss"]) for b in batches]
    dstep = runner.distributed_step
    item, store = dstep.model_item, dstep.ps_store
    out = {"eval": ev, "losses": losses,
           "params": {n: t.numpy() for n, t in
                      runner.gather_params().items()},
           "opt": convert.opt_state_to_jax(
               dstep.gather_opt_state(runner.state), item.flax_shapes,
               item.optimizer_spec),
           "stats": ({k: store.stats[k] for k in STATS}
                     if store is not None else None),
           "spec": json.dumps(item.to_spec_dict(), sort_keys=True),
           "plan": dstep.strategy.to_dict()}
    if save_dir is not None:
        out["path"] = Saver(directory=save_dir).save(runner)
    adt.reset()
    return out


def _check(got, want):
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=LOSS_RTOL, atol=0)
    np.testing.assert_allclose(got["eval"], want["eval"], rtol=LOSS_RTOL)
    assert got["params"].keys() == want["params"].keys()
    for name, value in want["params"].items():
        np.testing.assert_allclose(got["params"][name], value, atol=ATOL,
                                   rtol=0, err_msg=name)
    assert sorted(got["opt"]) == sorted(want["opt"])
    for key, value in want["opt"].items():
        got_v = np.asarray(got["opt"][key])
        assert got_v.shape == value.shape and got_v.dtype == value.dtype, key
        np.testing.assert_allclose(got_v, value, atol=ATOL, rtol=0,
                                   err_msg=key)
    assert got["stats"] == want["stats"]


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# --------------------------------------------------------------- the update


@pytest.mark.parametrize("opt", list(OPTS) + ["nesterov"])
def test_update_matches_optax(opt):
    """The update alone, on two variables, three steps of gradients whose
    norm starts above the clip bounds and falls below them."""
    if opt == "nesterov":
        factory = functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9,
                                    nesterov=True)
        ref = optax.sgd(0.1, momentum=0.9, nesterov=True)
    else:
        factory, ref = make_optimizer(OPTS[opt][0]), OPTS[opt][1]()
    spec = optim.capture(factory)
    rng = np.random.RandomState(0)
    params = {"w": rng.randn(5, 3).astype(np.float32),
              "b": rng.randn(7).astype(np.float32)}
    tp = {k: torch.as_tensor(v).clone() for k, v in params.items()}
    state = spec.init(tp)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = ref.init(jp)
    for step in range(STEPS):
        g = {k: (rng.randn(*v.shape) * 10.0 ** -step).astype(np.float32)
             for k, v in params.items()}
        spec.update({k: torch.as_tensor(v) for k, v in g.items()}, state, tp)
        upd, jstate = ref.update({k: jnp.asarray(v) for k, v in g.items()},
                                 jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       atol=ATOL, rtol=1e-6, err_msg=k)
    # the state's keys as the JAX saver flattens optax's (the port names a
    # top-level variable "w" as flax's "params/w")
    flat = _tree_to_flat(jstate)
    got = convert.opt_state_to_jax(state, None, spec)
    assert sorted(got) == sorted(k.replace("/w", "/params/w").replace(
        "/b", "/params/b") for k in flat)


def test_capture_accepts_the_optax_optimizers_and_refuses_the_rest():
    spec = optim.capture(functools.partial(torch.optim.SGD, lr=0.1))
    assert (spec.name, spec.args, spec.slots) == ("sgd", {"lr": 0.1}, ())
    spec = optim.capture(functools.partial(torch.optim.SGD, lr=0.1,
                                           momentum=0.9))
    assert spec.slots == ("trace",) and not spec.has_count
    chained = optim.chain(optim.clip_by_global_norm(1.0),
                          functools.partial(torch.optim.AdamW, lr=1e-4,
                                            weight_decay=1e-4))
    assert (chained.name, chained.args, chained.jax_prefix) == \
        (None, {}, "1/0/")
    assert optim.capture(chained) is chained
    for bad, match in [
            (dict(dampening=0.5, momentum=0.9), "dampening"),
            (dict(weight_decay=1e-4), "weight_decay"),
            (dict(nesterov=True), "nesterov"),
            (dict(foreach=True), "foreach")]:
        with pytest.raises(ValueError, match=match):
            optim.capture(functools.partial(torch.optim.SGD, lr=0.1, **bad))
    # the two libraries' default decays differ: AdamW names its own
    with pytest.raises(ValueError, match="1e-4.*1e-2"):
        optim.capture(functools.partial(torch.optim.AdamW, lr=1e-3))
    with pytest.raises(ValueError, match="amsgrad"):
        optim.capture(functools.partial(torch.optim.AdamW, lr=1e-3,
                                        weight_decay=0.1, amsgrad=True))
    with pytest.raises(ValueError, match="optax"):
        optim.capture(torch.optim.RMSprop)
    with pytest.raises(ValueError, match="optim.chain"):
        optim.chain(functools.partial(torch.optim.SGD, lr=0.1),
                    optim.clip_by_global_norm(1.0))
    with pytest.raises(ValueError, match="max_norm"):
        optim.clip_by_global_norm(0.0)


def test_the_clip_runs_on_the_device_with_no_read_back():
    """The clip's norm and choice stay tensors: nothing in the update
    converts one to a Python number (a CUDA graph holds it)."""
    spec = optim.chain(optim.clip_by_global_norm(1e-3),
                       functools.partial(torch.optim.SGD, lr=1.0))
    p = {"w": torch.zeros(4)}
    g = {"w": torch.full((4,), 3.0)}
    orig = torch.Tensor.item

    def no_item(self):
        raise AssertionError("a value read back to the host")
    torch.Tensor.item = no_item
    try:
        spec.update(g, spec.init(p), p)
    finally:
        torch.Tensor.item = orig
    # clipped to the bound: the step has norm 1e-3
    np.testing.assert_allclose(float(p["w"].norm()), 1e-3, rtol=1e-6)


def test_the_clip_norm_holds_float32_accuracy_on_large_gradients():
    """The clip divides every gradient by the global norm, so the norm's
    error is every update's: over 3 M elements it stays within 1e-6 of
    float64 (float32 ``_foreach_norm`` on the CPU is off by 3e-5 at 2 M;
    an H100 run saw the card's and the CPU's first updates part by that
    much)."""
    gen = torch.Generator().manual_seed(0)
    gs = [torch.randn(2_000_000, generator=gen) * 0.01,
          torch.randn(1_000_000, generator=gen) * 0.01]
    exact = float(sum(g.double().square().sum() for g in gs).sqrt())
    clipped = optim.clip_global_norm(gs, 1.0)
    for g, c in zip(gs, clipped):
        np.testing.assert_allclose(c.double().numpy(),
                                   (g.double() / exact).numpy(),
                                   rtol=1e-6, atol=0)


# -------------------------------------------------------------------- N = 1


@pytest.fixture(scope="module")
def one_replica(tmp_path_factory):
    """Every case at N = 1, the JAX runner's and the port's; the
    AllReduce and PartitionedPS cases save a checkpoint in both
    packages."""
    out = {}
    for opt, site in CASES:
        dirs = (None, None)
        if site in ("AllReduce", "PartitionedPS"):
            dirs = tuple(str(tmp_path_factory.mktemp(
                "%s_%s_%s" % (opt, site, who))) for who in ("jax", "port"))
        out[(opt, site)] = (_jax_run(opt, site, ONE, dirs[0]),
                            _port_run(opt, site, dirs[1]))
    return out


@pytest.mark.parametrize("opt,site", CASES, ids=IDS)
def test_one_replica_matches_optax_on_the_jax_runner(one_replica, opt, site):
    want, got = one_replica[(opt, site)]
    _check(got, want)


def test_the_tight_clip_shows_where_each_site_takes_the_norm(one_replica):
    """At a bound of 0.05 the device tree (norm about 0.25) clips every
    gradient, each whole variable only its larger ones, each half of a
    partitioned one fewer still: the sites train differently, as in the
    JAX package — the fused carry of the partitioned store as the whole
    variables of ``PS`` do — while the bound of 1.0 never bites and
    leaves them equal."""
    one_sites = [s for o, s in CASES if o == "sgd"]
    finals = {site: one_replica[("tight_clip_sgd_momentum", site)][1]
              ["losses"] for site in one_sites}
    assert len({finals[s][-1] for s in ("AllReduce", "PS",
                                        "PartitionedPS")}) == 3, finals
    np.testing.assert_allclose(finals["fused"], finals["PS"], rtol=1e-6)
    loose = {site: one_replica[("clip_sgd_momentum", site)][1]
             for site in one_sites}
    for site in one_sites:
        np.testing.assert_allclose(loose[site]["losses"],
                                   loose["AllReduce"]["losses"], rtol=1e-5)


@pytest.mark.parametrize("opt", list(OPTS))
def test_spec_json_and_partitions_are_the_jax_ones(one_replica, opt):
    """The item's spec is the JAX item's bytes, and each node of the plan
    partitions as the JAX plan's node of the same variable (the port's
    plan names variables the port's way; ``tests/test_torch_strategy.py``
    holds the builders to the JAX plan bytes over the JAX variable
    list)."""
    for site in ("AllReduce", "PartitionedPS"):
        want, got = one_replica[(opt, site)]
        assert got["spec"] == want["spec"]
        jnodes = {n["var_name"]: n for n in want["plan"]["node_config"]}
        names = {v["name"] for v in json.loads(got["spec"])["vars"]}
        assert names == set(jnodes)
        for node in got["plan"]["node_config"]:
            jname = convert.jax_name(node["var_name"], (0, 0)) \
                if node["var_name"].endswith(".weight") else None
            match = [j for j in jnodes if j == jname
                     or j.replace("/", ".") == "params." + node["var_name"]]
            assert len(match) == 1, node["var_name"]
            for key in ("partitioner", "shard_sizes"):
                assert node.get(key) == jnodes[match[0]].get(key), \
                    (node["var_name"], key)
    spec = json.loads(got["spec"])
    if opt.startswith(("clip", "tight")):
        assert (spec["optimizer_name"], spec["optimizer_args"]) == (None, {})


@pytest.mark.parametrize("site", ["AllReduce", "PartitionedPS"])
@pytest.mark.parametrize("opt", list(OPTS))
def test_checkpoints_cross_both_ways(one_replica, opt, site):
    """The files have the JAX files' keys, shapes and dtypes; each
    package restores the other's and holds the saved state bit for
    bit."""
    want, got = one_replica[(opt, site)]
    for suffix in (".params.npz", ".opt.npz"):
        mine, theirs = _npz(got["path"] + suffix), _npz(want["path"] + suffix)
        assert {k: (v.shape, v.dtype) for k, v in mine.items()} == \
            {k: (v.shape, v.dtype) for k, v in theirs.items()}, suffix
    jl, jp, tl, init, example, _ = _setup()
    builder = SITES[site][0]
    ad = adt.AutoDist(strategy_builder=getattr(strategy, builder)(),
                      resource_spec=ResourceSpec.from_dict(ONE),
                      device="cpu")
    runner = ad.build(tl, make_optimizer(OPTS[opt][0]), init, example)
    runner.init(init)
    Saver(directory=str(want["path"]).rsplit("/", 1)[0]).restore(runner)
    dstep = runner.distributed_step
    item = dstep.model_item
    restored = convert.opt_state_to_jax(dstep.gather_opt_state(
        runner.state), item.flax_shapes, item.optimizer_spec)
    theirs = _npz(want["path"] + ".opt.npz")
    assert restored.keys() == theirs.keys()
    for k, v in theirs.items():
        assert np.array_equal(restored[k], v), k
    adt.reset()
    try:
        ad = jadt.AutoDist(strategy_builder=getattr(jstrategy, builder)(),
                           resource_spec=JSpec.from_dict(ONE))
        jr = ad.build(jl, OPTS[opt][1](), jp, example)
        jr.init(jp)
        JSaver(directory=str(got["path"]).rsplit("/", 1)[0]).restore(jr)
        flat = _tree_to_flat(jr.distributed_step.gather_opt_state(jr.state))
    finally:
        jadt.reset()
    mine = _npz(got["path"] + ".opt.npz")
    assert sorted(flat) == sorted(mine)
    for k, v in mine.items():
        assert np.array_equal(np.asarray(flat[k]), v), k


# -------------------------------------------------------------------- N = 2


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Every case at N = 2: the JAX 2-device run and both port ranks',
    from one 2-rank job."""
    want, payload = {}, []
    _, _, _, init, example, batches = _setup()
    for opt, site in TWO_CASES:
        want[(opt, site)] = _jax_run(opt, site, TWO)
        builder, fuse = SITES[site]
        payload.append({"model": "ncf", "seq_len": 0, "batch_size": BATCH,
                        "attention": "", "builder": builder,
                        "optimizer": OPTS[opt][0], "fuse_steps": fuse,
                        "example": example,
                        "init": {n: t.numpy() for n, t in init.items()},
                        "batches": batches})
    ranks = launch("train", 2, tmp_path_factory.mktemp("optimizers"),
                   payload)
    return {key: (want[key], [r[i] for r in ranks])
            for i, key in enumerate(TWO_CASES)}


@pytest.mark.parametrize("opt,site", TWO_CASES, ids=TWO_IDS)
def test_two_ranks_match_optax_on_the_jax_runner(two_ranks, opt, site):
    want, ranks = two_ranks[(opt, site)]
    r0, r1 = ranks
    _check(dict(r0, opt=r0["opt_jax"]), want)
    assert r0["losses"] == r1["losses"]
    if "params_device1" in want:
        # each rank holds the JAX package's device of its rank
        _check(dict(r1, opt=r0["opt_jax"]),
               dict(want, params=want["params_device1"]))
        if opt.startswith("tight"):
            assert any(not np.array_equal(r0["params"][n], r1["params"][n])
                       for n in r0["params"])
        return
    _check(dict(r1, opt=r1["opt_jax"]), want)
    for name in r0["params"]:
        assert np.array_equal(r0["params"][name], r1["params"][name]), name
    if SITES[site][1] > 1:
        assert r0["dispatches"] == 1
