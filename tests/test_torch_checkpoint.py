"""autodist_tpu_torch's checkpoints against the JAX package's, on the CPU.

Both packages write the same files (``ckpt-<step>.{params,opt,sync}.npz``
and ``.meta.json``), keyed by the JAX names in flax's shapes, so a
checkpoint crosses between them:

- (a) the JAX ``Saver`` writes lm tiny and resnet tiny (its BatchNorm
  ``batch_stats`` drawn at random) after 2 Adam steps; the port's
  ``Saver.restore`` loads it bit for bit, and the port's step 3 matches
  the JAX runner's step 3;
- (b) the reverse: the port writes after its 2 steps, the JAX ``Saver``
  restores it bit for bit and continues;
- (c) ``numpy.load`` of the port's files gives the JAX files' keys,
  shapes and dtypes for the same model and steps;
- (d) N = 2: two gloo ranks of the port (``tests/torch_dist_worker.py``)
  against the JAX runner on 2 virtual devices, lm tiny with
  ``wire_dtype="int8"``: the ``.sync.npz`` holds the error-feedback
  residuals as ``[2, ...]``, the checkpoint crosses both ways, only rank
  0 writes, and a restore resumes bit for bit with the compressor state;
- (e) the port's counterparts of the plain-saver cases of
  ``tests/test_checkpoint.py``;
- (f) sharded plans at N = 2 (one 2-rank job, ``ckpt_cross_job``): lm
  tiny under ``ZeroSharded()`` and ``PartitionedAR()``. The JAX runner on
  2 virtual devices saves after 2 steps; the port's ranks restore it
  and gather a state equal, bit for bit, to the JAX files (the ZeRO
  moments rebuilt whole in ``.opt.npz`` and kept as ``[2, shard]`` rows
  in ``.sync.npz``; the partitioned variables unpadded), and their step 3
  is the JAX runner's; the port saves after its 2 steps and the JAX
  runner restores its files bit for bit and takes step 3.

Bounds of the step after a restore: losses within 1e-5 and params within
1e-4, the parity tests' bounds (``tests/test_torch_train.py``,
``tests/test_torch_data_parallel.py``; the int8 wire is held to the same),
except the attention key biases, whose gradient is zero analytically, so
Adam turns its rounding noise into a step of up to lr: 2 x steps x lr.
"""
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import autodist_tpu as jadt
import autodist_tpu_torch as adt
from autodist_tpu import strategy as jstrategy
from autodist_tpu.checkpoint import cli as jcli
from autodist_tpu.checkpoint.saver import Saver as JSaver
from autodist_tpu.checkpoint.saver import _tree_to_flat
from autodist_tpu.models import bert as jbert
from autodist_tpu.models import lm as jlm
from autodist_tpu.models import resnet as jresnet
from autodist_tpu.resource_spec import ResourceSpec as JSpec
from autodist_tpu_torch import convert, strategy
from autodist_tpu_torch.checkpoint import (CheckpointDamaged, Saver,
                                           SavedModelBuilder, integrity)
from autodist_tpu_torch.checkpoint.cli import main as cli_main
from autodist_tpu_torch.models import lm as tlm
from autodist_tpu_torch.models import resnet as tresnet
from autodist_tpu_torch.runtime import faultinject as fi
from autodist_tpu_torch.telemetry import spans as tel
from torch_dist_worker import LR, launch

STEPS = 3
ONE = {"nodes": [{"address": "127.0.0.1", "chief": True, "cpus": [0]}]}
TWO = {"nodes": [{"address": "127.0.0.1", "chief": True, "cpus": [0, 1]}]}
LM_SEQ, LM_BATCH, IMAGE, CLASSES = 16, 8, 32, 10


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


def _randomized(variables, seed):
    """flax variables with BatchNorm scale, bias, mean and var drawn at
    random, so that the statistics a checkpoint carries are not the
    init's."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        key = path[-1].key
        if key in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if key in ("mean", "bias"):
            return (0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        return np.asarray(leaf)
    return jax.tree_util.tree_map_with_path(draw, variables)


def _setup(model, batch=LM_BATCH):
    """(JAX loss, JAX variables, example, port loss, port params,
    batches) of lm tiny or resnet tiny from one JAX init."""
    rng = np.random.RandomState(5)
    if model == "lm":
        jl, jvars, example, _ = jlm.make_train_setup(
            jlm.LMConfig.tiny(), seq_len=LM_SEQ, batch_size=batch,
            attention="default", lean_head=True)
        tl = tlm.make_train_setup(tlm.LMConfig.tiny(), seq_len=LM_SEQ,
                                  batch_size=batch, attention="default",
                                  lean_head=True)[0]
        batches = [{"tokens": rng.randint(0, 128, (batch, LM_SEQ + 1))
                    .astype(np.int32)} for _ in range(4)]
    else:
        jl, jvars, example, _ = jresnet.make_train_setup(
            jresnet.ResNetTiny, num_classes=CLASSES, image_size=IMAGE,
            batch_size=4, dtype=jnp.float32)
        jvars = _randomized(jvars, seed=3)
        tl = tresnet.make_train_setup(
            tresnet.ResNetTiny, num_classes=CLASSES, image_size=IMAGE,
            batch_size=4, dtype=torch.float32)[0]
        batches = [{"image": rng.randn(4, IMAGE, IMAGE, 3).astype(np.float32),
                    "label": rng.randint(0, CLASSES, (4,)).astype(np.int32)}
                   for _ in range(4)]
    jvars = jax.tree_util.tree_map(np.asarray, jvars)
    return jl, jvars, example, tl, convert.params_from_jax(jvars), batches


def _jax_runner(jl, jvars, example, spec=ONE, **strategy_kw):
    ad = jadt.AutoDist(strategy_builder=jstrategy.AllReduce(**strategy_kw),
                       resource_spec=JSpec.from_dict(spec))
    runner = ad.build(jl, optax.adam(LR), jvars, example)
    runner.init(jvars)
    return runner


def _port_runner(tl, tparams, example, **strategy_kw):
    ad = adt.AutoDist(strategy_builder=strategy.AllReduce(**strategy_kw),
                      device="cpu")
    runner = ad.build(tl, functools.partial(torch.optim.Adam, lr=LR),
                      tparams, example)
    runner.init(tparams)
    return runner


def _jax_flat(runner):
    """The JAX runner's state as its saver flattens it."""
    dstep = runner.distributed_step
    return (_tree_to_flat(runner.gather_params()),
            _tree_to_flat(dstep.gather_opt_state(runner.state)))


def _port_flat(runner):
    item = runner.distributed_step.model_item
    return (convert.params_to_jax(runner.gather_params(), item.flax_shapes),
            convert.opt_state_to_jax(runner.state.opt_state,
                                     item.flax_shapes))


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _assert_flat_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k


def _params_close(got, want, steps=STEPS):
    assert got.keys() == want.keys()
    for name, value in got.items():
        tol = 2 * steps * LR if name.endswith("key.bias") else 1e-4
        np.testing.assert_allclose(np.asarray(value), np.asarray(want[name]),
                                   atol=tol, rtol=0, err_msg=name)


def _to_port(jparams):
    return {n: t.numpy() for n, t in convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams)).items()}


@pytest.fixture(scope="module", params=["lm", "resnet"])
def crossed(request, tmp_path_factory):
    """One model's checkpoints both ways at N = 1: each package's 2 steps
    and save, each package's step 3, and each restoring the other's
    checkpoint and taking step 3."""
    model = request.param
    jl, jvars, example, tl, tparams, b = _setup(model)
    jdir, pdir = (str(tmp_path_factory.mktemp(model + d))
                  for d in ("jax", "port"))
    out = {"model": model}
    try:
        runner = _jax_runner(jl, jvars, example)
        for x in b[:2]:
            runner.run(x)
        out["jax_path"] = JSaver(directory=jdir).save(runner)
        out["jax_loss3"] = float(runner.run(b[2])["loss"])
        out["jax_params3"] = _to_port(runner.gather_params())
    finally:
        jadt.reset()
    runner = _port_runner(tl, tparams, example)
    for x in b[:2]:
        runner.run(x)
    out["port_path"] = Saver(directory=pdir).save(runner)
    out["port_loss3"] = float(runner.run(b[2])["loss"])
    adt.reset()
    runner = _port_runner(tl, tparams, example)
    _, out["port_restored_step"] = Saver(directory=jdir).restore(runner)
    out["port_restored"] = _port_flat(runner)
    out["port_from_jax_loss3"] = float(runner.run(b[2])["loss"])
    out["port_from_jax_params3"] = {
        n: t.numpy() for n, t in runner.gather_params().items()}
    out["stats_unmoved"] = all(
        torch.equal(runner.gather_params()[n], tparams[n])
        for n in tparams if n.startswith("batch_stats."))
    adt.reset()
    try:
        runner = _jax_runner(jl, jvars, example)
        _, out["jax_restored_step"] = JSaver(directory=pdir).restore(runner)
        out["jax_restored"] = _jax_flat(runner)
        out["jax_from_port_loss3"] = float(runner.run(b[2])["loss"])
        out["jax_from_port_params3"] = _to_port(runner.gather_params())
    finally:
        jadt.reset()
    return out


def test_port_restores_a_jax_checkpoint(crossed):
    """(a) The port loads the JAX files bit for bit; its next step is the
    JAX runner's step 3."""
    c = crossed
    assert c["port_restored_step"] == 2
    params, opt = c["port_restored"]
    _assert_flat_equal(params, _npz(c["jax_path"] + ".params.npz"))
    _assert_flat_equal(opt, _npz(c["jax_path"] + ".opt.npz"))
    np.testing.assert_allclose(c["port_from_jax_loss3"], c["jax_loss3"],
                               atol=1e-5, rtol=1e-5)
    _params_close(c["port_from_jax_params3"], c["jax_params3"])
    assert c["stats_unmoved"]


def test_jax_restores_a_port_checkpoint(crossed):
    """(b) The JAX saver loads the port's files bit for bit and continues
    as its own uninterrupted run does."""
    c = crossed
    assert c["jax_restored_step"] == 2
    params, opt = c["jax_restored"]
    _assert_flat_equal(params, _npz(c["port_path"] + ".params.npz"))
    _assert_flat_equal(opt, _npz(c["port_path"] + ".opt.npz"))
    np.testing.assert_allclose(c["jax_from_port_loss3"], c["jax_loss3"],
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(c["port_loss3"], c["jax_loss3"], atol=1e-5,
                               rtol=1e-5)
    _params_close(c["jax_from_port_params3"], c["jax_params3"])


def test_port_files_have_the_jax_files_keys_shapes_and_dtypes(crossed):
    """(c) Same model, same steps: the same npz keys, shapes and dtypes
    (``0/count`` int32, the rest float32), the same meta keys and format,
    and no ``.sync.npz`` on either side (no compressor state at N = 1)."""
    c = crossed
    for suffix in (".params.npz", ".opt.npz"):
        mine, theirs = (_npz(c[k] + suffix) for k in ("port_path",
                                                      "jax_path"))
        assert {k: (v.shape, v.dtype) for k, v in mine.items()} == \
            {k: (v.shape, v.dtype) for k, v in theirs.items()}
    assert mine["0/count"].dtype == np.int32 and int(mine["0/count"]) == 2
    if c["model"] == "resnet":
        assert any(k.startswith("0/mu/batch_stats/") for k in theirs)
    metas = [json.load(open(c[k] + ".meta.json"))
             for k in ("port_path", "jax_path")]
    assert metas[0].keys() == metas[1].keys()
    assert metas[0]["format"] == metas[1]["format"] == "autodist_tpu.v1"
    assert metas[0]["step"] == metas[1]["step"] == 2
    assert metas[0]["healthy"] is True
    for c_path in (c["port_path"], c["jax_path"]):
        assert not os.path.exists(c_path + ".sync.npz")


@pytest.mark.parametrize("model", ["lm", "bert", "resnet"])
def test_params_to_jax_inverts_params_from_jax(model):
    """``params_to_jax(params_from_jax(t))`` gives back the JAX package's
    flat variables bit for bit (DenseGeneral kernels 3-D, convs HWIO,
    ``batch_stats``); the port's own init carries the same flax shapes."""
    if model == "lm":
        jvars = jlm.make_train_setup(jlm.LMConfig.tiny(), seq_len=16,
                                     batch_size=2)[1]
        tparams = tlm.init_params(tlm.LMConfig.tiny())
    elif model == "bert":
        from autodist_tpu_torch.models import bert as tbert
        jvars = jbert.make_train_setup(jbert.BertConfig.tiny(), seq_len=16,
                                       batch_size=2)[1]
        tparams = tbert.init_params(tbert.BertConfig.tiny())
    else:
        jvars = _randomized(jresnet.make_train_setup(
            jresnet.ResNetTiny, num_classes=CLASSES, image_size=IMAGE,
            batch_size=2)[1], seed=3)
        tparams = tresnet.init_params(tresnet.ResNetTiny(num_classes=CLASSES))
    want = _tree_to_flat(jvars)
    _assert_flat_equal(convert.params_to_jax(convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jvars))), want)
    assert {k: v.shape for k, v in convert.params_to_jax(tparams).items()} \
        == {k: v.shape for k, v in want.items()}


# ------------------------------------------------------- (d) N = 2, int8


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """lm tiny, ``wire_dtype="int8"``, 2 replicas: the JAX runner's 2
    steps, save and step 3; the port's 2-rank job (``ckpt_job``); then the
    JAX runner restoring the port's checkpoint and taking step 3."""
    jl, jvars, example, _, tparams, b = _setup("lm")
    tmp = tmp_path_factory.mktemp("ckpt2")
    jdir, pdir, empty = (tmp / d for d in ("jax", "port", "empty"))
    for d in (jdir, pdir, empty):
        d.mkdir()
    out = {}
    try:
        runner = _jax_runner(jl, jvars, example, TWO, wire_dtype="int8")
        for x in b[:2]:
            runner.run(x)
        out["jax_path"] = JSaver(directory=str(jdir)).save(runner)
        out["jax_loss3"] = float(runner.run(b[2])["loss"])
        out["jax_params3"] = _to_port(runner.gather_params())
    finally:
        jadt.reset()
    out["ranks"] = launch("ckpt", 2, tmp, {
        "model": "lm", "seq_len": LM_SEQ, "batch_size": LM_BATCH,
        "attention": "default", "strategy": {"wire_dtype": "int8"},
        "init": {n: t.numpy() for n, t in tparams.items()}, "batches": b,
        "jax_dir": str(jdir), "dir": str(pdir), "empty_dir": str(empty)})
    try:
        runner = _jax_runner(jl, jvars, example, TWO, wire_dtype="int8")
        _, out["jax_restored_step"] = JSaver(directory=str(pdir)).restore(
            runner, str(pdir / "ckpt-2"))
        out["jax_restored_sync"] = _tree_to_flat(
            runner.distributed_step.gather_sync_state(runner.state))
        out["jax_from_port_loss3"] = float(runner.run(b[2])["loss"])
        out["jax_from_port_params3"] = _to_port(runner.gather_params())
    finally:
        jadt.reset()
    out["port_path"] = str(pdir / "ckpt-2")
    return out


def test_two_ranks_write_the_jax_sync_state_and_only_rank_0_writes(
        two_ranks):
    r0, r1 = (r["own"] for r in two_ranks["ranks"])
    assert r0["path"] == two_ranks["port_path"] and r1["path"] is None
    assert (r0["saves"], r1["saves"]) == (1.0, 0.0)
    mine = _npz(two_ranks["port_path"] + ".sync.npz")
    theirs = _npz(two_ranks["jax_path"] + ".sync.npz")
    assert {k: (v.shape, v.dtype) for k, v in mine.items()} == \
        {k: (v.shape, v.dtype) for k, v in theirs.items()}
    (key, rows), = mine.items()
    assert key.startswith("bucket/") and rows.shape[0] == 2
    # row r is rank r's error-feedback residual at the save
    for r, out in enumerate((r0, r1)):
        assert np.array_equal(rows[r],
                              out["saved_sync"]["bucket"][key[7:]])
    assert not np.array_equal(rows[0], rows[1])
    for suffix in (".params.npz", ".opt.npz"):
        assert {k: v.shape for k, v in _npz(two_ranks["port_path"]
                                            + suffix).items()} == \
            {k: v.shape for k, v in _npz(two_ranks["jax_path"]
                                         + suffix).items()}


def test_two_ranks_cross_both_ways_at_the_int8_bounds(two_ranks):
    ref_loss, ref = two_ranks["jax_loss3"], two_ranks["jax_params3"]
    theirs = _npz(two_ranks["jax_path"] + ".sync.npz")
    for rank, out in enumerate(two_ranks["ranks"]):
        got = out["from_jax"]
        assert got["step"] == 2
        (key, rows), = theirs.items()
        assert np.array_equal(got["sync_state"]["bucket"][key[7:]],
                              rows[rank])
        np.testing.assert_allclose(got["loss"], ref_loss, atol=1e-5,
                                   rtol=1e-5)
        _params_close(got["params"], ref)
    assert two_ranks["jax_restored_step"] == 2
    _assert_flat_equal(two_ranks["jax_restored_sync"],
                       _npz(two_ranks["port_path"] + ".sync.npz"))
    np.testing.assert_allclose(two_ranks["jax_from_port_loss3"], ref_loss,
                               atol=1e-5, rtol=1e-5)
    _params_close(two_ranks["jax_from_port_params3"], ref)


def test_two_ranks_resume_bit_exact_with_compressor_state(two_ranks):
    """Saved at step 2, on to 4; restored at 2 and on to 4 again: the
    same losses and params, bit for bit, and each rank took back its own
    error-feedback row."""
    for out in (r["own"] for r in two_ranks["ranks"]):
        assert out["step"] == 2
        assert out["again"] == out["losses"][2:]
        for name, value in out["params"].items():
            assert np.array_equal(value, out["params_again"][name]), name
        for key, value in out["saved_sync"]["bucket"].items():
            assert np.array_equal(out["restored_sync"]["bucket"][key], value)


def test_two_ranks_auto_resume(two_ranks):
    """``ADT_AUTO_RESUME`` at N = 2: no valid checkpoint raises (peers
    would diverge); the directory's newest checkpoint is restored."""
    for r in two_ranks["ranks"]:
        assert "refusing to start fresh" in r["resume_empty"]
        assert r["resume_step"] == 2


# ------------------------------------ (f) N = 2, ZeroSharded, PartitionedAR


SHARDED = ("ZeroSharded", "PartitionedAR")


@pytest.fixture(scope="module")
def sharded_cross(tmp_path_factory):
    """Per builder: the JAX 2-device runner's save at step 2, its step 3
    and its restore of the port's save; the port ranks' results."""
    jl, jvars, example, _, tparams, b = _setup("lm")
    tmp = tmp_path_factory.mktemp("sharded")
    out, payload = {}, []
    for name in SHARDED:
        jdir, pdir = tmp / ("jax_" + name), tmp / ("port_" + name)
        jdir.mkdir()
        pdir.mkdir()
        try:
            ad = jadt.AutoDist(strategy_builder=getattr(jstrategy, name)(),
                               resource_spec=JSpec.from_dict(TWO))
            runner = ad.build(jl, optax.adam(LR), jvars, example)
            runner.init(jvars)
            for x in b[:2]:
                runner.run(x)
            out[name] = {"jax_path": JSaver(directory=str(jdir)).save(runner),
                         "jax_loss3": float(runner.run(b[2])["loss"]),
                         "jax_params3": _to_port(runner.gather_params())}
        finally:
            jadt.reset()
        payload.append({"model": "lm", "seq_len": LM_SEQ,
                        "batch_size": LM_BATCH, "attention": "default",
                        "builder": name, "batches": b, "jax_dir": str(jdir),
                        "dir": str(pdir),
                        "init": {n: t.numpy() for n, t in tparams.items()}})
    ranks = launch("ckpt_cross", 2, tmp, payload)
    for i, name in enumerate(SHARDED):
        out[name]["ranks"] = [r[i] for r in ranks]
        try:
            ad = jadt.AutoDist(strategy_builder=getattr(jstrategy, name)(),
                               resource_spec=JSpec.from_dict(TWO))
            runner = ad.build(jl, optax.adam(LR), jvars, example)
            runner.init(jvars)
            path = out[name]["ranks"][0]["path"]
            _, out[name]["jax_restored_step"] = JSaver(
                directory=os.path.dirname(path)).restore(runner, path)
            dstep = runner.distributed_step
            out[name]["jax_restored"] = {
                ".params.npz": _tree_to_flat(runner.gather_params()),
                ".opt.npz": _tree_to_flat(dstep.gather_opt_state(
                    runner.state)),
                ".sync.npz": _tree_to_flat(dstep.gather_sync_state(
                    runner.state))}
            out[name]["jax_from_port_loss3"] = float(runner.run(b[2])["loss"])
            out[name]["jax_from_port_params3"] = _to_port(
                runner.gather_params())
        finally:
            jadt.reset()
    return out


@pytest.mark.parametrize("name", SHARDED)
def test_two_ranks_restore_a_sharded_jax_checkpoint(sharded_cross, name):
    c = sharded_cross[name]
    for rank, got in enumerate(c["ranks"]):
        assert got["step"] == 2
        for suffix in (".params.npz", ".opt.npz", ".sync.npz"):
            path = c["jax_path"] + suffix
            want = _npz(path) if os.path.exists(path) else {}
            _assert_flat_equal(got["files"][suffix], want)
        np.testing.assert_allclose(got["loss"], c["jax_loss3"], atol=1e-5,
                                   rtol=1e-5)
        _params_close(got["params"], c["jax_params3"])
    sync = _npz(c["jax_path"] + ".sync.npz") if name == "ZeroSharded" \
        else {}
    assert (name == "ZeroSharded") == bool(sync)
    assert all(k.startswith("zero/") and v.shape[0] == 2
               for k, v in sync.items())
    r0 = c["ranks"][0]
    if name == "PartitionedAR":
        # each rank stores half of the partitioned variables
        assert sum(r0["stored"].values()) < 0.6 * sum(
            v.size for v in r0["params"].values())


@pytest.mark.parametrize("name", SHARDED)
def test_jax_restores_a_sharded_port_checkpoint(sharded_cross, name):
    c = sharded_cross[name]
    r0, r1 = c["ranks"]
    assert r1["path"] is None and r0["path"].endswith("ckpt-2")
    assert c["jax_restored_step"] == 2
    for suffix, flat in c["jax_restored"].items():
        path = r0["path"] + suffix
        _assert_flat_equal(flat, _npz(path) if os.path.exists(path) else {})
    np.testing.assert_allclose(c["jax_from_port_loss3"], c["jax_loss3"],
                               atol=1e-5, rtol=1e-5)
    _params_close(c["jax_from_port_params3"], c["jax_params3"])


# ------------------------------------------- (e) the plain-saver cases


def _problem():
    rng = np.random.RandomState(1)
    params = {"emb": torch.from_numpy(rng.randn(16, 4).astype(np.float32)),
              "w": torch.from_numpy(rng.randn(4, 2).astype(np.float32))}

    def loss_fn(p, batch):
        feat = F.embedding(torch.as_tensor(batch["ids"]).long(), p["emb"])
        return torch.mean((feat @ p["w"] - torch.as_tensor(batch["y"])) ** 2)

    batch = {"ids": rng.randint(0, 16, (16,)).astype(np.int32),
             "y": rng.randn(16, 2).astype(np.float32)}
    return params, loss_fn, batch


def _runner(lr=0.05):
    params, loss_fn, batch = _problem()
    ad = adt.AutoDist(strategy_builder=strategy.AllReduce(), device="cpu")
    runner = ad.build(loss_fn, functools.partial(torch.optim.Adam, lr=lr),
                      params, batch)
    runner.init(params)
    return runner, batch


def _counters():
    return tel.counters()


def test_framework_resume_bitexact(tmp_path):
    runner, batch = _runner()
    for _ in range(3):
        runner.run(batch)
    saver = Saver(directory=str(tmp_path))
    saver.save(runner)
    for _ in range(2):
        runner.run(batch)
    final_a = {n: t.clone() for n, t in runner.gather_params().items()}
    state, step = saver.restore(runner)
    assert step == 3 and state.opt_state["count"] == 3
    for _ in range(2):
        runner.run(batch)
    for n, t in runner.gather_params().items():
        assert torch.equal(t, final_a[n]), n


def test_gc_ignores_foreign_files(tmp_path):
    (tmp_path / "best-model.meta.json").write_text("{}")
    runner, batch = _runner()
    runner.run(batch)
    saver = Saver(directory=str(tmp_path), max_to_keep=1)
    assert saver.save(runner) is not None
    assert (tmp_path / "best-model.meta.json").exists()


def test_max_to_keep(tmp_path):
    runner, batch = _runner()
    saver = Saver(directory=str(tmp_path), max_to_keep=2)
    for _ in range(4):
        runner.run(batch)
        saver.save(runner)
    metas = [f for f in os.listdir(tmp_path) if f.endswith(".meta.json")]
    assert len(metas) == 2
    assert saver.latest().endswith("ckpt-4")


def test_saved_model_export_matches_the_jax_spec(tmp_path):
    """The export's params under the JAX names in flax's shapes, and a
    ``model_spec.json`` whose variables and optimizer are the JAX item's
    for the same model."""
    jl, jvars, example, tl, tparams, _ = _setup("lm", batch=4)
    try:
        ad = jadt.AutoDist(strategy_builder=jstrategy.AllReduce(),
                           resource_spec=JSpec.from_dict(ONE))
        jrunner = ad.build(jl, optax.adam(LR), jvars, example)
        want = jrunner.distributed_step.model_item.to_spec_dict()
    finally:
        jadt.reset()
    runner = _port_runner(tl, tparams, example)
    out = SavedModelBuilder(str(tmp_path / "export")).save(runner)
    spec = json.load(open(os.path.join(out, "model_spec.json")))
    for key in ("vars", "optimizer_name", "optimizer_args", "has_aux",
                "mode"):
        assert spec[key] == want[key], key
    flat = _npz(os.path.join(out, "params.npz"))
    assert {k: list(v.shape) for k, v in flat.items()} == \
        {v["name"]: v["shape"] for v in want["vars"]}


def test_async_save_equivalent_and_overlapping(tmp_path):
    runner, batch = _runner()
    for _ in range(3):
        runner.run(batch)
    sync_saver = Saver(directory=str(tmp_path / "sync"))
    sync_saver.save(runner)
    async_saver = Saver(directory=str(tmp_path / "async"), async_save=True)
    async_saver.save(runner)
    runner.run(batch)  # trains (in place) while the write may be in flight
    a, b = sync_saver.latest(), async_saver.latest()  # latest() joins
    for suffix in (".params.npz", ".opt.npz"):
        _assert_flat_equal(_npz(b + suffix), _npz(a + suffix))
    state, step = async_saver.restore(runner)
    assert step == 3
    async_saver.save(runner, step=100)
    async_saver.save(runner, step=101)
    async_saver.wait()
    steps = [s for s, _ in async_saver._own_metas()]
    assert 100 in steps and 101 in steps


def test_fit_save_every(tmp_path, monkeypatch):
    """``fit(save_every=N)`` checkpoints every N steps plus the final
    partial window through an async saver on ``ADT_CKPT_DIR``."""
    monkeypatch.setenv("ADT_CKPT_DIR", str(tmp_path))
    runner, batch = _runner()
    history = runner.fit([batch] * 7, save_every=3)
    assert len(history) == 7
    saver = Saver(directory=str(tmp_path))
    assert [s for s, _ in saver._own_metas()] == [3, 6, 7]
    _, step = saver.restore(runner)
    assert step == 7
    # fused, save_every rounds up to the superstep boundaries: the steps
    # the JAX package's fit saves at for the same call from the same step
    runner.fit([batch] * 7, fuse_steps=2, save_every=3,
               saver=Saver(directory=str(tmp_path / "fused")))
    jparams = {n: jnp.asarray(t.numpy()) for n, t in _problem()[0].items()}

    def jloss(p, b):
        feat = jnp.take(p["emb"], b["ids"], axis=0)
        return jnp.mean((feat @ p["w"] - b["y"]) ** 2)
    try:
        jr = jadt.AutoDist(strategy_builder=jstrategy.AllReduce()).build(
            jloss, optax.adam(0.05), jparams, batch)
        jr.init(jparams)
        for _ in range(7):
            jr.run(batch)
        jr.fit([batch] * 7, fuse_steps=2, save_every=3,
               saver=JSaver(directory=str(tmp_path / "jax_fused")))
    finally:
        jadt.reset()
    jsteps = sorted(int(f[len("ckpt-"):-len(".meta.json")])
                    for f in os.listdir(tmp_path / "jax_fused")
                    if f.endswith(".meta.json"))
    assert [s for s, _ in Saver(directory=str(tmp_path / "fused"))
            ._own_metas()] == jsteps == [11, 14]


def test_saver_atomic_write_checksums_and_latency_hist(tmp_path):
    runner, batch = _runner()
    runner.run(batch)
    path = Saver(directory=str(tmp_path)).save(runner)
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    meta = json.load(open(path + ".meta.json"))
    assert set(meta["files"]) == {"ckpt-1.params.npz", "ckpt-1.opt.npz"}
    for fname, digest in meta["files"].items():
        assert digest["bytes"] == os.path.getsize(tmp_path / fname)
    status = integrity.validate_plain(str(tmp_path), 1, deep=True)
    assert status.committed and not status.problems, status.to_dict()
    hist = tel.histograms().get("ckpt.save_ms")
    assert hist is not None and hist["count"] >= 1


def test_plain_restore_falls_back_past_torn_and_corrupt(tmp_path):
    runner, batch = _runner()
    saver = Saver(directory=str(tmp_path))
    for _ in range(3):
        runner.run(batch)
        saver.save(runner)
    fi.truncate_file(str(tmp_path / "ckpt-3.params.npz"), 100)
    os.remove(tmp_path / "ckpt-2.meta.json")
    c0 = _counters()
    _, step = saver.restore(runner)
    c1 = _counters()
    assert step == 1
    assert c1["ckpt.fallback"] - c0.get("ckpt.fallback", 0) >= 2
    assert c1["ckpt.corrupt_shards"] > c0.get("ckpt.corrupt_shards", 0)
    with pytest.raises(CheckpointDamaged, match="corrupt"):
        saver.restore(runner, str(tmp_path / "ckpt-3"))
    assert saver.latest().endswith("ckpt-1")


def test_restore_explicit_path_outside_saver_directory(tmp_path):
    runner, batch = _runner()
    runner.run(batch)
    theirs = tmp_path / "their-job"
    path = Saver(directory=str(theirs)).save(runner)
    _, step = Saver(directory=str(tmp_path / "mine")).restore(runner,
                                                              path=path)
    assert step == 1
    fi.flip_bit(path + ".params.npz", 0)   # the zip's local header
    with pytest.raises(CheckpointDamaged):
        Saver(directory=str(tmp_path / "mine")).restore(runner, path=path)
    with pytest.raises(ValueError, match="ckpt-<step>"):
        integrity.parse_base(str(tmp_path / "not-a-checkpoint"))


def test_gc_removes_failed_attempts(tmp_path):
    runner, batch = _runner()
    saver = Saver(directory=str(tmp_path))
    runner.run(batch)
    saver.save(runner)  # committed step 1
    (tmp_path / "ckpt-0.params.npz").write_bytes(b"torn")
    (tmp_path / "ckpt-1.opt.npz.tmp").write_bytes(b"partial")
    c0 = _counters()
    runner.run(batch)
    saver.save(runner)  # committed step 2 -> gc sweeps the debris
    assert not os.path.exists(tmp_path / "ckpt-0.params.npz")
    assert not os.path.exists(tmp_path / "ckpt-1.opt.npz.tmp")
    assert _counters()["ckpt.gc_orphans"] - c0.get("ckpt.gc_orphans",
                                                   0) >= 2
    _, step = saver.restore(runner)
    assert step == 2


def test_checkpoint_cli_ls_fsck_gc(tmp_path, capsys):
    """The lifecycle CLI end to end, its ``ls --json`` equal to the JAX
    CLI's on the same directory."""
    runner, batch = _runner()
    saver = Saver(directory=str(tmp_path))
    for _ in range(2):
        runner.run(batch)
        saver.save(runner)
    (tmp_path / "ckpt-9.params.npz").write_bytes(b"torn")  # crash mid-save
    assert cli_main(["--dir", str(tmp_path), "ls", "--json"]) == 0
    rows = json.loads(capsys.readouterr().out)
    assert jcli.main(["--dir", str(tmp_path), "ls", "--json"]) == 0
    assert json.loads(capsys.readouterr().out) == rows
    states = {r["step"]: r["state"] for r in rows}
    assert states == {1: "committed", 2: "committed", 9: "torn"}
    assert cli_main(["--dir", str(tmp_path), "fsck"]) == 0
    assert cli_main(["--dir", str(tmp_path), "fsck", "--strict"]) == 1
    capsys.readouterr()
    fi.flip_bit(str(tmp_path / "ckpt-2.opt.npz"))
    assert cli_main(["--dir", str(tmp_path), "fsck"]) == 1
    assert "corrupt" in capsys.readouterr().out
    assert cli_main(["--dir", str(tmp_path), "gc", "--orphans"]) == 0
    assert not os.path.exists(tmp_path / "ckpt-9.params.npz")
    assert cli_main(["--dir", str(tmp_path), "gc"]) == 2
    assert cli_main(["--dir", str(tmp_path), "gc", "--damaged"]) == 0
    capsys.readouterr()
    assert not os.path.exists(tmp_path / "ckpt-2.meta.json")
    assert os.path.exists(tmp_path / "ckpt-1.meta.json")
    assert cli_main(["--dir", str(tmp_path), "fsck", "--strict"]) == 0
    assert cli_main(["--dir", str(tmp_path / "nowhere"), "ls"]) == 2


def test_ckpt_fault_plan_kills_and_damage(tmp_path, monkeypatch):
    """The plan's mechanics with ``_kill_self`` intercepted, and a plan
    from ``ADT_CKPT_FAULT_PLAN`` damaging a committed save, which the
    restore then falls back from."""
    kills = []
    monkeypatch.setattr(fi, "_kill_self", lambda: kills.append(True))
    plan = fi.CheckpointFaultPlan({
        "kills": [{"phase": "meta", "nth": 2}],
        "damage": [{"op": "truncate", "phase": "committed",
                    "file": "params.npz", "bytes": 10}]})
    target = tmp_path / "ckpt-4.params.npz"
    target.write_bytes(b"A" * 100)
    plan.fire("write", path=str(target))
    plan.fire("meta")
    assert not kills
    plan.fire("meta")
    assert kills == [True]
    plan.fire("committed", path=str(tmp_path / "ckpt-4"))
    assert target.stat().st_size == 10
    assert plan.injected == ["kill:meta", "truncate:ckpt-4.params.npz"]
    plan = fi.CheckpointFaultPlan({"seed": 7, "damage": [
        {"op": "truncate", "phase": "committed", "file": "params.npz",
         "prob": 0.0, "bytes": 1}]})
    for _ in range(5):
        plan.fire("committed", path=str(target))
    assert target.stat().st_size == 10 and not plan.injected
    assert not plan.rules[0]._spent

    ckpts = tmp_path / "ckpts"
    runner, batch = _runner()
    saver = Saver(directory=str(ckpts))
    runner.run(batch)
    saver.save(runner)
    monkeypatch.setenv("ADT_CKPT_FAULT_PLAN", json.dumps({
        "kills": [{"phase": "write"}],
        "damage": [{"op": "bitflip", "phase": "committed",
                    "file": "opt.npz", "offset": 0}]}))
    runner.run(batch)
    saver.save(runner)                     # the kill is intercepted
    assert kills == [True, True]
    assert integrity.validate_plain(str(ckpts), 2, deep=True).state == \
        integrity.CORRUPT
    _, step = saver.restore(runner)
    assert step == 1


def test_validation_and_read_error_hardening(tmp_path):
    from autodist_tpu_torch.checkpoint.saver import _read_npz
    (tmp_path / "ckpt-3.meta.json").write_text(json.dumps({"step": 3}))
    (tmp_path / "ckpt-3.opt.npz").write_bytes(b"not-a-zip")
    status = integrity.validate_plain(str(tmp_path), 3)
    assert status.state == integrity.CORRUPT
    assert any("params.npz missing" in p for p in status.problems)
    with pytest.raises(CheckpointDamaged, match="unreadable"):
        _read_npz(str(tmp_path / "ckpt-3.params.npz"))
    with pytest.raises(CheckpointDamaged, match="unreadable"):
        _read_npz(str(tmp_path / "ckpt-3.opt.npz"))
    gen = integrity.committed_newest_first(str(tmp_path), "plain")
    assert next(gen).step == 3
    assert next(gen, None) is None


def test_restore_refuses_another_model(tmp_path):
    """A checkpoint of other variables is a configuration error, raised
    by name, not a damaged checkpoint to fall back from."""
    runner, batch = _runner()
    runner.run(batch)
    path = Saver(directory=str(tmp_path)).save(runner)
    flat = _npz(path + ".params.npz")
    flat["params/w"] = flat["params/w"][:, :1]
    np.savez(path + ".params.npz", **flat)
    meta = json.load(open(path + ".meta.json"))
    meta["files"]["ckpt-1.params.npz"] = integrity.file_digest(
        path + ".params.npz")
    json.dump(meta, open(path + ".meta.json", "w"))
    with pytest.raises(ValueError, match="params/w"):
        Saver(directory=str(tmp_path)).restore(runner)


def test_auto_resume_one_replica(tmp_path, monkeypatch):
    """``ADT_AUTO_RESUME`` with one replica: the newest valid checkpoint
    in ``ADT_CKPT_DIR`` replaces the fresh init; with none, a fresh
    start."""
    runner, batch = _runner()
    for _ in range(2):
        runner.run(batch)
    Saver(directory=str(tmp_path)).save(runner)
    saved = {n: t.clone() for n, t in runner.gather_params().items()}
    monkeypatch.setenv("ADT_AUTO_RESUME", "1")
    monkeypatch.setenv("ADT_CKPT_DIR", str(tmp_path))
    params, _, _ = _problem()
    state = runner.init(params)
    assert state.step == 2 and state.opt_state["count"] == 2
    for n, t in state.params.items():
        assert torch.equal(t, saved[n]), n
    monkeypatch.setenv("ADT_CKPT_DIR", str(tmp_path / "empty"))
    state = runner.init(params)
    assert state.step == 0
    assert torch.equal(state.params["w"], params["w"])
