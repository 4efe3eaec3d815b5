"""autodist_tpu_torch's sharded checkpoints against the JAX package's.

The port's ``ShardedSaver`` writes the JAX ``ShardedSaver``'s format
(``ckpt-N.shard-p<pid>.{npz,index.json}`` and ``ckpt-N.shard-meta.json``,
the ``P|``/``O|``/``S|``/``H|``/``Ho|`` keys with slice tokens in padded
global coordinates), so a checkpoint either package writes restores in
the other, at the same topology or another. The port's ranks are
spawned processes in one gloo group (``tests/torch_dist_worker.py``'s
``sharded`` job, one 2-rank job); the JAX side runs in the pytest
process on the session's 8 virtual CPU devices.

Cases, every comparison bit for bit (``numpy.testing.assert_array_equal``
on the gathered params and optimizer state in the JAX layout):

- the JAX package saves ``tp_lm.tiny()`` at tp 2 (its ``{data: 4, model:
  2}`` mesh) and ZeroSharded on 8 devices; the port restores the first at
  tp 2 on 2 ranks and at tp 1 in one process, and the second at N = 2;
- the port saves ``tp_lm`` at tp 2 and ZeroSharded at N = 2; the JAX
  package restores both on its mesh; the port restores its tp 2 save at
  tp 2 (the next steps' losses equal the uninterrupted run's) and at
  tp 1; no rank writes another's slice and no model-parallel variable is
  gathered (each rank's file holds its own slices);
- host-PS shards (PartitionedPS and Parallax) round-trip, and restore
  under another shard layout (PartitionedPS -> PS) re-sliced;
- a between-graph (async PS) job's ``@p<pid>`` keys round-trip, each
  process reading its own;
- the port's ``export_full`` writes the JAX one's arrays, bytes and meta;
- a torn save (a kill at the ``index`` phase, in a child process) and a
  bit-flipped shard fall back to the older step; ``ls``/``fsck`` over a
  port-written directory.
"""
import functools
import json
import os
import subprocess
import sys
import zipfile

import jax
import numpy as np
import optax
import pytest
import torch

import autodist_tpu as jadt
import autodist_tpu_torch as adt
from autodist_tpu import strategy as JS
from autodist_tpu.checkpoint.sharded import ShardedSaver as JSharded
from autodist_tpu.kernel.common import variable_utils
from autodist_tpu.models import tp_lm as jtp_lm
from autodist_tpu_torch import convert, strategy
from autodist_tpu_torch.checkpoint import ShardedSaver, integrity
from autodist_tpu_torch.checkpoint.cli import main as cli_main
from autodist_tpu_torch.models import tp_lm
from autodist_tpu_torch.telemetry import spans as tel
from torch_dist_worker import launch, lin_loss, tower_setup

LR = 1e-3
STEPS = 2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reset():
    adt.reset()
    yield
    adt.reset()
    jadt.reset()


def _np_tree(tree):
    names, leaves, _ = variable_utils.flatten_named(
        jax.tree_util.tree_map(np.asarray, tree))
    return dict(zip(names, leaves))


def _jax_state(runner):
    """A JAX runner's gathered params and optimizer state, by the JAX
    flattened names."""
    dstep = runner.distributed_step
    return {"params": _np_tree(runner.gather_params()),
            "opt_jax": _np_tree(dstep.gather_opt_state(runner.state))}


def _same(got, want, what):
    assert sorted(got) == sorted(want), what
    for n, w in want.items():
        np.testing.assert_array_equal(np.asarray(got[n]), np.asarray(w),
                                      err_msg="%s %s" % (what, n))


def _lm():
    loss_fn, params, batch, _ = jtp_lm.make_train_setup(
        jtp_lm.TPLMConfig.tiny(), seq_len=16, batch_size=8, seed=3)
    rng = np.random.RandomState(4)
    batches = [batch] + [{"tokens": rng.randint(
        0, 64, batch["tokens"].shape).astype(np.int32)} for _ in range(5)]
    flat = {n: t.numpy() for n, t in convert.tp_lm_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)).items()}
    return loss_fn, params, batches, flat


def _big():
    rng = np.random.RandomState(0)
    params = {"big": rng.randn(64, 8).astype(np.float32),
              "w": rng.randn(8, 2).astype(np.float32)}
    batches = [{"x": rng.randn(16, 64).astype(np.float32),
                "y": rng.randn(16, 2).astype(np.float32)}
               for _ in range(4)]
    return params, batches


def _jax_big_loss(p, b):
    import jax.numpy as jnp
    return jnp.mean(((b["x"] @ p["big"]) @ p["w"] - b["y"]) ** 2)


def _jax_runner(kind, params, batch):
    jadt.reset()
    if kind == "tp":
        loss_fn, _, _, _ = _lm()
        ad = jadt.AutoDist(strategy_builder=JS.TensorParallel(
            2, jtp_lm.tp_rules()))
        runner = ad.build(loss_fn, optax.adam(LR), params, batch)
    else:
        ad = jadt.AutoDist(strategy_builder=JS.ZeroSharded())
        runner = ad.build(_jax_big_loss, optax.adam(LR), params, batch)
    runner.init(params)
    return runner


@pytest.fixture(scope="module")
def jax_ckpts(tmp_path_factory):
    """The JAX package's sharded saves: tp_lm at tp 2 and ZeroSharded on
    its 8 devices, after two steps, with their gathered states."""
    out = {}
    _, params, batches, _ = _lm()
    big, big_batches = _big()
    for kind, p, bs in (("tp", params, batches), ("zero", big,
                                                  big_batches)):
        runner = _jax_runner(kind, p, bs[0])
        for b in bs[:STEPS]:
            runner.run(b)
        d = str(tmp_path_factory.mktemp("jax_" + kind))
        out[kind] = {"path": JSharded(d).save(runner),
                     "state": _jax_state(runner)}
        jadt.reset()
    return out


@pytest.fixture(scope="module")
def port_runs(jax_ckpts, tmp_path_factory):
    """One 2-rank job: (0) restore the JAX tp 2 save at tp 2; (1) tp 2
    from init, two steps, save, two more; (2) restore (1)'s save at tp 2,
    two steps; (3) ZeroSharded two steps, save; (4) restore the JAX
    ZeroSharded save at N = 2."""
    _, _, batches, flat = _lm()
    big, big_batches = _big()
    save_tp = str(tmp_path_factory.mktemp("port_tp"))
    save_zero = str(tmp_path_factory.mktemp("port_zero"))
    lm = dict(loss="tp_lm", tp=2, init=flat, batches=batches,
              optimizer={"cls": "Adam", "kw": {"lr": LR}})
    zero = dict(loss="big", builder="ZeroSharded", init=big,
                batches=big_batches,
                optimizer={"cls": "Adam", "kw": {"lr": LR}})
    cases = [dict(lm, restore=jax_ckpts["tp"]["path"]),
             dict(lm, steps=STEPS, save_dir=save_tp, more=STEPS),
             dict(lm, restore=os.path.join(save_tp, "ckpt-%d" % STEPS),
                  batches=batches[STEPS:], steps=STEPS),
             dict(zero, steps=STEPS, save_dir=save_zero),
             dict(zero, restore=jax_ckpts["zero"]["path"])]
    ranks = launch("sharded", 2, tmp_path_factory.mktemp("sharded"), cases)
    return {"ranks": ranks, "tp_dir": save_tp, "zero_dir": save_zero}


def _port_tp1(flat, batch):
    ad = adt.AutoDist(strategy_builder=strategy.TensorParallel(
        1, tp_lm.tp_rules()), device="cpu")
    params = convert.jax_named({n: torch.as_tensor(v)
                                for n, v in flat.items()})
    runner = ad.build(tp_lm.make_loss(tp_lm.TPLMConfig.tiny()),
                      functools.partial(torch.optim.Adam, lr=LR), params,
                      batch)
    runner.init(params)
    return runner


def _port_state(runner):
    dstep = runner.distributed_step
    item = dstep.model_item
    opt = dstep.gather_opt_state(runner.state)
    return {"params": {n: t.numpy().copy() for n, t in
                       runner.gather_params().items()},
            "opt_jax": convert.opt_state_to_jax(
                opt, item.flax_shapes, item.optimizer_spec,
                item.jax_names)}


# ----------------------------------------------------- JAX -> the port


def test_jax_tp2_save_restores_in_the_port_at_tp2_and_tp1(jax_ckpts,
                                                         port_runs):
    """The JAX package's tp 2 save (its {data: 4, model: 2} mesh)
    restores in the port at tp 2 on two ranks, each reading the slices
    its rank holds, and at tp 1 in one process: params and both Adam
    moments bit-equal to the JAX runner's gathered state."""
    want = jax_ckpts["tp"]["state"]
    for rank in port_runs["ranks"]:
        case = rank[0]
        assert case["restored_step"] == STEPS
        _same(case["restored"]["params"], want["params"], "params")
        _same(case["restored"]["opt_jax"], want["opt_jax"], "opt")
        shapes = case["local_shapes"]
        assert shapes["embed"] == (32, 32)  # this rank's vocab half
    _, _, batches, flat = _lm()
    runner = _port_tp1(flat, batches[0])
    _, step = ShardedSaver(os.path.dirname(
        jax_ckpts["tp"]["path"])).restore(runner)
    assert step == STEPS
    got = _port_state(runner)
    _same(got["params"], want["params"], "params")
    _same(got["opt_jax"], want["opt_jax"], "opt")


def test_jax_zero_save_restores_in_the_port_at_two_ranks(jax_ckpts,
                                                         port_runs):
    """The JAX ZeroSharded save of 8 devices restores at N = 2: its ZeRO
    rows re-laid for two ranks, bit-equal."""
    want = jax_ckpts["zero"]["state"]
    for rank in port_runs["ranks"]:
        case = rank[4]
        _same(case["restored"]["params"], want["params"], "params")
        _same(case["restored"]["opt_jax"], want["opt_jax"], "opt")


# ----------------------------------------------------- the port -> JAX


def test_port_tp2_save_is_per_rank_and_restores_everywhere(port_runs):
    """The port's tp 2 save: each rank's file holds its own slices (the
    model-parallel variables' halves, the replicated leaves once, on
    rank 0); the JAX package restores it on its mesh, the port at tp 1
    and back at tp 2, all bit-equal to the state at the save; the steps
    after the tp 2 restore repeat the uninterrupted run's losses."""
    ranks = port_runs["ranks"]
    at_save = ranks[0][1]["at_save"]
    for rank in ranks:
        _same(rank[1]["at_save"]["params"], at_save["params"], "ranks")
        assert rank[2]["restored_step"] == STEPS
        _same(rank[2]["restored"]["params"], at_save["params"], "params")
        _same(rank[2]["restored"]["opt_jax"], at_save["opt_jax"], "opt")
        assert rank[2]["losses"] == rank[1]["more"]
    base = ranks[0][1]["saved"]
    with open(base + ".shard-meta.json") as f:
        meta = json.load(f)
    assert meta["mesh"] == {"axes": ["data", "model"], "shape": [1, 2]}
    assert meta["process_count"] == 2
    assert meta["leaves"]["P|embed"]["spec"] == ["model"]
    owners = {}
    for key, pid in meta["keys"].items():
        owners.setdefault(key.split("|")[1], set()).add(pid)
    assert owners["embed"] == {0, 1}           # a half each
    assert owners["final_ln/scale"] == {0}     # replicated: written once
    assert "P|embed|0:32,0:32" in meta["keys"] and \
        "P|embed|32:64,0:32" in meta["keys"]
    # the JAX package restores it on its {data: 4, model: 2} mesh
    _, params, batches, flat = _lm()
    jrunner = _jax_runner("tp", params, batches[0])
    _, step = JSharded(port_runs["tp_dir"]).restore(jrunner)
    assert step == STEPS
    got = _jax_state(jrunner)
    _same(got["params"], at_save["params"], "jax params")
    _same(got["opt_jax"], at_save["opt_jax"], "jax opt")
    # and the port at tp 1, one process
    runner = _port_tp1(flat, batches[0])
    ShardedSaver(port_runs["tp_dir"]).restore(runner)
    got = _port_state(runner)
    _same(got["params"], at_save["params"], "tp1 params")
    _same(got["opt_jax"], at_save["opt_jax"], "tp1 opt")


def test_port_zero_save_restores_in_jax(port_runs):
    """The port's ZeroSharded N = 2 save: each rank writes its ZeRO rows
    (``S|zero/...`` with the rank's token); the JAX package restores it
    on 8 devices, re-laying the rows, bit-equal."""
    ranks = port_runs["ranks"]
    at_save = ranks[0][3]["at_save"]
    base = ranks[0][3]["saved"]
    with open(base + ".shard-meta.json") as f:
        meta = json.load(f)
    zero_keys = [k for k in meta["keys"] if k.startswith("S|zero/")]
    assert zero_keys and {meta["keys"][k] for k in zero_keys} == {0, 1}
    big, batches = _big()
    jrunner = _jax_runner("zero", big, batches[0])
    JSharded(port_runs["zero_dir"]).restore(jrunner)
    got = _jax_state(jrunner)
    _same(got["params"], at_save["params"], "params")
    _same(got["opt_jax"], at_save["opt_jax"], "opt")


# ----------------------------------------------------------- host PS


@pytest.mark.parametrize("save_b,restore_b", [
    ("PartitionedPS", "PartitionedPS"), ("Parallax", "Parallax"),
    ("PartitionedPS", "PS")], ids=["partitioned_ps", "parallax",
                                   "partitioned_to_unpartitioned"])
def test_host_ps_shards_round_trip(tmp_path, save_b, restore_b):
    """The store's shards save as ``H|``/``Ho|`` keys in the JAX layout
    (the chief writes every pair in mirror mode) and reload bit-equal;
    under another shard layout the saved shards are re-sliced."""
    loss_fn, params, batch, _ = tower_setup(True, 16, vocab=40)
    rng = np.random.RandomState(1)
    batches = [dict(batch, ids=rng.randint(0, 40, (16,)).astype(np.int32))
               for _ in range(4)]

    def build(name):
        adt.reset()
        ad = adt.AutoDist(strategy_builder=getattr(strategy, name)(),
                          device="cpu")
        r = ad.build(loss_fn, functools.partial(torch.optim.Adam, lr=0.01),
                     params, batch)
        r.init(params)
        return r
    runner = build(save_b)
    assert runner.distributed_step.ps_store is not None
    for b in batches[:2]:
        runner.run(b)
    saver = ShardedSaver(str(tmp_path))
    base = saver.save(runner)
    want = _port_state(runner)
    after = [float(runner.run(b)["loss"]) for b in batches[2:]]
    with open(base + ".shard-meta.json") as f:
        meta = json.load(f)
    assert meta["ps"] and any(k.startswith("H|") for k in meta["keys"])
    assert any(k.startswith("Ho|") for k in meta["keys"])
    runner = build(restore_b) if restore_b != save_b else runner
    _, step = saver.restore(runner)
    assert step == 2
    got = _port_state(runner)
    _same(got["params"], want["params"], "params")
    _same(got["opt_jax"], want["opt_jax"], "opt")
    assert [float(runner.run(b)["loss"]) for b in batches[2:]] == after


def test_between_graph_keys_round_trip(tmp_path, monkeypatch):
    """A job whose processes each run their own replica (async PS) writes
    device keys suffixed ``@p<pid>``; each process restores its own, and
    the chief commits once every process's index landed. The two
    processes run here one after the other (``ADT_NUM_PROCESSES=2``,
    ``ADT_PROCESS_ID``)."""
    rng = np.random.RandomState(0)
    params = convert.jax_named({
        "w": torch.from_numpy(rng.randn(4, 2).astype(np.float32)),
        "b": torch.zeros((2,))})
    batches = [{"x": rng.randn(16, 4).astype(np.float32),
                "y": rng.randn(16, 2).astype(np.float32)}
               for _ in range(3)]
    monkeypatch.setenv("ADT_NUM_PROCESSES", "2")
    saved, ends = {}, {}
    for pid in (1, 0):   # the chief last: it waits for p1's index
        monkeypatch.setenv("ADT_PROCESS_ID", str(pid))
        adt.reset()
        ad = adt.AutoDist(strategy_builder=strategy.AllReduce(),
                          device="cpu")
        runner = ad.build(lin_loss, functools.partial(torch.optim.Adam,
                                                      lr=0.1 * (pid + 1)),
                          params, batches[0])
        runner.init(params)
        for b in batches[:2]:
            runner.run(b)
        ShardedSaver(str(tmp_path)).save(runner)
        saved[pid] = _port_state(runner)
        runner.run(batches[2])
        ends[pid] = runner
    with open(str(tmp_path / "ckpt-2.shard-meta.json")) as f:
        meta = json.load(f)
    assert meta["process_count"] == 2
    assert "P|w|0:4,0:2@p1" in meta["keys"] and "P|w|0:4,0:2@p0" in \
        meta["keys"]
    assert meta["keys"]["P|w|0:4,0:2@p1"] == 1
    for pid in (0, 1):
        monkeypatch.setenv("ADT_PROCESS_ID", str(pid))
        ShardedSaver(str(tmp_path)).restore(ends[pid])
        _same(_port_state(ends[pid])["params"], saved[pid]["params"],
              "p%d" % pid)
    assert not np.array_equal(saved[0]["params"]["w"],
                              saved[1]["params"]["w"])


# -------------------------------------------------------------- export


def _members(path):
    with zipfile.ZipFile(path) as z:
        return [(i.filename, z.read(i.filename)) for i in z.infolist()]


@pytest.mark.parametrize("which", ["jax", "port"])
def test_export_full_matches_the_jax_export(jax_ckpts, port_runs, tmp_path,
                                            which):
    """``export_full`` of one sharded checkpoint (the JAX package's tp 2
    save, or the port's) by both packages: the same members in the same
    order, byte for byte, and the same meta."""
    src = (jax_ckpts["tp"]["path"] if which == "jax"
           else os.path.join(port_runs["tp_dir"], "ckpt-%d" % STEPS))
    d = os.path.dirname(src)
    a = ShardedSaver(d).export_full(src, out_dir=str(tmp_path / "port"))
    b = JSharded(d).export_full(src, out_dir=str(tmp_path / "jax"))
    for suffix in (".params.npz", ".opt.npz"):
        assert _members(a + suffix) == _members(b + suffix)
    with open(a + ".meta.json") as f, open(b + ".meta.json") as g:
        assert json.load(f) == json.load(g)
    assert not os.path.exists(a + ".sync.npz") or \
        _members(a + ".sync.npz") == _members(b + ".sync.npz")


# ---------------------------------------------------- damage + fallback


_TORN = r'''
import functools, json, os, sys
import numpy as np, torch
sys.path.insert(0, sys.argv[1]); sys.path.insert(0, sys.argv[2])
torch.set_num_threads(1)
import autodist_tpu_torch as adt
from autodist_tpu_torch import convert, strategy
from autodist_tpu_torch.checkpoint import ShardedSaver
from torch_dist_worker import lin_loss
rng = np.random.RandomState(0)
params = convert.jax_named({
    "w": torch.from_numpy(rng.randn(4, 2).astype(np.float32)),
    "b": torch.zeros((2,))})
batch = {"x": rng.randn(16, 4).astype(np.float32),
         "y": rng.randn(16, 2).astype(np.float32)}
ad = adt.AutoDist(strategy_builder=strategy.AllReduce(), device="cpu")
runner = ad.build(lin_loss, functools.partial(torch.optim.Adam, lr=0.1),
                  params, batch)
runner.init(params)
saver = ShardedSaver(sys.argv[3])
for _ in range(2):
    runner.run(batch)
    saver.save(runner)
print("not killed")
'''


def _lin_runner():
    rng = np.random.RandomState(0)
    params = convert.jax_named({
        "w": torch.from_numpy(rng.randn(4, 2).astype(np.float32)),
        "b": torch.zeros((2,))})
    batch = {"x": rng.randn(16, 4).astype(np.float32),
             "y": rng.randn(16, 2).astype(np.float32)}
    ad = adt.AutoDist(strategy_builder=strategy.AllReduce(), device="cpu")
    runner = ad.build(lin_loss, functools.partial(torch.optim.Adam, lr=0.1),
                      params, batch)
    runner.init(params)
    return runner, batch


def test_a_torn_save_falls_back_to_the_older_step(tmp_path):
    """A kill at the ``index`` phase of the second save (the shard file
    in place, no index, no meta): ``latest()`` and the restore skip the
    torn step, fsck reports it, and ``ls`` lists both."""
    script = tmp_path / "torn.py"
    script.write_text(_TORN)
    ckpt = tmp_path / "ckpt"
    env = dict(os.environ, ADT_CKPT_FAULT_PLAN=json.dumps(
        {"kills": [{"phase": "index", "nth": 2}]}))
    proc = subprocess.run([sys.executable, str(script), REPO,
                           os.path.join(REPO, "tests"), str(ckpt)],
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0 and "not killed" not in proc.stdout
    assert (ckpt / "ckpt-2.shard-p0.npz").exists()
    assert not (ckpt / "ckpt-2.shard-meta.json").exists()
    saver = ShardedSaver(str(ckpt))
    assert saver.latest().endswith("ckpt-1")
    runner, _ = _lin_runner()
    tel.reset()
    _, step = saver.restore(runner)
    assert step == 1 and tel.counters()["ckpt.fallback"] >= 1
    statuses = {s.step: s for s in integrity.scan(str(ckpt), "sharded")}
    assert statuses[2].state == integrity.TORN
    assert cli_main(["--dir", str(ckpt), "ls"]) == 0


def test_a_bitflipped_shard_falls_back_to_the_older_step(tmp_path,
                                                          monkeypatch,
                                                          capsys):
    """A bit flipped in the newest step's shard after its commit: fsck
    finds it (the index's crc32s), and the restore falls back to the
    step before; ``ls`` and ``fsck`` over the port-written directory."""
    monkeypatch.setenv("ADT_CKPT_FAULT_PLAN", json.dumps(
        {"damage": [{"op": "bitflip", "phase": "committed",
                     "file": "shard-p0.npz", "nth": 2}]}))
    runner, batch = _lin_runner()
    saver = ShardedSaver(str(tmp_path))
    for _ in range(2):
        runner.run(batch)
        saver.save(runner)
    monkeypatch.delenv("ADT_CKPT_FAULT_PLAN")
    tel.reset()
    _, step = saver.restore(runner)
    assert step == 1
    assert tel.counters()["ckpt.fallback"] >= 1
    assert cli_main(["--dir", str(tmp_path), "ls"]) == 0
    out = capsys.readouterr().out
    assert "sharded" in out
    assert cli_main(["--dir", str(tmp_path), "fsck"]) != 0
    assert "corrupt" in capsys.readouterr().out


def test_same_topology_restore_reads_only_this_ranks_keys(tmp_path):
    """At the save's topology each leaf is one saved slice, read by its
    key: the meta's keys are the ones the plan derives, and a restore
    reads them back bit-equal (one process, a partitioned-free plan)."""
    runner, batch = _lin_runner()
    runner.run(batch)
    saver = ShardedSaver(str(tmp_path))
    base = saver.save(runner)
    want = _port_state(runner)
    runner.run(batch)
    with open(base + ".shard-meta.json") as f:
        meta = json.load(f)
    assert sorted(meta["keys"]) == ["O|0/count|-", "O|0/mu/b|0:2",
                                    "O|0/mu/w|0:4,0:2", "O|0/nu/b|0:2",
                                    "O|0/nu/w|0:4,0:2", "P|b|0:2",
                                    "P|w|0:4,0:2"]
    saver.restore(runner)
    got = _port_state(runner)
    _same(got["params"], want["params"], "params")
    _same(got["opt_jax"], want["opt_jax"], "opt")
