"""autodist_tpu_torch's training health sentinel against the JAX package's.

The JAX ``tests/test_sentinel.py`` cases on the port: each runs the JAX
runner (the session's 8 virtual CPU devices) and the port (one process,
or two gloo ranks from ``tests/torch_dist_worker.py``'s ``sentinel``
job) on the same problem under the same ``ADT_GRAD_FAULT_PLAN``, and
holds the port's losses to the JAX runner's (1e-5; the same linear
problem, Adam 0.1 or SGD) and its verdicts, skips, rollbacks and LR
scales to the JAX sentinel's exactly.

Cases: the clean path (guarded bit-equal to unguarded, no extra
dispatch or readback); a transient NaN skipped inside the step and the
run converging (AllReduce and host PS, the push suppressed); the same
plan without the sentinel poisoning the run; the grad-norm limit and a
bit flip; the global grad norm under partitioned, ZeRO and
model-parallel storage at N = 2 equal to the replicated one (and to the
JAX runner's); fused k = 4 supersteps giving the verdicts ``[1, 1, 0,
1]`` (AllReduce and PS); a sustained NaN rolling back and completing; an
unbounded one halving the LR and ending in ``TrainingDiverged``; a
rollback with nothing to restore; LR halving equal to ``sgd(lr / 2)``;
the quarantine veto and the ``healthy`` stamp (plain and sharded
savers, healthy-unknown, the CLI column); the LR scale re-synced on
restore; the policy's resolution, the EWMA spike detector, the loss-only
mode, unknown fault fields and ADT420/421.
"""
import dataclasses
import functools
import itertools
import json

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import autodist_tpu as jadt
import autodist_tpu_torch as adt
from autodist_tpu import strategy as JS
from autodist_tpu.runtime.sentinel import SentinelPolicy as JPolicy
from autodist_tpu_torch import strategy as S
from autodist_tpu_torch.checkpoint import Saver, ShardedSaver, integrity
from autodist_tpu_torch.runtime.faultinject import GradFaultPlan
from autodist_tpu_torch.runtime.sentinel import (Sentinel, SentinelPolicy,
                                                 TrainingDiverged,
                                                 resolve_policy)
from autodist_tpu_torch.telemetry import spans as tel
from torch_dist_worker import launch, lin_loss


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


def _problem(seed=0):
    rng = np.random.RandomState(seed)
    params = {"w": rng.randn(4, 2).astype(np.float32),
              "b": np.zeros((2,), np.float32)}
    batch = {"x": rng.randn(16, 4).astype(np.float32),
             "y": rng.randn(16, 2).astype(np.float32)}
    return params, batch


def _jax_loss(p, b):
    return jnp.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)


_PORT_BUILDERS = {"AllReduce": S.AllReduce, "PS": S.PS,
                  "PartitionedAR": S.PartitionedAR}
_JAX_BUILDERS = {"AllReduce": JS.AllReduce, "PS": JS.PS,
                 "PartitionedAR": JS.PartitionedAR}


def _build(name="AllReduce", sentinel=None, lr=0.1, sgd=False):
    params, batch = _problem()
    adt.reset()
    ad = adt.AutoDist(strategy_builder=_PORT_BUILDERS[name](), device="cpu")
    opt = functools.partial(torch.optim.SGD if sgd else torch.optim.Adam,
                            lr=lr)
    runner = ad.build(lin_loss, opt,
                      {n: torch.as_tensor(v) for n, v in params.items()},
                      batch, sentinel=sentinel)
    runner.init({n: torch.as_tensor(v) for n, v in params.items()})
    return runner


def _jax_build(name="AllReduce", sentinel=None, lr=0.1, one_device=False):
    """The JAX runner on the session's 8 devices, or on one
    (``one_device``: where a fault depends on each device's LOCAL
    gradient, as a bit flip does, one device has the port's gradient)."""
    from autodist_tpu.resource_spec import ResourceSpec as JSpec
    params, batch = _problem()
    if isinstance(sentinel, SentinelPolicy):
        sentinel = JPolicy(**dataclasses.asdict(sentinel))
    jadt.reset()
    spec = JSpec.from_dict({"nodes": [{"address": "127.0.0.1",
                                       "chief": True, "cpus": [0]}]}) \
        if one_device else None
    ad = jadt.AutoDist(strategy_builder=_JAX_BUILDERS[name](),
                       resource_spec=spec)
    runner = ad.build(_jax_loss, optax.adam(lr),
                      {n: jnp.asarray(v) for n, v in params.items()},
                      batch, sentinel=sentinel)
    runner.init({n: jnp.asarray(v) for n, v in params.items()})
    return runner


def _train(runner, steps):
    _, batch = _problem()
    return [float(runner.run(batch)["loss"]) for _ in range(steps)]


def _set_plan(monkeypatch, faults):
    monkeypatch.setenv("ADT_GRAD_FAULT_PLAN", json.dumps({"faults": faults}))


def _params(runner):
    return {n: t.detach().numpy().copy()
            for n, t in runner.gather_params().items()}


# ------------------------------------------------------------ clean path


def test_clean_path_zero_overhead_and_parity():
    """The guards are free on a healthy run: the same numbers bit for
    bit, the same dispatches, the same readbacks (the verdict rides the
    metrics), and the JAX guarded runner's losses."""
    plain = _build()
    losses_plain = _train(plain, 6)
    d_plain, rb_plain = plain.distributed_step.dispatches, plain.readbacks
    p_plain = _params(plain)
    guarded = _build(sentinel=True)
    losses = _train(guarded, 6)
    assert losses == losses_plain
    assert guarded.distributed_step.dispatches == d_plain
    assert guarded.readbacks == rb_plain
    for n, want in p_plain.items():
        np.testing.assert_array_equal(_params(guarded)[n], want)
    stats = guarded.step_stats()["sentinel"]
    assert stats["skips"] == 0 and stats["rollbacks"] == 0
    assert stats["last_grad_norm"] is not None
    assert stats["quarantined"] is False
    assert guarded.distributed_step.metadata["sentinel_guards"] is True
    assert plain.step_stats()["sentinel"]["last_grad_norm"] is None
    jax_losses = _train(_jax_build(sentinel=True), 6)
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-5, atol=1e-6)


# ------------------------------------------------- transient faults


@pytest.mark.parametrize("name", ["AllReduce", "PS"])
def test_transient_nan_skipped_and_converges(monkeypatch, name):
    """A NaN gradient at step 3 is discarded inside the step (params kept,
    the PS push suppressed); the run converges to the fault-free loss,
    and every loss equals the JAX runner's under the same plan."""
    clean = _train(_build(name), 30)
    _set_plan(monkeypatch, [{"var": "w", "mode": "nan", "step": 3}])
    tel.reset()
    runner = _build(name, sentinel=True)
    losses = _train(runner, 30)
    assert all(np.isfinite(losses))
    assert losses[4] == losses[3]
    assert runner.step_stats()["sentinel"]["skips"] == 1
    c = tel.counters()
    assert c["sentinel.skips"] == 1 and c["sentinel.nan_steps"] == 1
    assert losses[-1] == pytest.approx(clean[-1], rel=0.15)
    if name == "PS":
        assert c["sentinel.ps_suppressed"] >= 1
    jrunner = _jax_build(name, sentinel=True)
    np.testing.assert_allclose(losses, _train(jrunner, 30), rtol=1e-5,
                               atol=1e-6)
    assert jrunner.step_stats()["sentinel"]["skips"] == 1


def test_sentinel_disabled_same_plan_corrupts(monkeypatch):
    """Without the sentinel the same plan poisons the run."""
    _set_plan(monkeypatch, [{"var": "w", "mode": "nan", "step": 3}])
    assert not np.isfinite(_train(_build(), 8)[-1])


@pytest.mark.parametrize("fault", [
    {"var": "w", "mode": "scale", "step": 2, "factor": 1e6},
    {"var": "w", "mode": "bitflip", "step": 2, "bit": 30, "index": 1}],
    ids=["scale", "bitflip"])
def test_finite_faults_trip_the_grad_norm_limit(monkeypatch, fault):
    """A scale spike (finite) passes the NaN guards but trips the grad-norm
    limit; a flipped exponent bit (an element below 2: the flip blows it
    up) is caught too; ``nan_steps`` counts only nonfinite faults; two
    runs inject identically; the JAX runner on one device (the bit flip
    hits each device's local gradient) skips the same step with the same
    losses."""
    _set_plan(monkeypatch, [fault])
    policy = SentinelPolicy(grad_norm_limit=100.0)
    runs = []
    for _ in range(2):
        tel.reset()
        runner = _build(sentinel=policy)
        runs.append(_train(runner, 8))
        assert runner.step_stats()["sentinel"]["skips"] == 1
    assert runs[0] == runs[1] and all(np.isfinite(runs[0]))
    assert runs[0][3] == runs[0][2]
    if fault["mode"] == "scale":
        assert tel.counters().get("sentinel.nan_steps", 0) == 0
    jrunner = _jax_build(sentinel=SentinelPolicy(grad_norm_limit=100.0),
                         one_device=True)
    np.testing.assert_allclose(runs[0], _train(jrunner, 8), rtol=1e-5,
                               atol=1e-6)
    assert jrunner.step_stats()["sentinel"]["skips"] == 1


# ------------------------------------------------- sharded storage norm


def _big_problem():
    rng = np.random.RandomState(0)
    params = {"big": rng.randn(64, 8).astype(np.float32),
              "w": rng.randn(8, 2).astype(np.float32)}
    batch = {"x": rng.randn(16, 64).astype(np.float32),
             "y": rng.randn(16, 2).astype(np.float32)}
    return params, batch


def _mlp_problem():
    rng = np.random.RandomState(0)
    params = {"fc1/w": (rng.standard_normal((8, 16)) * 0.3).astype(
        np.float32), "fc1/b": np.zeros((16,), np.float32),
        "fc2/w": (rng.standard_normal((16, 4)) * 0.3).astype(np.float32),
        "fc2/b": np.zeros((4,), np.float32)}
    batch = {"x": rng.standard_normal((8, 8)).astype(np.float32),
             "y": rng.standard_normal((8, 4)).astype(np.float32)}
    return params, batch


@pytest.fixture(scope="module")
def sharded_norms(tmp_path_factory):
    """Two ranks: the first step's verdict of the big problem under
    AllReduce, PartitionedAR and ZeroSharded, and of the MLP under
    AllReduce and TensorParallel(2); plus a NaN at step 1 under
    PartitionedAR."""
    big, bbatch = _big_problem()
    mlp, mbatch = _mlp_problem()
    sgd = {"cls": "SGD", "kw": {"lr": 0.01}}
    cases = [dict(loss="big", init=big, batches=[bbatch] * 2, sentinel=True,
                  optimizer=sgd, builder=b)
             for b in ("AllReduce", "PartitionedAR", "ZeroSharded")]
    cases += [dict(loss="mlp", init=mlp, batches=[mbatch] * 2,
                   sentinel=True, optimizer=sgd, builder="AllReduce"),
              dict(loss="mlp", init=mlp, batches=[mbatch] * 2,
                   sentinel=True, optimizer=sgd, tp=2),
              dict(loss="big", init=big, batches=[bbatch] * 3,
                   sentinel=True, optimizer=sgd, builder="PartitionedAR",
                   plan=[{"var": "big", "mode": "nan", "step": 1}])]
    return launch("sentinel", 2, tmp_path_factory.mktemp("sentinel"), cases)


def test_sharded_storage_grad_norm_is_exact(sharded_norms):
    """Partitioned, ZeRO and model-parallel storage at N = 2 report the
    replicated storage's global grad norm (``local * S/N`` through one
    stacked all-reduce), on both ranks, and the JAX runner's."""
    for rank in sharded_norms:
        repl, part, zero, mlp_repl, mlp_tp, _ = rank
        assert "big" in part["metadata"]["partitioned"]
        assert zero["metadata"]["zero_sharded"]
        assert mlp_tp["metadata"]["model_parallel"]
        norm = repl["verdicts"][0]["grad_norm"]
        for other in (part, zero):
            np.testing.assert_allclose(other["verdicts"][0]["grad_norm"],
                                       norm, rtol=1e-6)
        np.testing.assert_allclose(mlp_tp["verdicts"][0]["grad_norm"],
                                   mlp_repl["verdicts"][0]["grad_norm"],
                                   rtol=1e-5)
        for r in rank[:5]:
            assert r["verdicts"][0]["ok"] == 1 and r["ranks_equal"]
    params, batch = _big_problem()
    jadt.reset()

    def loss_fn(p, b):
        return jnp.mean(((b["x"] @ p["big"]) @ p["w"] - b["y"]) ** 2)
    ad = jadt.AutoDist(strategy_builder=JS.PartitionedAR())
    jr = ad.build(loss_fn, optax.sgd(0.01), params, batch, sentinel=True)
    jr.init(params)
    jnorm = float(jr.run(batch)["sentinel"]["grad_norm"])
    np.testing.assert_allclose(sharded_norms[0][1]["verdicts"][0][
        "grad_norm"], jnorm, rtol=1e-5)


def test_nan_on_a_partitioned_variable_is_skipped_on_every_rank(
        sharded_norms):
    """The NaN in one rank's shard reaches every rank's verdict through the
    stacked all-reduce: both ranks skip step 1 and keep their params
    bit-equal."""
    for rank in sharded_norms:
        case = rank[5]
        assert [v["ok"] for v in case["verdicts"]] == [1, 0, 1]
        assert case["losses"][2] == case["losses"][1]
        assert case["ranks_equal"]
        assert case["verdicts"][1]["bad_grads"] > 0


# -------------------------------------------------- fused parity (k=4)


@pytest.mark.parametrize("name", ["AllReduce", "PS"])
def test_fused_guarded_parity_and_microstep_verdict(monkeypatch, name):
    """Fused k = 4 under the guards: the stacked verdicts are [1, 1, 0, 1]
    (exactly the faulted microstep), and the losses, params and
    optimizer state equal the guarded per-step loop's and the JAX
    runner's."""
    _set_plan(monkeypatch, [{"var": "w", "mode": "nan", "step": 2}])
    _, batch = _problem()
    stack = {k: np.stack([v] * 4) for k, v in batch.items()}
    per_step = _build(name, sentinel=True)
    step_losses = _train(per_step, 4)
    per_step.distributed_step.flush_ps()
    p_ref = _params(per_step)
    skips_ref = per_step.step_stats()["sentinel"]["skips"]
    fused = _build(name, sentinel=True)
    handle = fused.run_superstep(stack)
    oks = [int(m["sentinel"]["ok"]) for m in handle.unstack()]
    assert oks == [1, 1, 0, 1]
    fused_losses = [float(x) for x in np.asarray(handle["loss"])]
    assert fused_losses == step_losses
    for n, want in p_ref.items():
        np.testing.assert_array_equal(_params(fused)[n], want)
    assert fused.step_stats()["sentinel"]["skips"] == skips_ref == 1
    jrunner = _jax_build(name, sentinel=True)
    np.testing.assert_allclose(fused_losses, _train(jrunner, 4), rtol=1e-5,
                               atol=1e-6)


# --------------------------------------------------- the rollback ladder


def _fit(runner, steps, tmp_path):
    _, batch = _problem()
    saver = Saver(directory=str(tmp_path), max_to_keep=10)
    return runner.fit(itertools.repeat(batch), steps=steps, save_every=2,
                      saver=saver)


def _jax_fit(runner, steps, tmp_path):
    from autodist_tpu.checkpoint.saver import Saver as JSaver
    _, batch = _problem()
    saver = JSaver(directory=str(tmp_path), max_to_keep=10)
    return runner.fit(itertools.repeat(batch), steps=steps, save_every=2,
                      saver=saver)


def test_sustained_corruption_rolls_back_and_completes(monkeypatch,
                                                       tmp_path):
    """A bounded sustained NaN window exhausts the skip budget, the run
    rolls back to the newest healthy checkpoint, the widened budget
    skips through the window on replay, and the run completes — with the
    JAX sentinel's rollbacks, skips and losses."""
    _set_plan(monkeypatch, [{"var": "w", "mode": "nan", "step": 4,
                             "until": 6}])
    policy = SentinelPolicy(max_skips_per_window=2, window_steps=50)
    tel.reset()
    runner = _build(sentinel=policy)
    history = _fit(runner, 16, tmp_path / "port")
    stats = runner.step_stats()["sentinel"]
    assert len(history) == 16
    assert stats["rollbacks"] == 1 and stats["skips"] == 6
    c = tel.counters()
    assert c["sentinel.rollbacks"] == 1 and c["ckpt.restores"] >= 1
    losses = [float(m["loss"]) for m in history]
    assert np.isfinite(losses[-1]) and losses[-1] < losses[0]
    jrunner = _jax_build(sentinel=SentinelPolicy(max_skips_per_window=2,
                                                 window_steps=50))
    jhist = _jax_fit(jrunner, 16, tmp_path / "jax")
    jstats = jrunner.step_stats()["sentinel"]
    assert (jstats["rollbacks"], jstats["skips"]) == (1, 6)
    jl = [float(m["loss"]) for m in jhist]
    assert [np.isfinite(x) for x in losses] == [np.isfinite(x) for x in jl]
    np.testing.assert_allclose(losses, jl, rtol=1e-5, atol=1e-6)


def test_unbounded_corruption_escalates_to_typed_failure(monkeypatch,
                                                         tmp_path):
    """An unbounded fault defeats the widened budget and the LR halving:
    after ``max_rollbacks_per_step`` rollbacks the run fails with
    ``TrainingDiverged``; the second rollback to the same step halved the
    LR (the state's scale, the sentinel's and the ladder's counter), as
    in the JAX sentinel."""
    _set_plan(monkeypatch, [{"var": "w", "mode": "nan", "step": 4,
                             "until": 100000}])

    def policy():
        return SentinelPolicy(max_skips_per_window=1, window_steps=50,
                              max_rollbacks_per_step=2)
    tel.reset()
    runner = _build(sentinel=policy())
    with pytest.raises(TrainingDiverged, match="escalation ladder"):
        _fit(runner, 64, tmp_path / "port")
    assert runner.step_stats()["sentinel"]["rollbacks"] == 2
    assert runner.sentinel.lr_scale == 0.5
    assert float(runner.state.sync_state["sentinel"]["lr_scale"]) == 0.5
    assert tel.counters()["sentinel.lr_halvings"] == 1
    jrunner = _jax_build(sentinel=policy())
    with pytest.raises(Exception, match="escalation ladder"):
        _jax_fit(jrunner, 64, tmp_path / "jax")
    assert jrunner.step_stats()["sentinel"]["rollbacks"] == 2
    assert jrunner.sentinel.lr_scale == 0.5
    assert (runner.sentinel.skips, runner.sentinel.lr_halvings) == \
        (jrunner.sentinel.skips, jrunner.sentinel.lr_halvings)


def test_rollback_without_checkpoints_is_typed(monkeypatch, tmp_path):
    """A rollback with nothing to restore fails with the typed error that
    names the fix."""
    monkeypatch.setenv("ADT_CKPT_DIR", str(tmp_path))
    _set_plan(monkeypatch, [{"var": "w", "mode": "nan", "step": 1,
                             "until": 100000}])
    runner = _build(sentinel=SentinelPolicy(max_skips_per_window=1,
                                            window_steps=50))
    with pytest.raises(TrainingDiverged, match="no healthy committed"):
        _train(runner, 10)


def test_lr_halving_scales_updates_exactly():
    """Halving the scale halves the applied update: sgd(0.1) at scale 0.5
    equals sgd(0.05), with no rebuild (one dispatch a step)."""
    params, batch = _problem()
    tensors = {n: torch.as_tensor(v) for n, v in params.items()}
    ad = adt.AutoDist(strategy_builder=S.AllReduce(), device="cpu")

    def make(lr):
        r = ad.build(lin_loss, functools.partial(torch.optim.SGD, lr=lr),
                     tensors, batch, sentinel=True)
        r.init(tensors)
        return r
    runner, ref = make(0.1), make(0.05)
    Sentinel(SentinelPolicy(), runner)._halve_lr()
    d = runner.distributed_step.dispatches
    _train(runner, 1)
    assert runner.distributed_step.dispatches == d + 1
    _train(ref, 1)
    for n, want in _params(ref).items():
        np.testing.assert_allclose(_params(runner)[n], want, rtol=1e-6)


# ------------------------------------------- quarantine + healthy stamp


def test_quarantine_vetoes_saves_and_stamps(monkeypatch, tmp_path):
    """While the verdict is bad, saves are vetoed (quarantine on) or
    stamped unhealthy (off); automatic restores skip the unhealthy stamp,
    an explicit path overrides it."""
    _set_plan(monkeypatch, [{"var": "w", "mode": "nan", "step": 2,
                             "until": 100000}])
    tel.reset()
    runner = _build(sentinel=SentinelPolicy(max_skips_per_window=100,
                                            window_steps=10))
    saver = Saver(directory=str(tmp_path))
    _train(runner, 2)
    assert saver.save(runner) is not None
    healthy_base = saver.latest()
    _train(runner, 2)
    assert runner.sentinel_save_veto()
    assert saver.save(runner) is None
    assert tel.counters()["sentinel.save_vetoes"] == 1
    runner.sentinel.policy.quarantine = False
    assert not runner.sentinel_save_veto()
    bad_base = saver.save(runner)
    assert bad_base is not None and bad_base != healthy_base
    status = integrity.validate_plain(*integrity.parse_base(bad_base))
    assert status.committed and status.healthy is False
    assert integrity.validate_plain(
        *integrity.parse_base(healthy_base)).healthy is True
    assert saver.latest() == healthy_base
    _, step = saver.restore(runner)
    assert step == int(healthy_base.rsplit("ckpt-", 1)[1])
    assert tel.counters()["ckpt.unhealthy_skipped"] >= 2
    _, step = saver.restore(runner, path=bad_base)
    assert step == int(bad_base.rsplit("ckpt-", 1)[1])


@pytest.mark.parametrize("fmt", ["plain", "sharded"])
def test_prestamp_and_unhealthy_stamps(tmp_path, fmt):
    """Both savers stamp ``healthy``; a checkpoint whose meta predates the
    stamp is healthy-unknown (resumable), and one stamped false is
    skipped by ``latest()``, restore and ``latest_checkpoint`` — which
    the JAX package's ``latest_checkpoint`` and CLI read the same way."""
    from autodist_tpu.checkpoint import latest_checkpoint as jlatest
    from autodist_tpu_torch.checkpoint import latest_checkpoint
    tel.reset()
    runner = _build(sentinel=True)
    saver = (Saver if fmt == "plain" else ShardedSaver)(
        directory=str(tmp_path))
    meta_suffix = ".meta.json" if fmt == "plain" else ".shard-meta.json"
    validate = getattr(integrity, "validate_" + fmt)
    _train(runner, 1)
    base1 = saver.save(runner)
    _train(runner, 1)
    base2 = saver.save(runner)
    for base in (base1, base2):
        with open(base + meta_suffix) as f:
            assert json.load(f)["healthy"] is True
    for base, mutate in ((base1, lambda m: m.pop("healthy")),
                         (base2, lambda m: m.update(healthy=False))):
        with open(base + meta_suffix) as f:
            meta = json.load(f)
        mutate(meta)
        with open(base + meta_suffix, "w") as f:
            json.dump(meta, f)
    assert validate(*integrity.parse_base(base1)).healthy is None
    assert validate(*integrity.parse_base(base2)).healthy is False
    assert saver.latest() == base1
    assert latest_checkpoint(str(tmp_path))[0] == 1
    assert jlatest(str(tmp_path))[0] == 1
    _, step = saver.restore(runner)
    assert step == 1
    assert tel.counters()["ckpt.unhealthy_skipped"] >= 2


def test_cli_displays_health_stamp(tmp_path, capsys):
    """``checkpoint ls`` shows yes / NO / ? and fsck counts unhealthy
    steps, over the port's plain and sharded files together."""
    from autodist_tpu_torch.checkpoint import cli
    runner = _build()
    _train(runner, 1)
    base1 = Saver(directory=str(tmp_path)).save(runner)
    _train(runner, 1)
    base2 = ShardedSaver(directory=str(tmp_path)).save(runner)
    _train(runner, 1)
    ShardedSaver(directory=str(tmp_path)).save(runner)
    with open(base1 + ".meta.json") as f:
        meta = json.load(f)
    meta.pop("healthy")
    with open(base1 + ".meta.json", "w") as f:
        json.dump(meta, f)
    with open(base2 + ".shard-meta.json") as f:
        meta = json.load(f)
    meta["healthy"] = False
    with open(base2 + ".shard-meta.json", "w") as f:
        json.dump(meta, f)
    assert cli.main(["--dir", str(tmp_path), "ls"]) == 0
    out = capsys.readouterr().out
    lines = {int(ln.split()[0]): ln for ln in out.splitlines()
             if ln.strip() and ln.split()[0].isdigit()}
    assert " ? " in lines[1] and " NO " in lines[2] and " yes " in lines[3]
    assert cli.main(["--dir", str(tmp_path), "fsck"]) == 0
    assert "1 stamped unhealthy" in capsys.readouterr().out


def test_lr_scale_resyncs_on_restore(tmp_path):
    """A restore replaces the state's scale; the store's and the
    sentinel's copies follow it (``notify_state_restored``), as in the
    JAX runner."""
    runner = _build("PS", sentinel=True)
    saver = Saver(directory=str(tmp_path))
    _train(runner, 2)
    saver.save(runner)
    runner.sentinel._halve_lr()
    store = runner.distributed_step.ps_store
    assert store.update_scale == 0.5 and runner.sentinel.lr_scale == 0.5
    saver.restore(runner)
    assert store.update_scale == 1.0 and runner.sentinel.lr_scale == 1.0
    runner.sentinel._halve_lr()
    saver.save(runner, step=7)
    runner.sentinel._halve_lr()
    saver.restore(runner)
    assert store.update_scale == 0.5 and runner.sentinel.lr_scale == 0.5


# -------------------------------------------------- policy engine units


def test_policy_env_resolution(monkeypatch):
    monkeypatch.delenv("ADT_SENTINEL", raising=False)
    assert resolve_policy(None) is None
    assert resolve_policy(False) is None
    assert isinstance(resolve_policy(True), SentinelPolicy)
    monkeypatch.setenv("ADT_SENTINEL", "1")
    assert isinstance(resolve_policy(None), SentinelPolicy)
    monkeypatch.setenv("ADT_SENTINEL",
                       '{"max_skips_per_window": 7, "spike_zscore": 4.5}')
    p = resolve_policy(None)
    assert p.max_skips_per_window == 7 and p.spike_zscore == 4.5
    runner = _build()
    assert runner.distributed_step.metadata["sentinel_guards"] is True
    monkeypatch.setenv("ADT_SENTINEL", "0")
    assert resolve_policy(None) is None
    with pytest.raises(ValueError, match="window_steps"):
        SentinelPolicy(window_steps=0)
    with pytest.raises(TypeError):
        resolve_policy("yes")


def test_grad_fault_plan_rejects_unknown_fields():
    """The gradient grammar is step-keyed: the wire and checkpoint knobs
    are rejected, as in the JAX plan, with the same message."""
    from autodist_tpu.runtime.faultinject import GradFaultPlan as JPlan
    for plan in (GradFaultPlan, JPlan):
        with pytest.raises(ValueError, match="unknown gradient fault field"):
            plan({"faults": [{"var": "w", "mode": "nan", "prob": 0.5}]})
        with pytest.raises(ValueError, match="unknown gradient fault mode"):
            plan({"faults": [{"var": "w", "mode": "explode"}]})
        with pytest.raises(ValueError, match="precedes"):
            plan({"faults": [{"var": "w", "step": 3, "until": 1}]})
        assert plan({"seed": 7, "faults": []}).rules == []
    spec = {"faults": [{"var": "w", "mode": "inf", "step": 2, "until": 9,
                        "every": 3}]}
    assert GradFaultPlan(spec).describe() == JPlan(spec).describe()


def test_apply_grad_faults_matches_the_jax_injection():
    """Each mode, at every step of a window, against the JAX injection on
    the same gradient."""
    import jax
    from autodist_tpu.runtime.faultinject import (
        GradFaultPlan as JPlan, apply_grad_faults as japply)
    from autodist_tpu_torch.runtime.faultinject import apply_grad_faults
    rng = np.random.RandomState(5)
    g = rng.randn(3, 4).astype(np.float32)
    spec = {"faults": [
        {"var": "a", "mode": "nan", "step": 1},
        {"var": "b", "mode": "scale", "step": 2, "until": 6, "every": 2,
         "factor": 8.0},
        {"var": "c", "mode": "bitflip", "step": 3, "bit": 30, "index": 5},
        {"var": "d", "mode": "inf", "step": 0, "until": 1}]}
    for step in range(8):
        got = apply_grad_faults(GradFaultPlan(spec), torch.tensor(step),
                                {k: torch.from_numpy(g.copy())
                                 for k in "abcd"})
        want = japply(JPlan(spec), jnp.int32(step),
                      {k: jnp.asarray(g) for k in "abcd"})
        for k in "abcd":
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(jax.device_get(want[k])))


def test_ewma_spike_detection_pends_rollback():
    """A sustained EWMA z-score breach pends a rollback after
    ``spike_patience`` spiking steps; one outlier does not."""
    policy = SentinelPolicy(spike_zscore=4.0, spike_patience=3,
                            min_history=5, ewma_alpha=0.2)
    sen = Sentinel(policy, runner=None)
    ok = {"ok": 1, "grad_norm": 1.0, "bad_grads": 0, "bad_params": 0}
    for i in range(20):
        sen.observe({"loss": 1.0 + 0.01 * np.sin(i), "sentinel": ok})
    assert sen._pending_rollback is None
    spike = {"loss": 50.0, "sentinel": ok}
    sen.observe(spike)
    sen.observe(spike)
    assert sen._pending_rollback is None
    sen.observe(spike)
    assert "loss spike" in sen._pending_rollback
    assert sen.quarantined


def test_unguarded_nonfinite_loss_pends_rollback():
    sen = Sentinel(SentinelPolicy(), runner=None)
    sen.observe({"loss": 1.0})
    assert sen._pending_rollback is None
    sen.observe({"loss": float("nan")})
    assert sen._pending_rollback is not None


def test_verify_sentinel_diagnostics():
    """ADT420 and ADT421 as the JAX rules give them."""
    from autodist_tpu.analysis import rules as jrules
    from autodist_tpu_torch.analysis import rules
    policy = SentinelPolicy(window_steps=2)
    for metadata, codes in (({"sentinel_guards": True, "staleness": 0}, []),
                            ({"sentinel_guards": False}, ["ADT420"]),
                            ({"sentinel_guards": True, "staleness": 5},
                             ["ADT421"]),
                            ({"sentinel_guards": True, "async": True},
                             [])):
        got = rules.verify_sentinel(policy, metadata)
        assert [d.code for d in got] == codes
        assert [d.code for d in jrules.verify_sentinel(policy, metadata)] \
            == codes
    assert rules.verify_sentinel(None, {}) == []


def test_step_fn_mode_gets_adt420_runner_diag():
    """build_step + sentinel: the opaque step has no guards; the Runner
    reports ADT420 and watches the loss only."""
    params, batch = _problem()

    def step_fn(state, b):
        loss = lin_loss(state, b)
        return state, {"loss": loss}
    ad = adt.AutoDist(strategy_builder=S.AllReduce(), device="cpu")
    state = {n: torch.as_tensor(v) for n, v in params.items()}
    runner = ad.build_step(step_fn, state, batch, sentinel=True)
    assert [d.code for d in runner._sentinel_diags] == ["ADT420"]
    runner.init(state)
    m = runner.run(batch)
    assert "sentinel" not in m
    assert runner.step_stats()["sentinel"]["skips"] == 0
    assert runner.distributed_step.metadata["sentinel_guards"] is False

