"""autodist_tpu_torch's fused supersteps (``DistributedStep.multi_step``/
``run_multi``, ``Runner.run_superstep``, ``fit(fuse_steps=k,
metrics_every=n)``) on the CPU, held to the JAX package's fused program
and to the port's own per-step loop.

On the CPU a superstep is the plain k-step loop in one call, so it is
held BIT-EQUAL to the port's per-step loop. Against the JAX package's
``lax.scan`` program: the embedding + linear problem of
``tests/test_fused.py`` (Adam 0.1) with params, Adam moments and
per-microstep losses allclose at 1e-5, and lm tiny (lean head, flash
attention through the kernels' plain versions, Adam 1e-3) at
``tests/test_torch_train.py``'s bounds (losses 1e-5; params 1e-4, the
attention key biases, whose gradient is rounding noise, 2 x steps x lr).
At N = 2 the port's two gloo ranks (``tests/torch_dist_worker.py``) run
``fit(fuse_steps=4, metrics_every=2)`` against the JAX fused program on 2
virtual devices, at the same bounds. On ``cuda`` the superstep is a
replayed CUDA graph; those tests are marked ``cuda`` and skip here.
"""
import functools

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
from autodist_tpu.models import lm as jlm
from autodist_tpu.resource_spec import ResourceSpec as JSpec
from autodist_tpu_torch import strategy
from autodist_tpu_torch.convert import params_from_jax
from autodist_tpu_torch.data import DevicePrefetcher
from autodist_tpu_torch.models import lm as tlm
from autodist_tpu_torch.remapper import Remapper
from autodist_tpu_torch.runtime.runner import MetricsHandle
from torch_dist_worker import LR, launch

K = 4
ONE = {"nodes": [{"address": "127.0.0.1", "chief": True, "cpus": [0]}]}
TWO = {"nodes": [{"address": "127.0.0.1", "chief": True, "cpus": [0, 1]}]}


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


def _problem(seed=0, n_batches=8):
    """``tests/test_fused.py``'s problem: numpy init, batches, and the JAX
    and port losses."""
    rng = np.random.RandomState(seed)
    params = {"w": rng.randn(4, 2).astype(np.float32),
              "b": np.zeros((2,), np.float32),
              "emb": rng.randn(16, 4).astype(np.float32)}

    def jax_loss(p, batch):
        feat = jnp.take(p["emb"], batch["ids"], axis=0)
        return jnp.mean((feat @ p["w"] + p["b"] - batch["y"]) ** 2)

    def port_loss(p, batch):
        feat = F.embedding(torch.as_tensor(batch["ids"]).long(), p["emb"])
        return ((feat @ p["w"] + p["b"] - batch["y"]) ** 2).mean()

    batches = [{"ids": rng.randint(0, 16, size=(16,)).astype(np.int32),
                "y": rng.randn(16, 2).astype(np.float32)}
               for _ in range(n_batches)]
    return params, jax_loss, port_loss, batches


def _port(loss_fn, params, example, lr=0.1):
    adt.reset()
    ad = adt.AutoDist(strategy_builder=strategy.AllReduce(), device="cpu")
    runner = ad.build(loss_fn, functools.partial(torch.optim.Adam, lr=lr),
                      {n: torch.as_tensor(v) for n, v in params.items()},
                      example)
    runner.init({n: torch.as_tensor(v) for n, v in params.items()})
    return runner


def _jax_fused(loss_fn, params, batches, lr, spec=ONE):
    """The JAX package's fit(fuse_steps=4, metrics_every=2): losses,
    params, Adam moments and dispatches."""
    try:
        ad = jadt.AutoDist(strategy_builder=jstrategy.AllReduce(),
                           resource_spec=JSpec.from_dict(spec))
        runner = ad.build(loss_fn, optax.adam(lr), params, batches[0])
        runner.init(params)
        hist = runner.fit(iter(batches), fuse_steps=K, metrics_every=2)
        opt = runner.distributed_step.gather_opt_state(runner.state)[0]
        out = {"losses": [float(m["loss"]) for m in hist],
               "params": jax.tree_util.tree_map(np.asarray,
                                                runner.gather_params()),
               "mu": jax.tree_util.tree_map(np.asarray, opt.mu),
               "nu": jax.tree_util.tree_map(np.asarray, opt.nu),
               "count": int(opt.count),
               "dispatches": runner.distributed_step.dispatches}
    finally:
        jadt.reset()
    return out


def _np(t):
    return t.detach().cpu().numpy()


def test_fused_matches_the_jax_fused_program_and_the_per_step_loop():
    params, jax_loss, port_loss, batches = _problem()
    want = _jax_fused(jax_loss, params, batches, 0.1)

    per_step = _port(port_loss, params, batches[0])
    hist_a = per_step.fit(iter(batches))
    st_a = per_step.state
    assert per_step.distributed_step.dispatches == len(batches)
    fused = _port(port_loss, params, batches[0])
    hist_b = fused.fit(iter(batches), fuse_steps=K, metrics_every=2)

    # k x fewer dispatches, as in the JAX package
    assert fused.distributed_step.dispatches == len(batches) // K \
        == want["dispatches"]
    losses = [float(m["loss"]) for m in hist_b]
    np.testing.assert_allclose(losses, want["losses"], rtol=1e-5,
                               atol=1e-5)
    st = fused.state
    for n in params:
        np.testing.assert_allclose(_np(st.params[n]), want["params"][n],
                                   rtol=1e-5, atol=1e-5, err_msg=n)
        np.testing.assert_allclose(_np(st.opt_state["mu"][n]),
                                   want["mu"][n], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_np(st.opt_state["nu"][n]),
                                   want["nu"][n], rtol=1e-5, atol=1e-5)
    assert st.opt_state["count"].dtype == torch.int32
    assert int(st.opt_state["count"]) == want["count"] == len(batches)
    # the CPU superstep is the per-step loop: bit for bit
    assert losses == [float(m["loss"]) for m in hist_a]
    for part in ("mu", "nu"):
        for n in params:
            assert torch.equal(st.opt_state[part][n],
                               st_a.opt_state[part][n])
    for n in params:
        assert torch.equal(st.params[n], st_a.params[n])


def test_fused_lm_tiny_matches_jax():
    cfg = jlm.LMConfig.tiny()
    loss_fn, jparams, _, _ = jlm.make_train_setup(
        cfg, seq_len=16, batch_size=8, attention="flash", lean_head=True)
    init = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    rng = np.random.RandomState(1)
    batches = [{"tokens": rng.randint(0, cfg.vocab_size, (8, 17)).astype(
        np.int32)} for _ in range(K)]
    try:
        ad = jadt.AutoDist(strategy_builder=jstrategy.AllReduce())
        jr = ad.build(loss_fn, optax.adam(LR), jparams, batches[0])
        jr.init(jparams)
        jhist = jr.fit(iter(batches), fuse_steps=K)
        want = params_from_jax(jax.tree_util.tree_map(
            np.asarray, jr.gather_params()))
    finally:
        jadt.reset()
    tloss, _, example, _ = tlm.make_train_setup(
        tlm.LMConfig.tiny(), seq_len=16, batch_size=8, attention="flash",
        lean_head=True)
    ad = adt.AutoDist(strategy_builder=strategy.AllReduce(), device="cpu")
    runner = ad.build(tloss, functools.partial(torch.optim.Adam, lr=LR),
                      init, example)
    runner.init(init)
    hist = runner.fit(iter(batches), fuse_steps=K)
    assert runner.distributed_step.dispatches == 1
    np.testing.assert_allclose([float(m["loss"]) for m in hist],
                               [float(m["loss"]) for m in jhist],
                               rtol=1e-5, atol=1e-5)
    got = runner.gather_params()
    for n, w in want.items():
        tol = 2 * K * LR if "key.bias" in n else 1e-4
        np.testing.assert_allclose(_np(got[n]), w.numpy(), atol=tol,
                                   rtol=0, err_msg=n)


def test_zero_readbacks_between_metrics_every_boundaries(monkeypatch):
    """``sync=False`` supersteps copy nothing to the host until a handle is
    read; ``fit(metrics_every=2)`` reads back at its boundaries only.
    Counted at ``Remapper.remap_fetch``, which every readback goes
    through."""
    params, _, port_loss, batches = _problem()
    runner = _port(port_loss, params, batches[0])
    fetches = []
    real_fetch = Remapper.remap_fetch
    monkeypatch.setattr(Remapper, "remap_fetch",
                        lambda self, fetched: fetches.append(1)
                        or real_fetch(self, fetched))
    stack = {k: np.stack([b[k] for b in batches[:K]]) for k in batches[0]}
    h1 = runner.run_superstep(stack, sync=False)
    h2 = runner.run_superstep(stack, sync=False)
    assert isinstance(h1, MetricsHandle) and not h1.materialized
    assert fetches == [] and runner.readbacks == 0
    host = h1.result()
    assert len(fetches) == 1 and np.shape(host["loss"]) == (K,)
    assert h1.result() is host
    assert [m["loss"] for m in h1.unstack()] == list(host["loss"])
    h2.result()
    assert len(fetches) == 2 == runner.readbacks

    del fetches[:]
    counts = []
    real_superstep = type(runner).run_superstep

    def spy(self, *a, **kw):
        out = real_superstep(self, *a, **kw)
        counts.append(len(fetches))
        return out
    monkeypatch.setattr(type(runner), "run_superstep", spy)
    hist = runner.fit(iter(batches), fuse_steps=2, metrics_every=2)
    assert len(hist) == 8
    # read back after supersteps 2 and 4 only, never between, each time
    # the two supersteps' metrics in one copy
    assert counts == [0, 0, 1, 1] and len(fetches) == 2


def test_step_stats_and_the_trailing_partial_group():
    """10 batches at k = 4: two supersteps and a trailing pair run per
    step; ``step_stats`` counts dispatches and microsteps apart; every
    batch trains, bit-equal to the per-step loop; the supersteps' and the
    trailing steps' metrics come back in one readback."""
    params, _, port_loss, batches = _problem(n_batches=10)
    runner = _port(port_loss, params, batches[0])
    stats0 = runner.step_stats()
    assert (stats0["supersteps"], stats0["microsteps"]) == (0, 0)
    hist = runner.fit(iter(batches), fuse_steps=K, metrics_every=3)
    assert len(hist) == 10 and runner.readbacks == 1
    stats = runner.step_stats()
    assert (stats["steps"], stats["microsteps"], stats["supersteps"]) == \
        (10, 10, 4)
    assert runner.distributed_step.dispatches == 4
    assert 0.0 < stats["goodput"] <= 1.0
    runner.run(batches[0])
    stats = runner.step_stats()
    assert (stats["supersteps"], stats["microsteps"]) == (5, 11)
    plain = _port(port_loss, params, batches[0])
    want = plain.fit(iter(batches))
    assert [float(m["loss"]) for m in hist] == \
        [float(m["loss"]) for m in want]


def test_prestacked_source_is_consumed_whole_and_a_mismatch_raises():
    params, _, port_loss, batches = _problem(n_batches=9)
    runner = _port(port_loss, params, batches[0])
    pf = DevicePrefetcher(iter(batches), runner, depth=2, stack=K)
    with pytest.raises(ValueError, match="pre-stacked"):
        runner.fit(pf)
    with pytest.raises(ValueError, match="pre-stacked"):
        runner.fit(pf, fuse_steps=2)
    hist = runner.fit(pf, fuse_steps=K, metrics_every=2)
    # the tail of one batch is dropped by the prefetcher, with its count
    assert len(hist) == 8 and pf.dropped_batches == 1
    assert pf.dropped_examples == 16
    assert runner.distributed_step.dispatches == 2
    plain = _port(port_loss, params, batches[0])
    want = plain.fit(iter(batches[:8]))
    assert [float(m["loss"]) for m in hist] == \
        [float(m["loss"]) for m in want]


def test_multi_step_refusals_and_donate():
    params, _, port_loss, batches = _problem()
    runner = _port(port_loss, params, batches[0])
    dstep = runner.distributed_step
    with pytest.raises(ValueError, match="k >= 1"):
        dstep.multi_step(0)
    stack = runner.remapper.remap_feed_stack(
        {k: np.stack([b[k] for b in batches[:K]]) for k in batches[0]})
    with pytest.raises(ValueError, match="leading dim"):
        dstep.multi_step(3)(runner.state, {}, {}, stack)
    ragged = dict(stack, y=stack["y"][:2])
    with pytest.raises(ValueError, match="mismatched leading"):
        dstep.run_multi(runner.state, ragged)
    with pytest.raises(ValueError, match="leading \\[k\\]"):
        runner.remapper.remap_feed_stack({"s": np.float32(1.0)})
    # donate=False leaves the state as it was; the JAX signature
    before = {n: t.clone() for n, t in runner.state.params.items()}
    new, ps_vals, ps_opt, metrics = dstep.multi_step(K, donate=False)(
        runner.state, {}, {}, stack)
    assert ps_vals == {} and ps_opt == {}
    assert metrics["loss"].shape == (K,)
    assert new.step == runner.state.step + K
    for n, t in before.items():
        assert torch.equal(runner.state.params[n], t)
        assert not torch.equal(new.params[n], t)


def test_step_fn_mode_fused_parity():
    """build_step's opaque step fuses too (``tests/test_fused.py``'s
    step_fn problem, SGD 0.1): fused k = 4 bit-equal to its per-step loop
    on the CPU, both allclose to the JAX package's."""
    rng = np.random.RandomState(3)
    w0 = rng.randn(4, 2).astype(np.float32)
    batches = [{"x": rng.randn(8, 4).astype(np.float32),
                "y": rng.randn(8, 2).astype(np.float32)} for _ in range(8)]
    opt = optax.sgd(0.1)

    def jax_step(p, batch):
        def loss(q):
            return jnp.mean((batch["x"] @ q["w"] - batch["y"]) ** 2)
        val, g = jax.value_and_grad(loss)(p)
        updates, _ = opt.update(g, opt.init(p), p)
        return optax.apply_updates(p, updates), {"loss": val}

    def port_step(p, batch):
        w = p["w"].detach().requires_grad_()
        val = ((batch["x"] @ w - batch["y"]) ** 2).mean()
        (g,) = torch.autograd.grad(val, [w])
        return {"w": p["w"] - 0.1 * g}, {"loss": val}

    try:
        ad = jadt.AutoDist(strategy_builder=jstrategy.AllReduce())
        jr = ad.build_step(jax_step, {"w": jnp.asarray(w0)}, batches[0])
        jr.init({"w": jnp.asarray(w0)})
        jhist = jr.fit(iter(batches), fuse_steps=K)
        jw = np.asarray(jr.gather_params()["w"])
    finally:
        jadt.reset()

    def train(fuse):
        adt.reset()
        ad = adt.AutoDist(strategy_builder=strategy.AllReduce(),
                          device="cpu")
        runner = ad.build_step(port_step, {"w": torch.as_tensor(w0)},
                               batches[0])
        runner.init({"w": torch.as_tensor(w0)})
        hist = runner.fit(iter(batches), fuse_steps=fuse)
        return ([float(m["loss"]) for m in hist],
                runner.gather_params()["w"],
                runner.distributed_step.dispatches)

    la, wa, da = train(1)
    lb, wb, db = train(K)
    assert (da, db) == (8, 2)
    assert la == lb and torch.equal(wa, wb)
    np.testing.assert_allclose(lb, [float(m["loss"]) for m in jhist],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(wb), jw, rtol=1e-5, atol=1e-6)


def test_two_ranks_fused_match_the_jax_fused_program(tmp_path):
    """N = 2 gloo ranks, fit(fuse_steps=4, metrics_every=2) on lm tiny
    against the JAX fused program on 2 virtual devices; both ranks
    bit-equal."""
    cfg = jlm.LMConfig.tiny()
    loss_fn, jparams, _, _ = jlm.make_train_setup(
        cfg, seq_len=16, batch_size=8, attention="flash", lean_head=True)
    init = {n: t.numpy() for n, t in params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams)).items()}
    rng = np.random.RandomState(1)
    batches = [{"tokens": rng.randint(0, 128, (8, 17)).astype(np.int32)}
               for _ in range(2 * K)]
    try:
        ad = jadt.AutoDist(strategy_builder=jstrategy.AllReduce(),
                           resource_spec=JSpec.from_dict(TWO))
        jr = ad.build(loss_fn, optax.adam(LR), jparams, batches[0])
        jr.init(jparams)
        jhist = jr.fit(iter(batches), fuse_steps=K, metrics_every=2)
        want = params_from_jax(jax.tree_util.tree_map(
            np.asarray, jr.gather_params()))
    finally:
        jadt.reset()
    ranks = launch("fused", 2, tmp_path, {
        "model": "lm", "seq_len": 16, "batch_size": 8,
        "attention": "flash", "init": init, "batches": batches,
        "fuse_steps": K, "metrics_every": 2})
    for r in ranks:
        assert r["dispatches"] == 2 and r["readbacks"] == 1
        np.testing.assert_allclose(r["losses"],
                                   [float(m["loss"]) for m in jhist],
                                   rtol=1e-5, atol=1e-5)
        for n, w in want.items():
            tol = 2 * 2 * K * LR if "key.bias" in n else 1e-4
            np.testing.assert_allclose(r["params"][n], w.numpy(), atol=tol,
                                       rtol=0, err_msg=n)
    assert ranks[0]["losses"] == ranks[1]["losses"]
    for n in ranks[0]["params"]:
        np.testing.assert_array_equal(ranks[0]["params"][n],
                                      ranks[1]["params"][n])


def test_fused_at_two_replicas_on_cuda_is_refused(monkeypatch):
    """At N > 1 on cuda a superstep would need a graph over gloo's
    host-staged collectives: refused by name, at the first superstep."""
    from autodist_tpu_torch.kernel.graph_transformer import DistributedStep
    from autodist_tpu_torch.kernel.replicator import ReplicaInfo
    params, _, port_loss, batches = _problem()
    runner = _port(port_loss, params, batches[0])
    item = runner.distributed_step.model_item
    dstep = DistributedStep(strategy=runner.distributed_step.strategy,
                            model_item=item, device="cpu",
                            replica_info=ReplicaInfo(1, 0))
    monkeypatch.setattr(dstep, "num_replicas", 2)
    monkeypatch.setattr(dstep, "device", torch.device("cuda"))
    with pytest.raises(NotImplementedError, match="ROADMAP A item 12"):
        dstep.multi_step(K)
