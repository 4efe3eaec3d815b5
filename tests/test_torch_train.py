"""autodist_tpu_torch training slice: build -> init -> run on the CPU, held
to the JAX package.

- The port's optimizer apply (``optim.py``, captured from a
  ``torch.optim.Adam`` factory) against optax.adam on the same tensors.
- Three ``Runner.run`` steps of the port (``device="cpu"``) against three
  JAX ``Runner.run`` steps (``optax.adam(1e-3)``, AllReduce) on
  ``LMConfig.tiny`` with the lean head and flash attention, from the JAX
  init converted by ``convert.params_from_jax``. The JAX runner spreads
  the batch of 8 over the test session's 8 virtual CPU devices; its
  all-reduced mean gradient is the one-device gradient the port takes.
- The runner's contract: frozen variables, evaluate, fit, step_stats,
  ``sync=False`` handles, an explicit state, and the errors.

Tolerances. Per-step losses: 1e-5 (the two frameworks sum in different
orders; observed ~1e-7). Parameters after three Adam steps: 1e-4, except
the attention key biases, whose gradient is zero analytically (adding a
constant to every key's score leaves the softmax unchanged): their
computed gradient is rounding noise, which Adam normalizes to a step of
up to lr either way, so they are held to 2 x steps x lr. Observed: 8.5e-4
on the key biases, under 3e-6 everywhere else.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import autodist_tpu as jadt
import autodist_tpu_torch as adt
from autodist_tpu import strategy as jstrategy
from autodist_tpu.models import lm as jlm
from autodist_tpu_torch import optim, strategy
from autodist_tpu_torch.convert import params_from_jax
from autodist_tpu_torch.models import lm as tlm
from autodist_tpu_torch.ops import flash_attention as tfa

LR, STEPS = 1e-3, 3
ADAM = functools.partial(torch.optim.Adam, lr=LR)


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


def _batches(cfg, n=STEPS, seed=1):
    rng = np.random.RandomState(seed)
    return [{"tokens": rng.randint(0, cfg.vocab_size, (8, 17)).astype(
        np.int32)} for _ in range(n)]


@pytest.fixture(scope="module")
def jax_run():
    """Three JAX steps (lean head, flash, adam 1e-3, AllReduce) on
    LMConfig.tiny: the converted init, the batches, the per-step losses
    and the converted final params."""
    cfg = jlm.LMConfig.tiny()
    loss_fn, jparams, batch, _ = jlm.make_train_setup(
        cfg, seq_len=16, batch_size=8, attention="flash", lean_head=True)
    init = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    batches = _batches(cfg)
    try:
        ad = jadt.AutoDist(strategy_builder=jstrategy.AllReduce())
        runner = ad.build(loss_fn, optax.adam(LR), jparams, batch)
        runner.init(jparams)
        losses = [float(runner.run(b)["loss"]) for b in batches]
        final = params_from_jax(jax.tree_util.tree_map(
            np.asarray, runner.gather_params()))
    finally:
        jadt.reset()
    return init, batches, losses, final


def _port_runner(init, attention="flash", optimizer=ADAM, **build_kw):
    cfg = tlm.LMConfig.tiny()
    loss_fn, _, batch, _ = tlm.make_train_setup(
        cfg, seq_len=16, batch_size=4, attention=attention, lean_head=True)
    ad = adt.AutoDist(strategy_builder=strategy.AllReduce(), device="cpu")
    runner = ad.build(loss_fn, optimizer, init, batch, **build_kw)
    runner.init(init)
    return runner


def test_optimizer_step_matches_optax():
    """The captured torch.optim.Adam factory applies optax.adam's update:
    bias correction, eps outside the root, eps_root 0."""
    factory, ref = ADAM, optax.adam(LR)
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
        state = spec.update({k: torch.as_tensor(v) for k, v in g.items()},
                            state, tp)
        upd, jstate = ref.update({k: jnp.asarray(v) for k, v in g.items()},
                                 jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       atol=1e-6, rtol=1e-6)
    assert state["count"] == STEPS


def test_optimizer_capture_records_name_and_kwargs():
    item = adt.ModelItem(loss_fn=lambda p, b: 0, optimizer=ADAM,
                         params={"w": torch.zeros(2, 3)}).prepare()
    assert (item.optimizer_name, item.optimizer_args) == ("adam",
                                                          {"lr": LR})
    assert item.opt_state_spec == {"count": (), "mu": {"w": (2, 3)},
                                   "nu": {"w": (2, 3)}}
    with pytest.raises(ValueError, match="weight_decay"):
        optim.capture(functools.partial(torch.optim.Adam, weight_decay=0.1))
    with pytest.raises(ValueError, match="foreach"):   # not silently dropped
        optim.capture(functools.partial(torch.optim.Adam, foreach=True))
    with pytest.raises(ValueError, match="optax.adam"):
        optim.capture(torch.optim.SGD)
    with pytest.raises(TypeError):
        optim.capture(functools.partial(torch.optim.Adam, bogus=1))
    with pytest.raises(TypeError, match="factory|class"):
        optim.capture(torch.optim.Adam([torch.zeros(1, requires_grad=True)]))


def test_runner_matches_jax_three_steps(jax_run):
    """Three port Runner.run steps (lean head, flash attention through the
    plain versions of the three kernels) equal three JAX steps."""
    init, batches, jlosses, jfinal = jax_run
    runner = _port_runner(init)
    before = (tfa.flash_fwd.launches, tfa.flash_bwd_dq.launches)
    losses = [float(runner.run(b)["loss"]) for b in batches]
    np.testing.assert_allclose(losses, jlosses, atol=1e-5, rtol=1e-5)
    final = runner.gather_params()
    assert final.keys() == jfinal.keys()
    for name, value in final.items():
        assert value.dtype == torch.float32
        tol = 2 * STEPS * LR if name.endswith("key.bias") else 1e-4
        np.testing.assert_allclose(value.numpy(), jfinal[name].numpy(),
                                   atol=tol, rtol=0, err_msg=name)
        assert not torch.equal(value, init[name]), name   # it trained
    assert runner.state.step == STEPS
    assert runner.state.opt_state["count"] == STEPS
    # CPU tensors: the plain versions ran, no kernel launched
    assert (tfa.flash_fwd.launches, tfa.flash_bwd_dq.launches) == before


def test_trainable_filter_var_never_moves(jax_run):
    init, batches = jax_run[0], jax_run[1]
    frozen = "layer_1.Dense_0.weight"
    runner = _port_runner(init, trainable_filter=lambda n: n != frozen)
    runner.fit(batches)
    params = runner.gather_params()
    assert torch.equal(params[frozen], init[frozen])
    assert not torch.equal(params["layer_1.Dense_1.weight"],
                           init["layer_1.Dense_1.weight"])
    assert float(runner.state.opt_state["mu"][frozen].abs().max()) == 0.0


def test_evaluate_returns_the_loss_without_an_update(jax_run):
    init, batches, jlosses = jax_run[0], jax_run[1], jax_run[2]
    runner = _port_runner(init)
    ev = runner.evaluate(batches[:1])
    np.testing.assert_allclose(ev["loss"], jlosses[0], atol=1e-5, rtol=1e-5)
    assert runner.state.step == 0
    for name, value in runner.gather_params().items():
        assert torch.equal(value, init[name])
    # example-weighted mean over batches
    both = runner.evaluate(batches[:2])
    one = runner.evaluate(batches[1:2])
    np.testing.assert_allclose(both["loss"], (ev["loss"] + one["loss"]) / 2,
                               rtol=1e-6)


def test_fit_step_stats_and_async_metrics(jax_run):
    init, batches, jlosses = jax_run[0], jax_run[1], jax_run[2]
    runner = _port_runner(init)
    seen = []
    history = runner.fit(iter(batches * 2), steps=2,
                         callbacks=[lambda i, m: seen.append(i)])
    assert seen == [0, 1] and len(history) == 2
    handle = runner.run(batches[2], sync=False)
    assert "device-resident" in repr(handle)
    np.testing.assert_allclose(float(handle["loss"]), jlosses[2], atol=1e-5,
                               rtol=1e-5)
    assert handle.materialized
    stats = runner.step_stats()
    assert stats["steps"] == stats["microsteps"] == stats["supersteps"] == 3
    assert stats["first_step_s"] > 0 and stats["steady_median_s"] > 0
    assert 0 < stats["goodput"] <= 1
    assert stats["telemetry"]["dispatches"] >= 3


def test_run_with_an_explicit_state_leaves_it_unchanged(jax_run):
    init, batches = jax_run[0], jax_run[1]
    runner = _port_runner(init)
    st = runner.state
    snapshot = {n: t.clone() for n, t in st.params.items()}
    new_state, metrics = runner.run(batches[0], state=st)
    assert new_state.step == 1 and runner.state is st
    for name, value in st.params.items():
        assert torch.equal(value, snapshot[name])
    assert np.isfinite(float(metrics["loss"]))


def test_run_before_init_raises(jax_run):
    cfg = tlm.LMConfig.tiny()
    loss_fn, params, batch, _ = tlm.make_train_setup(cfg, seq_len=16,
                                                     batch_size=4)
    ad = adt.AutoDist(strategy_builder=strategy.AllReduce(), device="cpu")
    runner = ad.build(loss_fn, ADAM, params, batch)
    with pytest.raises(RuntimeError, match="before init"):
        runner.run(batch)
    with pytest.raises(RuntimeError, match="before init"):
        runner.evaluate([batch])


def test_autodist_without_a_device_raises_when_there_is_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        adt.AutoDist(strategy_builder=strategy.AllReduce())
