"""autodist_tpu_torch's user entry points beside ``build``, held to the
JAX package's on the CPU: ``AutoDist.function``,
``create_distributed_session`` (``WrappedSession``) and ``build_step``
(the opaque step_fn capture mode).

The problems are the JAX tests' own: ``tests/test_fused.py``'s embedding
+ linear regression (Adam 0.1) for the loss_fn entry points and
``tests/test_step_fn.py``'s momentum step for step_fn mode. Losses are
held at 1e-5 relative / 1e-6 absolute (two frameworks, two summation
orders), and so are the step_fn params (plain momentum SGD) and the
loss_fn params after 6 Adam steps at lr 0.1: the port's Adam computes
optax's float32 bias corrections and divides by them, as optax does. The
step_fn plan serializes to the JAX package's JSON
bytes for the same state tree; a step_fn checkpoint saves the state under
its paths and restores bit for bit.
"""
import functools
import json

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
from autodist_tpu.model_item import ModelItem as JModelItem
from autodist_tpu.resource_spec import ResourceSpec as JSpec
from autodist_tpu_torch import strategy
from autodist_tpu_torch.autodist import WrappedSession
from autodist_tpu_torch.kernel.replicator import ReplicaInfo
from autodist_tpu_torch.model_item import ModelItem
from autodist_tpu_torch.resource_spec import ResourceSpec

TOL = dict(rtol=1e-5, atol=1e-6)
SPEC = {"nodes": [{"address": "127.0.0.1", "chief": True, "cpus": [0]}]}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reset_both():
    yield
    adt.reset()
    jadt.reset()


def _regression(n_batches=6):
    rng = np.random.RandomState(0)
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


def _torch(params):
    return {n: torch.as_tensor(v) for n, v in params.items()}


def _jax_ad():
    return jadt.AutoDist(strategy_builder=jstrategy.AllReduce(),
                         resource_spec=JSpec.from_dict(SPEC))


def _port_ad():
    return adt.AutoDist(strategy_builder=strategy.AllReduce(), device="cpu")


def test_function_matches_jax_and_builds_at_the_first_call():
    params, jax_loss, port_loss, batches = _regression()
    jstep = _jax_ad().function(jax_loss, optimizer=optax.adam(0.1),
                               params={n: jnp.asarray(v)
                                       for n, v in params.items()})
    want = [float(jstep(b)["loss"]) for b in batches]
    jfinal = jax.tree_util.tree_map(np.asarray,
                                    jstep.get_runner().gather_params())
    jadt.reset()
    step = _port_ad().function(
        port_loss, optimizer=functools.partial(torch.optim.Adam, lr=0.1),
        params=_torch(params))
    assert step.get_runner() is None
    got = [float(step(b)["loss"]) for b in batches]
    np.testing.assert_allclose(got, want, **TOL)
    final = step.get_runner().gather_params()
    for n in params:
        np.testing.assert_allclose(final[n].numpy(), jfinal[n], **TOL,
                                   err_msg=n)
    assert step.get_runner().distributed_step.dispatches == len(batches)


def test_create_distributed_session_matches_jax():
    params, jax_loss, port_loss, batches = _regression()
    jsess = _jax_ad().create_distributed_session(
        jax_loss, optax.adam(0.1), {n: jnp.asarray(v)
                                    for n, v in params.items()}, batches[0])
    want = [float(jsess.run(b)["loss"]) for b in batches[:3]]
    want += [float(m["loss"]) for m in jsess.fit(iter(batches[3:]))]
    jeval = jsess.evaluate(batches[:2])
    jadt.reset()
    ad = _port_ad()
    with pytest.raises(ValueError, match="no model built"):
        ad.create_distributed_session()
    sess = ad.create_distributed_session(
        port_loss, functools.partial(torch.optim.Adam, lr=0.1),
        _torch(params), batches[0])
    assert isinstance(sess, WrappedSession)
    assert sess.state is ad.runner.state
    got = [float(sess.run(b)["loss"]) for b in batches[:2]]
    got += [float(sess.run(**batches[2])["loss"])]
    got += [float(m["loss"]) for m in sess.fit(iter(batches[3:]))]
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(sess.evaluate(batches[:2])["loss"],
                               jeval["loss"], **TOL)
    out = sess.predict(batches[0], lambda p, b: {"emb": p["emb"] * 1})
    np.testing.assert_array_equal(out["emb"],
                                  sess.gather_params()["emb"].numpy())
    # a second session wraps the same runner
    assert ad.create_distributed_session().state is sess.state


def _opaque(seed=3):
    """``tests/test_step_fn.py``'s problem: a state bundling params and
    momentum, its step in JAX and in torch, and a batch."""
    rng = np.random.RandomState(seed)
    w = (rng.randn(16, 4) * 0.3).astype(np.float32)
    b = np.zeros((4,), np.float32)
    state = {"w": w, "b": b, "mom": {"w": np.zeros_like(w),
                                     "b": np.zeros_like(b)}}
    batch = {"x": rng.randn(32, 16).astype(np.float32),
             "y": rng.randn(32, 4).astype(np.float32)}

    def jax_step(state, batch):
        def loss(p):
            return jnp.mean((batch["x"] @ p["w"] + p["b"] - batch["y"]) ** 2)
        val, g = jax.value_and_grad(loss)({"w": state["w"],
                                           "b": state["b"]})
        mom = {k: 0.9 * state["mom"][k] + g[k] for k in g}
        return {"w": state["w"] - 0.1 * mom["w"],
                "b": state["b"] - 0.1 * mom["b"], "mom": mom}, {"loss": val}

    def port_step(state, batch):
        p = {k: state[k].detach().requires_grad_() for k in ("w", "b")}
        val = ((batch["x"] @ p["w"] + p["b"] - batch["y"]) ** 2).mean()
        gw, gb = torch.autograd.grad(val, [p["w"], p["b"]])
        mom = {"w": 0.9 * state["mom"]["w"] + gw,
               "b": 0.9 * state["mom"]["b"] + gb}
        # the keys in another order than the template's: the structure
        # is the tree, not the dict order
        return {"mom": mom, "b": state["b"] - 0.1 * mom["b"],
                "w": state["w"] - 0.1 * mom["w"]}, {"loss": val}
    return state, jax_step, port_step, batch


def _tstate(state):
    return {k: (_tstate(v) if isinstance(v, dict) else torch.as_tensor(v))
            for k, v in state.items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = prefix + "/" + k if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict)
                   else {name: np.asarray(v)})
    return out


def test_build_step_matches_jax():
    state, jax_step, port_step, batch = _opaque()
    jr = _jax_ad().build_step(jax_step, jax.tree_util.tree_map(
        jnp.asarray, state), batch)
    jr.init(jax.tree_util.tree_map(jnp.asarray, state))
    want = [float(jr.run(batch)["loss"]) for _ in range(5)]
    jfinal = _flat(jax.tree_util.tree_map(np.asarray, jr.gather_params()))
    jadt.reset()
    runner = _port_ad().build_step(port_step, _tstate(state), batch)
    runner.init(_tstate(state))
    got = [float(runner.run(batch)["loss"]) for _ in range(5)]
    np.testing.assert_allclose(got, want, **TOL)
    final = _flat({k: v for k, v in runner.gather_params().items()})
    assert sorted(final) == sorted(jfinal) == ["b", "mom/b", "mom/w", "w"]
    for k in jfinal:
        np.testing.assert_allclose(final[k], jfinal[k], err_msg=k, **TOL)
    assert runner.state.step == 5 and runner.state.opt_state == {}
    with pytest.raises(ValueError, match="no loss to evaluate"):
        runner.evaluate([batch])


def test_step_fn_plan_bytes_match_jax():
    """The step_fn item names the state's leaves by their paths, so the
    AllReduce plan serializes to the JAX package's bytes (and the item's
    spec to the JAX item's)."""
    state, jax_step, port_step, batch = _opaque()
    state["batch_stats"] = {"mean": np.zeros((4,), np.float32)}
    jitem = JModelItem(step_fn=jax_step, params=jax.tree_util.tree_map(
        jnp.asarray, state), example_batch=batch).prepare()
    titem = ModelItem(step_fn=port_step, params=_tstate(state),
                      example_batch=batch).prepare()
    assert list(titem.var_infos) == list(jitem.var_infos)
    assert titem.trainable_var_names == jitem.trainable_var_names
    for chunk in (128, 2):
        jplan = jstrategy.AllReduce(chunk_size=chunk).build(
            jitem, JSpec.from_dict(SPEC))
        tplan = strategy.AllReduce(chunk_size=chunk).build(
            titem, ResourceSpec.from_dict(SPEC))
        tplan.id = jplan.id
        assert json.dumps(tplan.to_dict(), sort_keys=True) == \
            json.dumps(jplan.to_dict(), sort_keys=True)
    assert json.dumps(titem.to_spec_dict(), sort_keys=True) == \
        jitem.serialize_spec().decode()


def test_build_step_refusals(monkeypatch):
    state, _, port_step, batch = _opaque()

    def bad(state, batch):
        return state  # no metrics

    def wrong(state, batch):
        return {"w": state["w"]}, {}
    ad = _port_ad()
    with pytest.raises(ValueError, match="must return"):
        ad.build_step(bad, _tstate(state), batch)
    with pytest.raises(ValueError, match="do not match"):
        ad.build_step(wrong, _tstate(state), batch)
    adt.reset()
    # N > 1: the opaque step's gradients cannot be synced
    from autodist_tpu_torch import autodist as tautodist
    monkeypatch.setattr(tautodist, "process_group_replicas",
                        lambda: ReplicaInfo(2, 0))
    two = {"nodes": [{"address": "127.0.0.1", "chief": True,
                      "cpus": [0, 1]}]}
    ad = adt.AutoDist(strategy_builder=strategy.AllReduce(), device="cpu",
                      resource_spec=ResourceSpec.from_dict(two))
    with pytest.raises(NotImplementedError, match="ROADMAP A item 13"):
        ad.build_step(port_step, _tstate(state), batch)


def test_step_fn_compressor_is_ignored_with_a_warning(monkeypatch):
    from autodist_tpu_torch.utils import logging as tlogging
    warned = []
    monkeypatch.setattr(tlogging, "warning",
                        lambda msg, *a: warned.append(msg % a))
    state, _, port_step, batch = _opaque()
    ad = adt.AutoDist(strategy_builder=strategy.AllReduce(
        compressor="HorovodCompressor"), device="cpu")
    runner = ad.build_step(port_step, _tstate(state), batch)
    assert any("ignores compressor HorovodCompressor" in w for w in warned)
    runner.init(_tstate(state))
    assert np.isfinite(float(runner.run(batch)["loss"]))


def test_step_fn_checkpoint_roundtrip(tmp_path):
    """As ``tests/test_step_fn.py::test_step_fn_checkpoint_roundtrip``: the
    state saves under its paths (loadable with numpy alone) and restores
    bit for bit; retraining from the restore matches the run without it.
    The JAX package's saver restores the same file into its own step_fn
    runner."""
    from autodist_tpu_torch.checkpoint.saver import Saver
    state, jax_step, port_step, batch = _opaque()
    runner = _port_ad().build_step(port_step, _tstate(state), batch)
    runner.init(_tstate(state))
    for _ in range(3):
        runner.run(batch)
    saved = _flat({k: v for k, v in runner.gather_params().items()})
    saver = Saver(directory=str(tmp_path))
    path = saver.save(runner)
    flat = dict(np.load(path + ".params.npz"))
    assert flat["w"].shape == (16, 4) and flat["mom/w"].shape == (16, 4)
    assert dict(np.load(path + ".opt.npz")) == {}
    for _ in range(2):
        runner.run(batch)
    final_a = _flat({k: v for k, v in runner.gather_params().items()})
    _, step = saver.restore(runner)
    assert step == 3
    for _ in range(2):
        runner.run(batch)
    final_b = _flat({k: v for k, v in runner.gather_params().items()})
    for k in final_a:
        np.testing.assert_array_equal(final_a[k], final_b[k], err_msg=k)
    adt.reset()
    from autodist_tpu.checkpoint.saver import Saver as JSaver
    jr = _jax_ad().build_step(jax_step, jax.tree_util.tree_map(
        jnp.asarray, state), batch)
    jr.init(jax.tree_util.tree_map(jnp.asarray, state))
    _, step = JSaver(directory=str(tmp_path)).restore(jr, path)
    assert step == 3
    got = _flat(jax.tree_util.tree_map(np.asarray, jr.gather_params()))
    for k, v in saved.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
