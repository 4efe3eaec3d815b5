"""autodist_tpu_torch micro-batcher, held to the JAX package.

- The port's ``MicroBatcher`` over its ``InferenceEngine`` against the
  JAX ones on ``tests/test_serving.py``'s embedding scorer (same params, no
  training step), under ``PS()`` and ``AllReduce()``: every fanned-out row
  within 1e-6 of the JAX batcher's.
- The batcher's own contracts, the port counterparts of
  ``tests/test_serving.py``'s: fan-out and grouping, queue-full and close
  sheds, survival after group errors, the queue-depth gauge, the
  Retry-After hints and their clamp, per-request deadlines, brownout, the
  ``stats()`` autoscale sub-dict, and the knobs' validation with the JAX
  messages. The degradation paths run on a pure-Python engine stand-in,
  as the JAX tests do: they are the batcher's, not the program's.
"""
import functools
import threading
import time
from unittest import mock

import numpy as np
import pytest
import torch

import autodist_tpu_torch as adt
from autodist_tpu import strategy as jS
from autodist_tpu.serving import InferenceEngine as JEngine
from autodist_tpu.serving import MicroBatcher as JBatcher
from autodist_tpu.serving import ServingConfig as JConfig
from autodist_tpu_torch import strategy
from autodist_tpu_torch.serving import (InferenceEngine, MicroBatcher,
                                        ServingConfig, ServingUnavailable)
from autodist_tpu_torch.telemetry import spans as tel
from test_serving import _build_runner, _make_problem


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


def _torch_fns():
    def loss_fn(p, batch):
        feat = p["emb"][torch.as_tensor(batch["ids"]).long()]
        pred = feat @ p["w"] + p["b"]
        return torch.mean((pred - torch.as_tensor(batch["y"])) ** 2)

    def serve_fn(p, batch):
        feat = p["emb"][torch.as_tensor(batch["ids"]).long()]
        return {"score": feat @ p["w"] + p["b"]}
    return loss_fn, serve_fn


def _port_runner(builder):
    params, _, _, batch, requests = _make_problem()
    loss_fn, serve_fn = _torch_fns()
    ad = adt.AutoDist(strategy_builder=builder, device="cpu")
    runner = ad.build(loss_fn, functools.partial(torch.optim.Adam, lr=0.1),
                      params, batch)
    runner.init(params)
    return runner, serve_fn, requests


def _expected(runner, ids):
    full = {k: np.asarray(v) for k, v in runner.gather_params().items()}
    return np.take(full["emb"], np.asarray(ids), axis=0) @ full["w"] \
        + full["b"]


BUILDERS = [("PS", strategy.PS, jS.PS),
            ("AllReduce", strategy.AllReduce, jS.AllReduce)]


@pytest.mark.parametrize("name,make,make_jax", BUILDERS,
                         ids=[b[0] for b in BUILDERS])
def test_batcher_rows_equal_jax(name, make, make_jax):
    jrunner, jserve, _, requests = _build_runner(make_jax, train_steps=0)
    jengine = JEngine(jrunner, jserve, requests[0],
                      JConfig(buckets=(8, 16), max_delay_ms=20.0)).warmup()
    with JBatcher(jengine) as jmb:
        want = [f.result(timeout=60)["score"]
                for f in [jmb.submit(r) for r in requests]]
    runner, serve_fn, _ = _port_runner(make())
    engine = InferenceEngine(runner, serve_fn, requests[0],
                             ServingConfig(buckets=(8, 16),
                                           max_delay_ms=20.0)).warmup()
    with MicroBatcher(engine) as mb:
        futures = [mb.submit(r) for r in requests]
        got = [f.result(timeout=60)["score"] for f in futures]
        stats = mb.stats()
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == (2,)
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=1e-6,
                                   err_msg=str(i))
    assert stats["requests"] == stats["fan_out"] == len(requests)
    assert stats["errors"] == 0 and stats["shed"] == 0
    # grouped: 16 requests enqueued inside one 20 ms deadline
    assert stats["batches"] < len(requests)
    assert stats["p50_ms"] is not None and stats["p99_ms"] >= stats["p50_ms"]
    assert stats["recompiles_after_warmup"] == 0


# ------------------------------------------------ batcher over the engine


def test_fan_out_per_request_and_predict_one():
    runner, serve_fn, requests = _port_runner(strategy.PS())
    runner.run(_make_problem()[3])    # serve values that moved
    engine = InferenceEngine(runner, serve_fn, requests[0],
                             ServingConfig(buckets=(8, 16),
                                           max_delay_ms=20.0)).warmup()
    with MicroBatcher(engine) as mb:
        futures = [(r, mb.submit(r)) for r in requests[:12]]
        for r, f in futures:
            np.testing.assert_allclose(
                f.result(timeout=30)["score"], _expected(runner, r["ids"]),
                rtol=1e-5, atol=1e-6)
        one = mb.predict_one(requests[0], timeout=30)
        np.testing.assert_allclose(one["score"],
                                   _expected(runner, requests[0]["ids"]),
                                   rtol=1e-5, atol=1e-6)
        stats = mb.stats()
    assert stats["requests"] == 13 and stats["fan_out"] == 13
    assert stats["batches"] < 13


def test_sheds_on_queue_full_and_close(monkeypatch):
    runner, serve_fn, requests = _port_runner(strategy.PS())
    engine = InferenceEngine(runner, serve_fn, requests[0],
                             ServingConfig(buckets=(8,),
                                           max_queue=2)).warmup()
    release = threading.Event()
    real_run = engine.run_batch

    def slow_run(reqs):
        release.wait(timeout=30)
        return real_run(reqs)

    monkeypatch.setattr(engine, "run_batch", slow_run)
    mb = MicroBatcher(engine)
    try:
        first = mb.submit(requests[0])    # taken by the (blocked) worker
        time.sleep(0.1)
        queued = [mb.submit(r) for r in requests[1:3]]
        with pytest.raises(ServingUnavailable, match="queue full"):
            mb.submit(requests[3])
        assert mb.stats()["shed"] == 1
    finally:
        release.set()
    first.result(timeout=30)
    for f in queued:
        f.result(timeout=30)
    mb.close()
    with pytest.raises(ServingUnavailable, match="closed"):
        mb.submit(requests[0])


def test_close_fails_still_queued_futures(monkeypatch):
    runner, serve_fn, requests = _port_runner(strategy.PS())
    engine = InferenceEngine(runner, serve_fn, requests[0],
                             ServingConfig(buckets=(8,))).warmup()
    hold = threading.Event()
    real_run = engine.run_batch
    monkeypatch.setattr(
        engine, "run_batch",
        lambda reqs: (hold.wait(timeout=30), real_run(reqs))[1])
    mb = MicroBatcher(engine)
    mb.submit(requests[0])
    time.sleep(0.1)
    straggler = mb.submit(requests[1])
    threading.Timer(0.3, hold.set).start()
    mb.close()
    if not straggler.done():
        straggler.result(timeout=1)
    else:
        exc = straggler.exception(timeout=1)
        assert exc is None or isinstance(exc, ServingUnavailable)


def test_survives_group_errors_and_typed_sheds(monkeypatch):
    runner, serve_fn, requests = _port_runner(strategy.PS())
    engine = InferenceEngine(runner, serve_fn, requests[0],
                             ServingConfig(buckets=(8,),
                                           max_delay_ms=1.0)).warmup()
    with MicroBatcher(engine) as mb:
        bad = mb.submit({"user": np.int64(0)})   # not the feed's tree
        with pytest.raises(Exception) as ei:
            bad.result(timeout=30)
        assert not isinstance(ei.value, ServingUnavailable)
        real_run = engine.run_batch
        monkeypatch.setattr(
            engine, "run_batch",
            mock.MagicMock(side_effect=ServingUnavailable("window out")))
        with pytest.raises(ServingUnavailable):
            mb.submit(requests[0]).result(timeout=30)
        monkeypatch.setattr(engine, "run_batch", real_run)
        good = mb.submit(requests[1])   # the worker is still alive
        np.testing.assert_allclose(good.result(timeout=30)["score"],
                                   _expected(runner, requests[1]["ids"]),
                                   rtol=1e-5, atol=1e-6)
        stats = mb.stats()
    assert stats["errors"] == 1 and stats["shed"] >= 1


# ------------------------------------- degradation paths (engine stand-in)


class _FakeEngine:
    """The engine surface the batcher consumes. ``block`` parks the FIRST
    dispatch until set, so a queue piles up behind a busy worker."""

    chief = True

    def __init__(self, config=None, block=None):
        self.config = config or ServingConfig(buckets=(8,), max_delay_ms=0.0)
        self.max_batch = 8
        self.buckets = (8,)
        self.stats = {"padded_rows": 0}
        self._block = block

    def run_batch(self, requests):
        if self._block is not None:
            self._block.wait(timeout=30)
        return list(requests), len(requests)

    def fan_out(self, fetched, n):
        return fetched

    def recompiles_after_warmup(self):
        return 0

    def close(self):
        pass


def _gauge():
    return tel.gauges().get("serve.queue_depth")


def test_queue_depth_gauge_fresh_after_traffic_stops():
    mb = MicroBatcher(_FakeEngine())
    for f in [mb.submit({"x": i}) for i in range(6)]:
        f.result(timeout=5)
    deadline = time.perf_counter() + 5
    while _gauge() != 0 and time.perf_counter() < deadline:
        time.sleep(0.005)
    assert _gauge() == 0
    mb.close()


def test_queue_depth_gauge_zero_after_drain():
    block = threading.Event()
    mb = MicroBatcher(_FakeEngine(block=block))
    mb.submit({"x": 0})
    time.sleep(0.05)
    for i in range(4):
        mb.submit({"x": i})
    assert _gauge() >= 1
    threading.Timer(0.1, block.set).start()
    assert mb.drain(timeout=10) >= 1
    assert _gauge() == 0


def test_queue_full_shed_carries_computed_clamped_retry_after():
    block = threading.Event()
    mb = MicroBatcher(_FakeEngine(block=block), max_queue=2)
    mb.submit({"x": 0})
    time.sleep(0.05)
    mb.submit({"x": 1})
    mb.submit({"x": 2})
    with pytest.raises(ServingUnavailable) as ei:
        mb.submit({"x": 3})
    # no group has completed: the drain knob is the fallback
    assert ei.value.retry_after_s == pytest.approx(5.0)
    block.set()
    deadline = time.perf_counter() + 5
    while mb._drain_rate is None and time.perf_counter() < deadline:
        time.sleep(0.005)
    retry = mb._computed_retry_after(depth=4)
    assert 0.05 <= retry <= 60.0
    # the clamp at both ends, and the oldest queued request's floor
    mb._drain_rate = 1e9
    assert mb._computed_retry_after(depth=1) == pytest.approx(0.05)
    mb._drain_rate = 1e-9
    assert mb._computed_retry_after(depth=1) == pytest.approx(60.0)
    mb.close()


def test_closed_and_draining_sheds_carry_retry_after():
    mb = MicroBatcher(_FakeEngine())
    mb.close()
    with pytest.raises(ServingUnavailable, match="closed") as ei:
        mb.submit({"x": 0})
    assert ei.value.retry_after_s == pytest.approx(5.0)
    mb2 = MicroBatcher(_FakeEngine())
    assert mb2.drain(retry_after_s=2.5) == 0
    with pytest.raises(ServingUnavailable, match="draining") as ei:
        mb2.submit({"x": 0})
    assert ei.value.retry_after_s == pytest.approx(2.5)


def test_close_while_queued_sheds_with_retry_after():
    block = threading.Event()
    mb = MicroBatcher(_FakeEngine(block=block))
    f0 = mb.submit({"x": 0})
    time.sleep(0.05)
    queued = [mb.submit({"x": i}) for i in range(2)]
    mb.close(timeout=0.2)
    for f in queued:
        with pytest.raises(ServingUnavailable) as ei:
            f.result(timeout=5)
        assert ei.value.retry_after_s == pytest.approx(5.0)
    block.set()
    f0.result(timeout=5)


def test_expired_deadline_sheds_before_dispatch():
    block = threading.Event()
    mb = MicroBatcher(_FakeEngine(block=block))
    before = tel.counters().get("serve.deadline_shed", 0.0)
    mb.submit({"x": 0})
    time.sleep(0.05)
    doomed = mb.submit({"x": 1}, deadline_s=0.01)
    alive = mb.submit({"x": 2})
    time.sleep(0.05)
    block.set()
    assert alive.result(timeout=5) == {"x": 2}
    with pytest.raises(ServingUnavailable) as ei:
        doomed.result(timeout=5)
    assert ei.value.retry_after_s is not None
    assert mb.stats_local["deadline_shed"] == 1
    assert tel.counters()["serve.deadline_shed"] == before + 1
    mb.close()


def test_brownout_widens_group_deadline_under_sustained_overload():
    block = threading.Event()
    cfg = ServingConfig(buckets=(8,), max_delay_ms=1.0, max_queue=8,
                        brownout_queue_frac=0.5, brownout_sustain_s=0.0,
                        brownout_delay_factor=3.0)
    mb = MicroBatcher(_FakeEngine(config=cfg, block=block))
    mb.submit({"x": 0})
    time.sleep(0.05)
    for i in range(6):
        mb.submit({"x": i})
    assert mb.stats()["brownout"] == {"active": True, "entries": 1}
    assert mb._effective_delay_s == pytest.approx(3.0 * mb.max_delay_s)
    assert tel.counters().get("serve.brownouts", 0.0) >= 1
    block.set()
    deadline = time.perf_counter() + 5
    while (mb.stats()["brownout"]["active"]
           and time.perf_counter() < deadline):
        time.sleep(0.005)
    assert mb.stats()["brownout"]["active"] is False
    assert mb._effective_delay_s == pytest.approx(mb.max_delay_s)
    mb.close()


def test_stats_autoscale_subdict_stable_keys():
    mb = MicroBatcher(_FakeEngine())
    stats = mb.stats()
    assert set(stats["autoscale"]) == {"grows", "shrinks", "holds",
                                       "refusals"}
    assert stats["drain_rate_rps"] is None
    assert stats["oldest_queue_age_s"] is None
    mb.close()


@pytest.mark.parametrize("kw,match", [
    (dict(max_delay_ms=-1), "max_delay_ms must be >= 0"),
    (dict(max_queue=0), "max_queue must be >= 1"),
    (dict(degraded_batches=-1), "degraded_batches must be >= 0"),
    (dict(brownout_queue_frac=0.0), "brownout_queue_frac"),
    (dict(brownout_sustain_s=-1.0), "brownout_sustain_s"),
    (dict(brownout_delay_factor=0.5), "brownout_delay_factor"),
], ids=["delay", "queue", "degraded", "frac", "sustain", "factor"])
def test_config_validation_with_the_jax_messages(kw, match):
    with pytest.raises(ValueError, match=match) as mine:
        ServingConfig(**kw)
    with pytest.raises(ValueError) as theirs:
        JConfig(**kw)
    assert str(mine.value) == str(theirs.value)
