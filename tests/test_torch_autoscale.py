"""autodist_tpu_torch serving autoscaler, held to the JAX package.

- ``AutoscalePolicy``: the port's and the JAX policy, built with the same
  knobs, return the same (direction, target, reason) for every sample of a
  seeded 200-sample signal trace on an injected clock, with the actuator's
  ``note_scaled`` confirmations and the replica count following the
  decisions alike.
- ``verify_autoscale`` / ``lint_policy``: ADT440/441 equal to the JAX
  rule's (codes, severities, messages) over ``tests/test_autoscale.py``'s
  strategies.
- ``FleetAutoscaler`` against the port's coordination service: the
  actuation cases of ``tests/test_autoscale.py`` (grow-on-join, the
  announced joiner first, the refusal onto a pending notice, the planned
  drain-then-shrink, the controller never retired, the epoch fence, the
  construction lint), and ``scrape_workers`` raising, naming item 11.
- The serving modules import neither JAX nor the JAX package.
"""
import socket
import subprocess
import sys
import types

import numpy as np
import pytest

from autodist_tpu.analysis import rules as jrules
from autodist_tpu.serving import autoscale as jauto
from autodist_tpu_torch.analysis import rules
from autodist_tpu_torch.analysis.diagnostics import DiagnosticError
from autodist_tpu_torch.runtime import elastic, preemption
from autodist_tpu_torch.runtime.coordination import (CoordinationClient,
                                                     CoordinationServer)
from autodist_tpu_torch.serving.autoscale import (AutoscalePolicy,
                                                  AutoscaleSignals,
                                                  FleetAutoscaler,
                                                  lint_policy)
from autodist_tpu_torch.telemetry import spans as tel

KNOBS = dict(min_replicas=1, max_replicas=4, queue_high=10.0, queue_low=2.0,
             sustain_s=1.0, grow_cooldown_s=5.0, shrink_cooldown_s=5.0)


def _policy(**kw):
    return AutoscalePolicy(**dict(KNOBS, **kw))


def _sig(depth, **kw):
    return AutoscaleSignals(queue_depth=depth, **kw)


# ------------------------------------------------------ the policy vs JAX


def _trace(seed: int, n: int = 200):
    """A seeded signal trace: regimes of overload, idle and in-band depth
    (with p99 spikes and stale scrapes now and then) on a clock that
    advances 0.05-0.6 s a sample."""
    rng = np.random.RandomState(seed)
    t, out = 0.0, []
    regime = 0
    for _ in range(n):
        if rng.rand() < 0.12:
            regime = rng.randint(3)
        depth = (rng.uniform(11, 60), rng.uniform(0, 2),
                 rng.uniform(2.5, 9.5))[regime]
        p99 = float(rng.uniform(10, 400)) if rng.rand() < 0.5 else None
        fill = float(rng.uniform(0, 8)) if rng.rand() < 0.5 else None
        ages = ({"w1": float(rng.uniform(0, 12))} if rng.rand() < 0.15
                else {})
        t += float(rng.uniform(0.05, 0.6))
        out.append((t, float(depth), p99, fill, ages))
    return out


@pytest.mark.parametrize("knobs", [
    {},
    dict(p99_high_ms=200.0, fill_low=3.0, stale_signal_s=8.0,
         min_replicas=2, max_replicas=6, sustain_s=0.5,
         grow_cooldown_s=1.0, shrink_cooldown_s=2.0),
], ids=["band_only", "p99_fill_stale"])
def test_policy_decisions_equal_jax_on_a_seeded_trace(knobs):
    mine = _policy(**knobs)
    ref = jauto.AutoscalePolicy(**dict(KNOBS, **knobs))
    replicas = mine.min_replicas
    moves = 0
    for t, depth, p99, fill, ages in _trace(7):
        got = mine.decide(AutoscaleSignals(queue_depth=depth, p99_ms=p99,
                                           batch_fill=fill,
                                           scrape_ages=dict(ages)),
                          replicas, now=t)
        want = ref.decide(jauto.AutoscaleSignals(
            queue_depth=depth, p99_ms=p99, batch_fill=fill,
            scrape_ages=dict(ages)), replicas, now=t)
        assert (got.direction, got.target, got.reason) == \
            (want.direction, want.target, want.reason), t
        assert got.to_dict() == want.to_dict()
        if got.direction != "hold":
            # the actuator confirms the move: both cooldowns stamp
            mine.note_scaled(got.direction, now=t)
            ref.note_scaled(want.direction, now=t)
            replicas = got.target
            moves += 1
    assert moves >= 2   # the trace exercises both directions' gates


def test_policy_rejects_bad_bounds():
    with pytest.raises(ValueError, match="min_replicas"):
        _policy(min_replicas=0)
    with pytest.raises(ValueError, match="clamp is empty"):
        _policy(min_replicas=3, max_replicas=2)
    with pytest.raises(ValueError, match="hysteresis band is empty"):
        _policy(queue_high=5.0, queue_low=5.0)
    with pytest.raises(ValueError, match=">= 0"):
        _policy(sustain_s=-1.0)


# --------------------------------------------------------- ADT440 / ADT441


def _ps_strategy(*hosts):
    nodes = [types.SimpleNamespace(
        var_name="v%d" % i, part_configs=None,
        synchronizer=types.SimpleNamespace(reduction_destination=h))
        for i, h in enumerate(hosts)]
    return types.SimpleNamespace(
        graph_config=types.SimpleNamespace(mesh_shape={"data": 2}),
        node_config=nodes)


def _model_parallel_strategy():
    return types.SimpleNamespace(
        graph_config=types.SimpleNamespace(
            mesh_shape={"data": 2, "model": 2}),
        node_config=[])


LINT_CASES = {
    "ps_floor": (dict(min_replicas=1),
                 _ps_strategy("10.0.0.1:7070", "10.0.0.2:7070"), None),
    "ps_at_floor": (dict(min_replicas=2),
                    _ps_strategy("10.0.0.1:7070", "10.0.0.2:7070"), None),
    "fail_fast": (dict(min_replicas=1, max_replicas=4),
                  _model_parallel_strategy(), None),
    "fail_fast_pinned": (dict(min_replicas=2, max_replicas=2),
                         _model_parallel_strategy(), None),
    "queue_high_past_max_queue": (dict(queue_high=100.0), None, 64),
    "no_sustain_no_cooldown": (dict(sustain_s=0.0, grow_cooldown_s=0.0,
                                    shrink_cooldown_s=0.0), None, None),
    "sound": ({}, None, 1024),
}


@pytest.mark.parametrize("case", sorted(LINT_CASES))
def test_verify_autoscale_equals_jax(case):
    kw, strat, max_queue = LINT_CASES[case]
    got = rules.verify_autoscale(_policy(**kw), strategy=strat,
                                 max_queue=max_queue)
    want = jrules.verify_autoscale(jauto.AutoscalePolicy(**dict(KNOBS, **kw)),
                                   strategy=strat, max_queue=max_queue)
    assert [(d.code, d.severity.name, d.message, d.fixit) for d in got] == \
        [(d.code, d.severity.name, d.message, d.fixit) for d in want]


def test_lint_policy_raises_errors_only():
    with pytest.raises(DiagnosticError, match="ADT440"):
        lint_policy(_policy(min_replicas=1),
                    strategy=_ps_strategy("10.0.0.1:7070", "10.0.0.2:7070"))
    assert lint_policy(_policy(min_replicas=2),
                       strategy=_ps_strategy("10.0.0.1:7070",
                                             "10.0.0.2:7070")) == []
    # warnings do not raise at construction
    assert [d.code for d in lint_policy(_policy(queue_high=100.0),
                                        max_queue=64)] == ["ADT441"]


# ----------------------------------------------------- actuation (a wire)


@pytest.fixture()
def server():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    srv = CoordinationServer(port=port)
    srv.start()
    yield port
    srv.stop()


@pytest.fixture(autouse=True)
def _clean_plane():
    yield
    elastic.clear()
    preemption.reset()


CHIEF = "10.0.0.1:9000"
W2 = "10.0.0.2:9000"
W3 = "10.0.0.3:9000"


def _scaler(client, signals, **kw):
    base = dict(min_replicas=1, max_replicas=4, queue_high=10.0,
                queue_low=2.0, sustain_s=0.0, grow_cooldown_s=60.0,
                shrink_cooldown_s=60.0)
    base.update(kw.pop("policy_kw", {}))
    return FleetAutoscaler(client, AutoscalePolicy(**base), CHIEF,
                           signals_fn=lambda: signals, **kw)


def test_grow_admits_pool_worker_and_prefers_the_announced_joiner(server):
    client = CoordinationClient("127.0.0.1", server)
    elastic.publish_epoch(client, 1, [CHIEF])
    before = tel.counters().get("autoscale.grows", 0.0)
    sc = _scaler(client, _sig(50), pool=[W2, W3])
    d = sc.step()
    assert d.direction == "grow" and d.target == 2
    assert elastic.read_epoch(client) == (2, [CHIEF, W2])
    assert sc.stats()["grows"] == 1
    assert tel.counters()["autoscale.grows"] == before + 1
    # W3 asks for admission, so it outranks a cold spare; the admission
    # consumes its announcement
    elastic.publish_epoch(client, 3, [CHIEF])
    elastic.announce_join(client, W3)
    _scaler(client, _sig(50), pool=[W2, W3]).step()
    assert elastic.read_epoch(client) == (4, [CHIEF, W3])
    assert not elastic.pending_join(client, W3)


def test_grow_refused_onto_pending_notice(server):
    client = CoordinationClient("127.0.0.1", server)
    elastic.publish_epoch(client, 1, [CHIEF])
    preemption.publish_notice(client, W2, deadline_s=60, reason="spot")
    sc = _scaler(client, _sig(50), pool=[W2, W3])
    assert sc.step().direction == "grow"
    assert elastic.read_epoch(client) == (2, [CHIEF, W3])
    assert sc.stats()["refusals"] == 1
    # every candidate under notice: the grow degrades to a hold
    preemption.publish_notice(client, W3, deadline_s=60, reason="spot")
    elastic.publish_epoch(client, 3, [CHIEF])
    d = _scaler(client, _sig(50), pool=[W2, W3]).step()
    assert d.direction == "hold" and "admissible" in d.reason
    assert elastic.read_epoch(client) == (3, [CHIEF])


def test_shrink_goes_through_planned_departure(server):
    client = CoordinationClient("127.0.0.1", server)
    elastic.publish_epoch(client, 1, [CHIEF, W2])
    before = tel.counters().get("preempt.notices", 0.0)
    fallback = tel.counters().get("ckpt.fallback", 0.0)
    sc = _scaler(client, _sig(0), notice_deadline_s=45.0)
    assert sc.step().direction == "shrink"
    notice = preemption.read_notice(client, W2)
    assert notice is not None and notice.reason == "autoscale-idle"
    assert elastic.read_epoch(client) == (2, [CHIEF])
    assert tel.counters()["preempt.notices"] == before + 1
    assert tel.counters().get("ckpt.fallback", 0.0) == fallback
    assert sc.stats()["shrinks"] == 1
    # the controller alone is left: at min_replicas, and never retired
    d = sc.step()
    assert d.direction == "hold"
    assert elastic.read_epoch(client) == (2, [CHIEF])


def test_stale_epoch_decision_is_fenced_and_dropped(server):
    client = CoordinationClient("127.0.0.1", server)
    elastic.publish_epoch(client, 1, [CHIEF])

    def racing_signals():
        # after step() read epoch 1, before the actuation, a rival
        # controller admits W3
        if elastic.read_epoch(client)[0] == 1:
            elastic.publish_epoch(client, 2, [CHIEF, W3])
        return _sig(50)

    sc = FleetAutoscaler(client, _policy(sustain_s=0.0, grow_cooldown_s=60.0,
                                         shrink_cooldown_s=60.0),
                         CHIEF, pool=[W2], signals_fn=racing_signals)
    d = sc.step()
    assert d.direction == "hold" and "fenced" in d.reason
    assert sc.stats()["fenced"] == 1
    assert elastic.read_epoch(client) == (2, [CHIEF, W3])
    # the cooldown was not burned: the next step grows
    assert sc.step().direction == "grow"
    assert elastic.read_epoch(client) == (3, [CHIEF, W3, W2])


def test_step_without_epoch_and_construction_lint(server):
    client = CoordinationClient("127.0.0.1", server)
    with pytest.raises(RuntimeError, match="no membership epoch"):
        _scaler(client, _sig(50)).step()
    with pytest.raises(DiagnosticError, match="ADT440"):
        FleetAutoscaler(client, _policy(min_replicas=1), CHIEF,
                        strategy=_ps_strategy("10.0.0.1:7070",
                                              "10.0.0.2:7070"))
    with pytest.raises(RuntimeError, match="no membership epoch"):
        preemption.retire_worker(client, W2)
    elastic.publish_epoch(client, 1, [CHIEF])
    with pytest.raises(RuntimeError, match="not in the current roster"):
        preemption.retire_worker(client, W2)
    assert elastic.admit_worker(client, W2) == 2
    assert elastic.admit_worker(client, W2) == 2   # already a member


def test_scrape_workers_raises_naming_item_11():
    with pytest.raises(NotImplementedError, match="item 11"):
        FleetAutoscaler(None, _policy(), CHIEF, scrape_workers=[W2])


def test_serving_modules_leave_jax_and_the_jax_package_out():
    code = ("import sys, autodist_tpu_torch.serving.batcher, "
            "autodist_tpu_torch.serving.autoscale, "
            "autodist_tpu_torch.serving.plane, autodist_tpu_torch.serving\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'autodist_tpu'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
