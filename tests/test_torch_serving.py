"""autodist_tpu_torch serving slice: build -> init -> DecodeEngine on the
CPU, held to the JAX package.

The engine runs the request mix of tests/test_decode.py (12 overlapping
prompts through 8 slots, an EOS stop, a request its prefill alone
satisfies) with both decode paths, on the JAX init converted with
``params_from_jax``; every result equals greedy full recompute through the
JAX model, token for token. Also: the scheduler/config probes, the
package's import isolation from JAX, and the device rule of the entry
points.
"""
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import autodist_tpu_torch as adt
from autodist_tpu.models import lm as jlm
from autodist_tpu_torch import strategy
from autodist_tpu_torch.convert import params_from_jax
from autodist_tpu_torch.models import lm as tlm
from autodist_tpu_torch.serving import (InferenceEngine, ServingConfig,
                                        ServingUnavailable)
from autodist_tpu_torch.serving.decode import (DecodeConfig, DecodeEngine,
                                               SlotScheduler)
from autodist_tpu_torch.serving.engine import stack_batches
from test_torch_lm import jax_greedy


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


@pytest.fixture(scope="module")
def lm_setup():
    """JAX tiny-LM params, the port's converted copy, and the request mix
    with its JAX greedy ground truth (EOS cut applied)."""
    cfg = jlm.LMConfig.tiny()
    _, jparams, _, japply = jlm.make_train_setup(cfg, seq_len=16,
                                                 batch_size=8,
                                                 lean_head=False)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, cfg.vocab_size, (1 + i % 6,)).astype(np.int32)
               for i in range(12)]
    caps = [3 + (i * 3) % 8 for i in range(12)]
    caps[5] = 1  # satisfied by its prefill alone — never occupies a slot
    raw = [toks[:cap] for toks, cap in
           zip(jax_greedy(japply, jparams, prompts, max(caps)), caps)]
    eos_id = raw[0][2]
    expected = [toks[:toks.index(eos_id) + 1] if eos_id in toks else toks
                for toks in raw]
    return tparams, prompts, caps, eos_id, expected


def _runner(tparams, device="cpu"):
    cfg = tlm.LMConfig.tiny()
    loss_fn, _, batch, _ = tlm.make_train_setup(cfg, seq_len=16,
                                                batch_size=8)
    ad = adt.AutoDist(strategy_builder=strategy.AllReduce(), device=device)
    runner = ad.build(loss_fn, None, tparams, batch)
    runner.init(tparams)
    return runner, cfg


@pytest.mark.parametrize("decode_attn", ["reference", "flash"])
def test_engine_matches_jax_greedy_recompute(lm_setup, decode_attn):
    tparams, prompts, caps, eos_id, expected = lm_setup
    runner, cfg = _runner(tparams)
    engine = DecodeEngine(runner, tlm.make_decode_setup(cfg, decode_attn),
                          DecodeConfig(slots=8, max_new_tokens=8,
                                       prefill_len=8, eos_id=eos_id))
    try:
        engine.warmup()
        futures = [engine.submit(p, max_new_tokens=m)
                   for p, m in zip(prompts, caps)]
        results = [f.result(timeout=120) for f in futures]
        for i, (r, exp) in enumerate(zip(results, expected)):
            assert list(map(int, r["tokens"])) == exp, i
            assert r["finished"] == ("eos" if exp[-1] == eos_id
                                     else "length")
            assert r["prompt_len"] == len(prompts[i])
        assert results[0]["finished"] == "eos"
        assert len(results[5]["tokens"]) == 1
        stats = engine.stats()
        assert stats["completed"] == stats["evictions"] == 12
        assert stats["errors"] == 0
        assert stats["recompiles_after_warmup"] == 0
        assert stats["peak_occupancy"] > 0
        with pytest.raises(ValueError, match="prompt length"):
            engine.submit(np.zeros(9, np.int32))
    finally:
        engine.close()
    with pytest.raises(ServingUnavailable):
        engine.submit(np.zeros(2, np.int32))


def test_runner_predict_and_training_boundary(lm_setup):
    tparams = lm_setup[0]
    runner, cfg = _runner(tparams)
    setup = tlm.make_decode_setup(cfg)
    toks = np.zeros((4, 8), np.int32)
    toks[:, :3] = [[5, 9, 2]] * 4
    out = runner.predict({"tokens": toks,
                          "length": np.full(4, 3, np.int32)},
                         setup.prefill_fn)
    assert out["next_token"].shape == (4,)
    assert out["k"].shape == (4, cfg.num_layers, cfg.max_seq_len,
                              cfg.num_heads, cfg.head_dim)
    assert isinstance(out["k"], np.ndarray)
    assert runner.gather_params().keys() == tparams.keys()
    engine = InferenceEngine(runner, setup.prefill_fn,
                             {"tokens": toks[0], "length": np.int32(3)},
                             ServingConfig(buckets=(1, 4)))
    rows = engine.predict([{"tokens": toks[0], "length": np.int32(3)}] * 3)
    assert len(rows) == 3 and engine.stats["padded_rows"] == 1
    np.testing.assert_array_equal(rows[2]["next_token"], out["next_token"][0])
    np.testing.assert_allclose(rows[1]["k"], out["k"][0], atol=1e-6)
    # built without an optimizer: the runner serves, and training says why
    # it cannot (the training path itself is tests/test_torch_train.py)
    with pytest.raises(ValueError, match="without an optimizer"):
        runner.run({"tokens": toks})


def test_stack_batches_pads_by_repeating_the_last_example():
    group = [{"x": np.array([i, i])} for i in range(3)]
    out = stack_batches(group, pad_to=5)["x"]
    np.testing.assert_array_equal(out[:, 0], [0, 1, 2, 2, 2])
    with pytest.raises(ValueError, match="pad_to"):
        stack_batches(group, pad_to=2)
    with pytest.raises(ValueError, match="empty"):
        stack_batches([])


class TestSlotScheduler:
    def test_continuous_admits_into_any_freed_slot(self):
        sched = SlotScheduler(4, "continuous")
        assert sched.admissible(queued=10) == 4
        sched.occupy(0, object())
        sched.occupy(2, object())
        assert sched.free_slots() == [1, 3]
        assert sched.admissible(queued=10) == 2
        assert sched.admissible(queued=1) == 1
        assert sched.occupancy() == 0.5

    def test_static_admits_only_when_all_slots_free(self):
        sched = SlotScheduler(4, "static")
        assert sched.admissible(queued=10) == 4
        sched.occupy(1, object())
        assert sched.admissible(queued=10) == 0
        sched.evict(1)
        assert sched.admissible(queued=2) == 2

    def test_evict_frees_for_readmission(self):
        sched = SlotScheduler(2)
        a, b = object(), object()
        sched.occupy(0, a)
        sched.occupy(1, b)
        assert sched.admissible(queued=5) == 0
        assert sched.evict(0) is a
        assert sched.get(0) is None
        assert sched.get(1) is b
        assert sched.live_slots() == [1]
        c = object()
        sched.occupy(0, c)
        assert sched.get(0) is c

    def test_config_validation(self):
        with pytest.raises(ValueError, match="admission"):
            DecodeConfig(admission="greedy")
        with pytest.raises(ValueError):
            DecodeConfig(slots=0)
        with pytest.raises(ValueError):
            DecodeConfig(max_new_tokens=0)


def test_import_leaves_jax_and_the_jax_package_out():
    code = ("import sys, autodist_tpu_torch, autodist_tpu_torch.serving."
            "decode, autodist_tpu_torch.models.lm, autodist_tpu_torch.convert, "
            "autodist_tpu_torch.ops.flash_attention, "
            "autodist_tpu_torch.ops.xent, autodist_tpu_torch.optim, "
            "autodist_tpu_torch.runtime.runner, "
            "autodist_tpu_torch.utils.cuda_build\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'autodist_tpu'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        adt.AutoDist()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        adt.AutoDist(device="cuda")
    ad = adt.AutoDist(device="cpu")
    assert ad.device.type == "cpu"
    with pytest.raises(NotImplementedError, match="one AutoDist"):
        adt.AutoDist(device="cpu")
