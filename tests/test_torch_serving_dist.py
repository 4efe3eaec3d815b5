"""autodist_tpu_torch serving at N = 2 ranks, held to the JAX package.

One two-process gloo job (``serve_job`` in ``tests/torch_dist_worker.py``)
runs every case in the same two processes, one controller (rank 0) and
one executor:

- ``InferenceEngine`` under ``AllReduce()`` and ``PS()``: each request
  group's per-example outputs within 1e-5 of the JAX engine's on its 8
  virtual devices (same params, same buckets), a float scalar reduced as
  the JAX ``pmean`` and an int one as its ``pmax``; ``Runner.predict`` and
  ``WrappedSession.predict`` (SPMD calls) the same against the JAX
  runner's; the default buckets rounded to multiples of 2, and a bucket
  that is not one raising the JAX ``ValueError``; the follower refusing to
  dispatch and its loop ending at the chief's close.
- ``DecodeEngine`` on lm.tiny from the converted JAX init, flash decode:
  ``tests/test_decode.py``'s 12 prompts through 8 slots (4 a rank), an EOS
  stop and a request its prefill alone satisfies, every token equal to
  greedy full recompute through the JAX model; 3 slots raise the JAX
  ``ValueError``.
- ``MicroBatcher`` under ``PS()``: four client threads on the chief, every
  row within 1e-6 of the params applied in numpy; then
  ``preemption.drain_serving`` on the chief sheds the queued requests
  typed, returns their count, and ends the follower's loop.
- Failures: a follower's failing host-PS refresh serves its last
  snapshot within the degraded window, then sheds typed on both ranks,
  then recovers; a malformed request fails on both ranks, and the loop
  serves the next group.
- Stored shards: ``PartitionedAR()`` serves from each rank's half of a
  variable, gathered whole for each dispatch (within 1e-5 of numpy); a
  ``TensorParallel(2)`` plan serves under its model axis (``Runner.
  predict`` on each rank's slices, within 1e-5 of numpy) and builds its
  decode program (the engines under a model or expert axis:
  ``tests/test_torch_serving_mesh.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from autodist_tpu import strategy as jS
from autodist_tpu.models import lm as jlm
from autodist_tpu.serving import InferenceEngine as JEngine
from autodist_tpu.serving import ServingConfig as JConfig
from test_serving import _build_runner, _make_problem
from test_torch_sentinel import _big_problem, _mlp_problem
from test_torch_lm import jax_greedy
from torch_dist_worker import launch

BUCKETS = (8, 16)
GROUPS = (3, 8, 11, 16)
DRAIN_RETRY_S = 2.5


def jax_serve(p, b):
    score = jnp.take(p["emb"], b["ids"], axis=0) @ p["w"] + p["b"]
    return {"score": score, "mean": jnp.mean(score), "top": jnp.max(b["ids"])}


def _decode_case():
    cfg = jlm.LMConfig.tiny()
    _, jparams, _, japply = jlm.make_train_setup(cfg, seq_len=16,
                                                 batch_size=8,
                                                 lean_head=False)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, cfg.vocab_size, (1 + i % 6,)).astype(np.int32)
               for i in range(12)]
    caps = [3 + (i * 3) % 8 for i in range(12)]
    caps[5] = 1   # satisfied by its prefill alone
    raw = [toks[:cap] for toks, cap in
           zip(jax_greedy(japply, jparams, prompts, max(caps)), caps)]
    eos_id = raw[0][2]
    expected = [toks[:toks.index(eos_id) + 1] if eos_id in toks else toks
                for toks in raw]
    case = {"name": "decode", "kind": "decode", "decode_attn": "flash",
            "jax_params": jax.tree_util.tree_map(np.asarray, jparams),
            "prompts": prompts, "caps": caps, "eos_id": int(eos_id)}
    return case, expected


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    params, _, _, batch, requests = _make_problem()
    want = {}
    cases = []
    for name, make in (("AllReduce", jS.AllReduce), ("PS", jS.PS)):
        runner, _, _, _ = _build_runner(make, train_steps=0)
        engine = JEngine(runner, jax_serve, requests[0],
                         JConfig(buckets=BUCKETS))
        want[name] = {
            "groups": [engine.run_batch(requests[:n])[0] for n in GROUPS],
            "predict": runner.predict({"ids": batch["ids"]}, jax_serve)}
        cases.append({"name": name, "kind": "engine", "builder": name,
                      "params": params, "batch": batch,
                      "requests": requests, "buckets": BUCKETS,
                      "groups": GROUPS})
    decode, want["decode"] = _decode_case()
    cases.append(decode)
    cases.append({"name": "batcher", "kind": "batcher", "builder": "PS",
                  "params": params, "batch": batch,
                  "requests": requests * 2})
    cases.append({"name": "faults", "kind": "faults", "params": params,
                  "batch": batch, "requests": requests})
    big, big_batch = _big_problem()
    mlp, mlp_batch = _mlp_problem()
    cases.append({"name": "storage", "kind": "storage", "big": big,
                  "big_batch": big_batch, "mlp": mlp, "mlp_batch": mlp_batch})
    want["storage"] = (big_batch["x"][:5] @ big["big"]) @ big["w"]
    h = np.maximum(mlp_batch["x"] @ mlp["fc1/w"] + mlp["fc1/b"], 0)
    want["tp_y"] = h @ mlp["fc2/w"] + mlp["fc2/b"]
    ranks = launch("serve", 2, tmp_path_factory.mktemp("serve"), cases)
    return ranks, want, params, requests


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("builder", ["AllReduce", "PS"])
def test_engine_outputs_equal_jax(job, builder):
    ranks, want, _, _ = job
    chief = ranks[0][builder]
    for n, got, ref in zip(GROUPS, chief["groups"], want[builder]["groups"]):
        assert got["score"].shape == (n, 2)
        _close(got["score"], ref["score"], 1e-5)
        # the scalars over the whole padded bucket: pmean and pmax
        _close(got["mean"], ref["mean"], 1e-5)
        assert int(got["top"]) == int(ref["top"])
    np.testing.assert_array_equal(
        np.stack([r["score"] for r in chief["rows"]]),
        chief["groups"][0]["score"])
    # the follower ran every dispatch the chief did (warmup included)
    assert ranks[1][builder]["batches"] == chief["batches"]


@pytest.mark.parametrize("builder", ["AllReduce", "PS"])
def test_runner_and_session_predict_equal_jax(job, builder):
    ranks, want, _, _ = job
    ref = want[builder]["predict"]
    for rank in ranks:
        for key in ("predict", "session"):
            got = rank[builder][key]
            _close(got["score"], ref["score"], 1e-5)
            _close(got["mean"], ref["mean"], 1e-5)
            assert int(got["top"]) == int(ref["top"])


def test_buckets_at_two_ranks_follow_jax(job):
    ranks, _, _, _ = job
    for rank in ranks:
        got = rank["AllReduce"]
        assert tuple(got["default_buckets"]) == \
            JEngine._resolve_buckets(None, 2) == (2, 8, 32, 128)
        with pytest.raises(ValueError) as theirs:
            JEngine._resolve_buckets((3,), 2)
        assert got["bad_bucket"] == str(theirs.value)


def test_follower_runs_the_chiefs_dispatches_only(job):
    ranks, _, _, _ = job
    for name in ("AllReduce", "PS"):
        follower = ranks[1][name]
        assert "on a follower" in follower["follower_run_batch"]
        assert follower["followed"] is True


def test_decode_tokens_equal_jax_greedy(job):
    ranks, want, _, _ = job
    chief, follower = ranks[0]["decode"], ranks[1]["decode"]
    expected = want["decode"]
    eos_id = expected[0][-1]
    for i, (r, exp) in enumerate(zip(chief["results"], expected)):
        assert list(map(int, r["tokens"])) == exp, i
        assert r["finished"] == ("eos" if exp[-1] == eos_id else "length")
    assert len(chief["results"][5]["tokens"]) == 1
    stats = chief["stats"]
    assert stats["completed"] == stats["evictions"] == 12
    assert stats["errors"] == 0
    # every step ran on both ranks, each on its 4 slots
    assert follower["stats"]["steps"] == stats["steps"] > 0
    assert chief["cache_slots"] == follower["cache_slots"] == 4
    assert "on a follower" in follower["follower_submit"]
    assert follower["followed"] is True
    for rank in ranks:
        assert rank["decode"]["bad_slots"] == (
            "decode slot count 3 is not divisible by the batch-axes mesh "
            "extent 2 — pick slots as a multiple of the data-parallel "
            "degree")


def test_batcher_at_two_ranks_and_the_chiefs_drain(job):
    ranks, _, params, requests = job
    chief, follower = ranks[0]["batcher"], ranks[1]["batcher"]
    reqs = requests * 2
    for r, row in zip(reqs, chief["rows"]):
        want = params["emb"][r["ids"]] @ params["w"] + params["b"]
        _close(row, want, 1e-6)
    stats = chief["stats"]
    assert stats["requests"] == stats["fan_out"] == len(reqs)
    assert stats["errors"] == 0 and stats["shed"] == 0
    assert stats["batches"] < len(reqs)
    # the drain: the in-flight request completes, the 5 queued shed typed
    _close(chief["first"], chief["rows"][0], 0)
    assert chief["typed"] == [DRAIN_RETRY_S] * 5
    assert chief["shed"] == 5
    assert chief["late"] == DRAIN_RETRY_S
    assert chief["plane_stopped"] is True
    assert "on a follower" in follower["follower_submit"]
    assert follower["followed"] is True and follower["drained"] == 0


def test_storage_shards_serve_and_model_axes_refuse(job):
    """Partitioned storage serves, and so does a model axis: the name is
    older than the model axis's serving, which once refused."""
    ranks, want, _, _ = job
    _close(ranks[0]["storage"]["y"], want["storage"], 1e-5)
    for rank in ranks:
        got = rank["storage"]
        assert got["stored"] == [32, 8]     # half of big's 64 rows
        # a model axis no longer refuses: each rank serves its slices
        assert got["tp_w1"] == [8, 8]       # half of fc1's 16 columns
        _close(got["tp_y"], want["tp_y"], 1e-5)
        assert got["decode_local"] is True


def test_follower_snapshot_window_and_errors_reach_the_chief(job):
    ranks, _, params, requests = job
    chief, follower = ranks[0]["faults"], ranks[1]["faults"]
    want = np.stack([params["emb"][r["ids"]] @ params["w"] + params["b"]
                     for r in requests[:3]])
    got = chief["got"]
    for i in (0, 1, 3, 5):          # 1: the follower's degraded batch
        _close(got[i], want, 1e-6)
    assert got[2].startswith("shed: ") and "another rank" in got[2]
    assert got[4] == "error: KeyError"
    assert follower["stats"]["degraded"] == 1
    assert chief["stats"]["degraded"] == 0
    assert follower["followed"] is True
