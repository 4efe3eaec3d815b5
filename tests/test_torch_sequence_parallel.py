"""autodist_tpu_torch's sequence parallelism against the JAX package's.

The port's ranks are spawned processes in one gloo group
(``tests/torch_dist_worker.py``'s ``sp`` job), driven through the entry
points a user calls (``AutoDist(strategy_builder=SequenceParallelAR(...)
| TensorParallel(..., seq_shards=...)).build`` -> ``Runner.init`` ->
``Runner.run`` over the host-global batches); one 2-rank and one 4-rank
job run every multi-process case. The JAX side runs in the pytest
process on the session's 8 virtual CPU devices: the primitives inside
``shard_map`` over as many devices as the port has ranks; the runners
build their mesh over every device (``parallel/mesh.py::
mesh_from_strategy``), so they train at ``{data: 8 / (sp * tp), seq:
sp[, model: tp]}`` on the same global batches: the same global weighted
mean over other row blocks.

Cases, f32:

- ring and Ulysses attention at N = 2 and 4, full and causal: this
  rank's output chunk and the gradients of ``sum(out ** 2)`` against the
  JAX functions', 1e-5; the dead final rotation (N - 1 permutes a call,
  K and V in one payload, where the JAX jaxpr holds 2 (N - 1)
  ppermutes); the ring's refusal of a dense mask and Ulysses' honouring
  of one; Ulysses' head check; ``shift_left`` on int tokens and on a
  float tensor with its gradient; ``global_weighted_mean`` and
  ``global_mean`` with the gradient;
- ``lm.tiny`` (four heads) under ``make_sp_train_setup`` at sp 2 and sp
  4, ring and Ulysses, and ``tp_lm.tiny`` at tp 2 x sp 2 and dp 2 x sp
  2, ring and Ulysses: three Adam steps (eps 1e-6, ``ADAM_EPS`` of
  ``tests/test_torch_pipeline_parallel.py``; the lm's key biases, whose
  gradient is identically zero, frozen) against the JAX runner,
  losses 1e-5, params rtol 2e-5 / atol 2e-6, every rank's gathered
  params equal; the seq-sharded feed (``seq_keys``) against the JAX
  Remapper's, and its ``ValueError`` without them;
- the plans' JSON bytes, the builders' and the setup's ``ValueError``s,
  ADT430 sending an sp job to the whole-job restart.
"""
import concurrent.futures
import dataclasses
import functools
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import autodist_tpu as jadt
import autodist_tpu_torch as adt
from autodist_tpu import strategy as jstrategy
from autodist_tpu.models import lm as jlm
from autodist_tpu.models import tp_lm as jtp_lm
from autodist_tpu.ops import attention as jattn
from autodist_tpu.parallel import sequence as jseq
from autodist_tpu.resource_spec import ResourceSpec as JSpec
from autodist_tpu_torch import convert, strategy
from autodist_tpu_torch.models import lm, tp_lm
from autodist_tpu_torch.ops import attention
from autodist_tpu_torch.resource_spec import ResourceSpec
from torch_dist_worker import launch

STEPS = 3
LR = 1e-3
ADAM_EPS = 1e-6       # see tests/test_torch_pipeline_parallel.py
SEQ = "seq"
B, S, H, D = 2, 32, 8, 16
LM_SEQ = 32
ATTENTIONS = ("ring", "ulysses")
# (name, tp, sp) of the tp_lm cases, on 4 ranks
TP_CASES = (("tp2xsp2", 2, 2), ("dp2xsp2", 1, 2))


def _spec(n):
    return {"nodes": [{"address": "127.0.0.1", "chief": True,
                       "cpus": list(range(n))}]}


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
    jadt.reset()


# ----------------------------------------------------- the primitives


def _smesh(n):
    return Mesh(np.array(jax.devices()[:n]), (SEQ,))


def _qkv(seed):
    rng = np.random.RandomState(seed)
    return [(rng.randn(B, S, H, D) * 0.3).astype(np.float32)
            for _ in range(3)]


def _pad_mask():
    valid = np.ones((B, S), bool)
    valid[:, S - 8:] = False
    return valid[:, None, None, :]


def _jax_attn(kind, n, causal, q, k, v, mask=None):
    """The JAX function inside ``shard_map`` over ``n`` devices: the
    output and the gradients of the local ``sum(out ** 2)``."""
    spec = P(None, SEQ)

    def f(a, b, c, m):
        def loss(a, b, c):
            if m is not None:
                out = jattn.make_attn_fn(kind, causal=causal)(a, b, c, m)
            elif kind == "ring":
                out = jattn.ring_attention(a, b, c, SEQ, causal=causal)
            else:
                out = jattn.ulysses_attention(a, b, c, SEQ, causal=causal)
            return jnp.sum(out.astype(jnp.float32) ** 2), out
        (_, out), grads = jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True)(a, b, c)
        return out, grads
    in_specs = (spec,) * 3 + (P() if mask is not None else None,)
    out, grads = jax.jit(jax.shard_map(
        f, mesh=_smesh(n), in_specs=in_specs, out_specs=(spec, (spec,) * 3),
        check_vma=False))(q, k, v, mask)
    return {"out": np.asarray(out), "grads": [np.asarray(g) for g in grads]}


def _ring_ppermutes(n):
    """ppermutes in the JAX ring's jaxpr over ``n`` devices (its
    fori_loop runs n - 1 rotations; the JAX test's walk)."""
    from autodist_tpu.kernel.common import op_info
    q, k, v = _qkv(0)
    jaxpr = jax.make_jaxpr(jax.shard_map(
        lambda a, b, c: jattn.ring_attention(a, b, c, SEQ),
        mesh=_smesh(n), in_specs=(P(None, SEQ),) * 3,
        out_specs=P(None, SEQ), check_vma=False))(q, k, v)
    count = [0]

    def walk(jp, mult=1):
        for eqn in jp.eqns:
            if eqn.primitive.name == "ppermute":
                count[0] += mult
            m = mult * (n - 1) if eqn.primitive.name in ("while", "scan") \
                else mult
            for sub in op_info.sub_jaxprs(eqn):
                walk(sub, m)
    walk(jaxpr.jaxpr)
    return count[0]


def _seq_inputs():
    rng = np.random.RandomState(5)
    return {"tokens": rng.randint(0, 100, (3, 16)).astype(np.int32),
            "x": rng.standard_normal((3, 16, 2)).astype(np.float32),
            "w": rng.standard_normal((3, 16, 2)).astype(np.float32),
            "values": rng.standard_normal((3, 16)).astype(np.float32),
            "weights": (rng.uniform(size=(3, 16)) > 0.3).astype(np.float32)}


def _jax_seq(n, inp):
    spec = P(None, SEQ)

    def f(tokens, x, w, values, weights):
        y, vjp = jax.vjp(lambda xx: jseq.shift_left(xx, SEQ), x)
        wm, g = jax.value_and_grad(
            lambda v: jseq.global_weighted_mean(v, weights, SEQ))(values)
        return (jseq.shift_left(tokens, SEQ), y, vjp(w)[0], wm[None],
                jseq.global_mean(values, SEQ)[None], g)
    out = jax.jit(jax.shard_map(
        f, mesh=_smesh(n), in_specs=(spec,) * 5,
        out_specs=(spec, spec, spec, P(SEQ), P(SEQ), spec),
        check_vma=False))(inp["tokens"], inp["x"], inp["w"], inp["values"],
                          inp["weights"])
    return dict(zip(("tokens", "y", "g", "wmean", "mean", "gw"),
                    map(np.asarray, out)))


def _prim_cases(n):
    """The primitive cases of the n-rank job and their JAX results, each
    deferred (a function of no arguments)."""
    cases, want = [], []
    for kind in ATTENTIONS:
        for causal in (False, True):
            q, k, v = _qkv(1 + causal)
            cases.append({"kind": kind, "causal": causal, "q": q, "k": k,
                          "v": v})
            want.append(functools.partial(_jax_attn, kind, n, causal, q, k,
                                          v))
    if n == 2:
        q, k, v = _qkv(3)
        cases.append({"kind": "ulysses", "causal": False, "q": q, "k": k,
                      "v": v, "mask": _pad_mask()})
        want.append(functools.partial(_jax_attn, "ulysses", n, False, q, k,
                                      v, _pad_mask()))
        inp = _seq_inputs()
        cases += [dict(inp, kind="shift"), dict(inp, kind="wmean")]
        res = functools.lru_cache()(functools.partial(_jax_seq, n, inp))
        want += [res, res]
    return cases, want


# ---------------------------------------------------------- training


def _lm_cfg(pkg):
    # four heads, so that Ulysses splits them over 4 ranks
    return dataclasses.replace(pkg.LMConfig.tiny(), num_heads=4)


def _batches(vocab, shape, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, shape).astype(np.int32)
            for _ in range(STEPS)]


def _jax_train(loss_fn, params, batches, builder, frozen=None):
    """The JAX runner on the session's devices: losses and gathered
    params (``frozen``: a name suffix kept frozen)."""
    keep = (lambda n: not n.endswith(frozen)) if frozen else None
    try:
        runner = jadt.AutoDist(strategy_builder=builder).build(
            loss_fn, optax.adam(LR, eps=ADAM_EPS), params, batches[0],
            trainable_filter=keep)
        runner.init(params)
        losses = [float(runner.run(b)["loss"]) for b in batches]
        return losses, jax.tree_util.tree_map(np.asarray,
                                              runner.gather_params())
    finally:
        jadt.reset()


def _lm_ref(n, attention_kind):
    loss_fn, params, _, _ = jlm.make_sp_train_setup(
        _lm_cfg(jlm), seq_len=LM_SEQ, batch_size=8, seed=0,
        attention=attention_kind)
    params = jax.tree_util.tree_map(np.asarray, params)
    batches = [{"tokens": t} for t in _batches(128, (8, LM_SEQ), 1)]
    # the key biases' gradient is identically zero (a key bias shifts a
    # row's logits by a constant, which the softmax removes): Adam at eps
    # 1e-6 would turn each package's f32 rounding residue (~1e-9) into
    # moves of ~lr a step, of either sign, so they stay frozen on both
    # sides
    case = {"kind": "train", "model": "lm", "cfg": {"num_heads": 4},
            "seq_len": LM_SEQ, "attention": attention_kind, "init": params,
            "batches": batches, "builder": "SequenceParallelAR",
            "kw": {"seq_shards": n}, "lr": LR, "eps": ADAM_EPS,
            "frozen": "key.bias"}

    def want():
        losses, got = _jax_train(loss_fn, params, batches,
                                 jstrategy.SequenceParallelAR(seq_shards=n),
                                 frozen="key/bias")
        return {"losses": losses,
                "params": {k: v.numpy() for k, v in
                           convert.params_from_jax(got).items()}}
    return case, want


def _tp_ref(tp, sp, attention_kind):
    loss_fn, params, batch, _ = jtp_lm.make_train_setup(
        jtp_lm.TPLMConfig.tiny(), seq_len=16, batch_size=8, seed=1,
        attention=attention_kind)
    batches = [batch] + [{"tokens": t} for t in
                         _batches(64, batch["tokens"].shape, 2)[1:]]
    case = {"kind": "train", "model": "tp_lm", "cfg": {},
            "attention": attention_kind, "init": params, "batches": batches,
            "builder": "TensorParallel",
            "kw": {"tp_shards": tp, "seq_shards": sp}, "lr": LR,
            "eps": ADAM_EPS}

    def want():
        losses, got = _jax_train(
            loss_fn, params, batches, jstrategy.TensorParallel(
                tp, jtp_lm.tp_rules(), seq_shards=sp))
        return {"losses": losses,
                "params": {k: v.numpy() for k, v in
                           convert.tp_lm_params_from_jax(got).items()}}
    return case, want


def _seq_keys_problem():
    rng = np.random.RandomState(0)
    params = {"w": rng.randn(8, 5).astype(np.float32)}
    batch = {"tokens": rng.randint(0, 9, (8, 16)).astype(np.int32),
             "class_weights": np.ones((8, 5), np.float32)}
    return params, batch


def _jax_seq_keys_loss(p, batch):
    feat = batch["tokens"][..., None].astype(jnp.float32) @ \
        jnp.ones((1, 8), jnp.float32)
    pred = feat @ p["w"]
    w = jnp.mean(batch["class_weights"], axis=1)
    return jnp.mean(jnp.mean(pred ** 2, axis=(1, 2)) * w)


def _seq_keys_want():
    """The JAX seq_keys run: its losses, params and the placed feed's
    partition specs."""
    params, batch = _seq_keys_problem()
    builder = jstrategy.SequenceParallelAR(seq_shards=2, seq_keys=["tokens"])
    try:
        runner = jadt.AutoDist(strategy_builder=builder).build(
            _jax_seq_keys_loss, optax.adam(LR, eps=ADAM_EPS), params, batch)
        runner.init(params)
        placed = runner.remapper.remap_feed(batch)
        specs = {k: v.sharding.spec for k, v in placed.items()}
        losses = [float(runner.run(batch)["loss"]) for _ in range(STEPS)]
        got = {k: np.asarray(v) for k, v in runner.gather_params().items()}
    finally:
        jadt.reset()
    return {"losses": losses, "params": got, "specs": specs}


def _seq_keys_ref():
    params, batch = _seq_keys_problem()
    base = {"kind": "train", "model": "seq_keys", "init": params,
            "batches": [batch] * STEPS, "builder": "SequenceParallelAR",
            "lr": LR, "eps": ADAM_EPS}
    cases = [dict(base, kw={"seq_shards": 2, "seq_keys": ["tokens"]}),
             dict(base, kw={"seq_shards": 2}, expect_error=True)]
    return cases, _seq_keys_want


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The cases' JAX results (``refs``) and each case's ranks' results
    by key (``runs``: one 2-rank and one 4-rank job). The jobs run in a
    thread while this one computes the JAX results."""
    refs = {}
    for n in (2, 4):
        refs["prims", n] = _prim_cases(n)
        for a in ATTENTIONS:
            refs["lm", n, a] = _lm_ref(n, a)
    for name, tp, sp in TP_CASES:
        for a in ATTENTIONS:
            refs[name, a] = _tp_ref(tp, sp, a)
    refs["seq_keys"] = _seq_keys_ref()
    jobs = {2: [], 4: []}
    for n in (2, 4):
        cases, _ = refs["prims", n]
        jobs[n] += [(("prims", n, i), c) for i, c in enumerate(cases)]
        jobs[n] += [(("lm", n, a), refs["lm", n, a][0]) for a in ATTENTIONS]
    for name, _, _ in TP_CASES:
        jobs[4] += [((name, a), refs[name, a][0]) for a in ATTENTIONS]
    sk_cases, _ = refs["seq_keys"]
    jobs[2] += [(("seq_keys", i), c) for i, c in enumerate(sk_cases)]
    jobs[2].append((("ulysses_heads",), {
        "kind": "ulysses", "causal": False,
        "q": np.zeros((1, 4, 3, 2), np.float32),
        "k": np.zeros((1, 4, 3, 2), np.float32),
        "v": np.zeros((1, 4, 3, 2), np.float32), "expect_error": True}))
    dirs = {w: tmp_path_factory.mktemp("sp%d" % w) for w in jobs}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = {w: pool.submit(launch, "sp", w, dirs[w],
                                [c for _, c in cases])
                 for w, cases in jobs.items()}
        for key, (cases, want) in list(refs.items()):
            refs[key] = (cases, [w() for w in want] if isinstance(want, list)
                         else want())
        runs = {}
        for world, cases in jobs.items():
            got = ranks[world].result()
            for i, (key, _) in enumerate(cases):
                runs[key] = [r[i] for r in got]
    return refs, runs


@pytest.fixture(scope="module")
def refs(both):
    return both[0]


@pytest.fixture(scope="module")
def runs(both):
    return both[1]


# ----------------------------------------------------------------- tests


def _chunk(a, rank, n):
    c = a.shape[1] // n
    return a[:, rank * c:(rank + 1) * c]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kind", ATTENTIONS)
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_attention_forward_and_grads_match_jax(refs, runs, n, kind, causal):
    """Each rank's output chunk and the gradients of its ``sum(out **
    2)`` (the cross-rank K/V terms moved back to their owners) against
    the JAX function inside ``shard_map``, 1e-5."""
    cases, want = refs["prims", n]
    i = next(j for j, c in enumerate(cases)
             if c["kind"] == kind and c["causal"] == causal
             and "mask" not in c)
    for rank, got in enumerate(runs["prims", n, i]):
        np.testing.assert_allclose(got["out"],
                                   _chunk(want[i]["out"], rank, n),
                                   rtol=1e-5, atol=1e-5)
        for g, w in zip(got["grads"], want[i]["grads"]):
            np.testing.assert_allclose(g, _chunk(w, rank, n), rtol=1e-5,
                                       atol=1e-5)
        assert got["size"] == n and got["offset"] == rank * S // n


@pytest.mark.parametrize("n", [2, 4])
def test_ring_skips_the_dead_final_rotation(runs, refs, n):
    """N - 1 rotations a call, each one payload of K and V (the JAX
    jaxpr's 2 (N - 1) ppermutes, K and V apart), and as many in the
    backward; Ulysses permutes nothing."""
    cases, _ = refs["prims", n]
    assert _ring_ppermutes(n) == 2 * (n - 1)
    for i, c in enumerate(cases):
        if c["kind"] not in ATTENTIONS:
            continue
        for got in runs["prims", n, i]:
            want = n - 1 if c["kind"] == "ring" else 0
            assert (got["fwd_sends"], got["bwd_sends"]) == (want, want)


def test_ring_attn_fn_refuses_a_dense_mask_as_jax():
    q, k, v = [jnp.asarray(a) for a in _qkv(0)]
    mask = np.ones((1, 1, 8, 8), bool)
    with pytest.raises(ValueError, match="cannot apply a dense mask") as want:
        jattn.make_attn_fn("ring")(q, k, v, jnp.asarray(mask))
    tq, tk, tv = [torch.as_tensor(a) for a in _qkv(0)]
    with pytest.raises(ValueError) as got:
        attention.make_attn_fn("ring")(tq, tk, tv, torch.as_tensor(mask))
    assert str(got.value) == str(want.value)
    for bad in ("bogus",):
        with pytest.raises(ValueError) as want:
            jattn.make_attn_fn(bad)
        with pytest.raises(ValueError) as got:
            attention.make_attn_fn(bad)
        assert str(got.value) == str(want.value)


def test_ulysses_honours_the_padding_mask_and_checks_heads(refs, runs):
    """The ``(q, k, v, mask)`` slot forwards a padding mask to Ulysses:
    every position against the JAX function with the mask, 1e-5; three
    heads over two ranks raise the JAX ``ValueError``."""
    cases, want = refs["prims", 2]
    i = next(j for j, c in enumerate(cases) if "mask" in c)
    for rank, got in enumerate(runs["prims", 2, i]):
        np.testing.assert_allclose(got["out"],
                                   _chunk(want[i]["out"], rank, 2),
                                   rtol=1e-5, atol=1e-5)
    for got in runs["ulysses_heads",]:
        assert got["error"] == "ulysses needs heads % axis_size == 0 (H=3)"


def test_shift_left_and_the_global_means_match_jax(refs, runs):
    """``shift_left`` of int tokens (moved as they are) and of a float
    tensor with its gradient; ``global_weighted_mean`` (the rank's scaled
    term) with its gradient and ``global_mean``, each rank against its
    JAX device."""
    cases, want = refs["prims", 2]
    i = next(j for j, c in enumerate(cases) if c["kind"] == "shift")
    w = want[i]
    for rank, got in enumerate(runs["prims", 2, i]):
        np.testing.assert_array_equal(got["tokens"],
                                      _chunk(w["tokens"], rank, 2))
        assert got["tokens"].dtype == np.int32
        np.testing.assert_array_equal(got["y"], _chunk(w["y"], rank, 2))
        np.testing.assert_array_equal(got["g"], _chunk(w["g"], rank, 2))
    for rank, got in enumerate(runs["prims", 2, i + 1]):
        np.testing.assert_allclose(got["wmean"], w["wmean"][rank],
                                   rtol=1e-6)
        np.testing.assert_allclose(got["mean"], w["mean"][rank], rtol=1e-6)
        np.testing.assert_allclose(got["g"], _chunk(w["gw"], rank, 2),
                                   rtol=1e-6, atol=1e-7)


TRAIN = [("lm", n, a) for n in (2, 4) for a in ATTENTIONS] + \
    [(name, a) for name, _, _ in TP_CASES for a in ATTENTIONS]


@pytest.mark.parametrize("key", TRAIN, ids=lambda k: "_".join(map(str, k)))
def test_training_matches_the_jax_runner(refs, runs, key):
    """Three Adam steps: every rank's losses and gathered params against
    the JAX runner's on as many devices; every rank gathered the same;
    each rank's mesh place and its chunk of the sequence."""
    _, want = refs[key]
    ranks = runs[key]
    n_seq = key[1] if key[0] == "lm" else 2
    for rank, r in enumerate(ranks):
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=1e-5,
                                   atol=1e-5)
        assert sorted(r["params"]) == sorted(want["params"])
        for n, w in want["params"].items():
            np.testing.assert_allclose(r["params"][n], w, rtol=2e-5,
                                       atol=2e-6, err_msg=n)
        assert r["ranks_equal"]
        assert r["mesh"]["seq"] == n_seq
        assert r["coords"]["seq"] == (rank // r["mesh"].get("model", 1)
                                      % n_seq)
        tokens = refs[key][0]["batches"][0]["tokens"]
        rows = tokens.shape[0] // r["mesh"]["data"]
        d = r["coords"]["data"]
        np.testing.assert_array_equal(
            r["shard"]["tokens"],
            _chunk(tokens[d * rows:(d + 1) * rows], r["coords"]["seq"],
                   n_seq))
        assert r["counters"]["sp.p2p_sends"] > 0
        if key[-1] == "ulysses":
            assert r["counters"]["sp.a2a_bytes"] > 0


def test_tp_x_sp_holds_each_heads_slice(runs):
    """At tp 2 x sp 2 the mesh is {data: 1, seq: 2, model: 2}: rank r at
    seq r // 2, model r % 2, holding its half of the QKV heads."""
    for rank, r in enumerate(runs["tp2xsp2", "ring"]):
        assert r["mesh"] == {"data": 1, "seq": 2, "model": 2}
        assert r["coords"] == {"data": 0, "seq": rank // 2,
                               "model": rank % 2}
        assert r["local_shapes"]["layer_0/attn/wq"] == (32, 2, 8)
        assert r["opt_shapes"]["layer_0/attn/wq"] == (32, 2, 8)


def test_seq_keys_exempt_non_sequence_leaves_as_jax(refs, runs):
    """``SequenceParallelAR(seq_keys=["tokens"])``: only the token leaf
    splits dim 1 over the seq axis (JAX ``P(("data",), "seq")``), the
    ``[B, C]`` leaf stays whole per row (``P(("data",))``); losses and
    params as JAX's. Without the declaration the same batch raises the
    JAX error."""
    cases, want = refs["seq_keys"]
    assert want["specs"] == {"tokens": P(("data",), SEQ),
                             "class_weights": P(("data",))}
    batch = cases[0]["batches"][0]
    for rank, r in enumerate(runs["seq_keys", 0]):
        np.testing.assert_array_equal(r["shard"]["tokens"],
                                      _chunk(batch["tokens"], rank, 2))
        np.testing.assert_array_equal(r["shard"]["class_weights"],
                                      batch["class_weights"])
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=1e-5)
        np.testing.assert_allclose(r["params"]["w"], want["params"]["w"],
                                   rtol=2e-5, atol=2e-6)
    for r in runs["seq_keys", 1]:
        assert "sequence dim 5 of 'class_weights' is not divisible by " \
            "the 2" in r["error"]


def _port_item(model):
    from autodist_tpu_torch.model_item import ModelItem
    if model == "lm":
        loss_fn, params, batch, _ = lm.make_sp_train_setup(
            _lm_cfg(lm), seq_len=LM_SEQ, batch_size=8)
    else:
        loss_fn, params, batch, _ = tp_lm.make_train_setup(
            tp_lm.TPLMConfig.tiny(), seq_len=16, batch_size=8,
            attention="ring")
    return ModelItem(loss_fn=loss_fn, params=params,
                     example_batch=batch).prepare()


def _jax_item(model):
    from autodist_tpu.model_item import ModelItem as JModelItem
    if model == "lm":
        loss_fn, params, batch, _ = jlm.make_sp_train_setup(
            _lm_cfg(jlm), seq_len=LM_SEQ, batch_size=8)
    else:
        loss_fn, params, batch, _ = jtp_lm.make_train_setup(
            jtp_lm.TPLMConfig.tiny(), seq_len=16, batch_size=8,
            attention="ring")
    return JModelItem(loss_fn=loss_fn, params=params,
                      example_batch=batch).prepare()


def _builders(case):
    if case == "sp":
        return (lambda S_: S_.SequenceParallelAR(seq_shards=2,
                                                 seq_keys=["tokens"]),
                "lm")
    if case == "sp4":
        return lambda S_: S_.SequenceParallelAR(seq_shards=4), "lm"
    return (lambda S_: S_.TensorParallel(2, tp_lm.tp_rules(), seq_shards=2),
            "tp_lm")


@pytest.mark.parametrize("case", ["sp", "sp4", "tp2xsp2"])
def test_plan_bytes_match_jax(case):
    """The plan over the same variable list and a 4-device spec is the
    JAX builder's, byte for byte (mesh, seq_axis, seq_feed_keys)."""
    make, model = _builders(case)
    jplan = make(jstrategy).build(_jax_item(model),
                                  JSpec.from_dict(_spec(4)))
    titem = _port_item(model)
    tplan = make(strategy).build(titem, ResourceSpec.from_dict(_spec(4)))
    tplan.id = jplan.id
    # the lm's variables carry the JAX item's names as collective names
    for node in tplan.node_config:
        node.var_name = titem.var_infos[node.var_name].collective_name
    dump = lambda p: json.dumps(p.to_dict(), sort_keys=True)  # noqa: E731
    assert dump(tplan) == dump(jplan)
    assert tplan.graph_config.seq_axis == SEQ


@pytest.mark.parametrize("make", [
    lambda S_: S_.SequenceParallelAR(seq_shards=0),
    lambda S_: S_.TensorParallel(1, [], seq_shards=0),
    lambda S_: S_.SequenceParallelAR(seq_shards=3),
    lambda S_: S_.TensorParallel(2, [], seq_shards=3)],
    ids=["sp0", "tp_sp0", "sp3_of_4", "tp2xsp3_of_4"])
def test_builder_value_errors_match_jax(make):
    with pytest.raises(ValueError) as want:
        make(jstrategy).build(_jax_item("lm"), JSpec.from_dict(_spec(4)))
    with pytest.raises(ValueError) as got:
        make(strategy).build(_port_item("lm"),
                             ResourceSpec.from_dict(_spec(4)))
    assert str(got.value) == str(want.value)


def test_sp_setup_value_error_matches_jax():
    with pytest.raises(ValueError) as want:
        jlm.make_sp_train_setup(jlm.LMConfig.tiny(), seq_len=128)
    with pytest.raises(ValueError) as got:
        lm.make_sp_train_setup(lm.LMConfig.tiny(), seq_len=128)
    assert str(got.value) == str(want.value)


def test_adt430_sends_an_sp_job_to_the_whole_job_restart():
    """The sp plan pins the seq axis: ADT430 as the JAX rule reports it,
    and the coordinator's shrink decision refuses the in-run shrink with
    its message."""
    from autodist_tpu.analysis import rules as jrules
    from autodist_tpu_torch.analysis import rules
    from autodist_tpu_torch.runtime.coordinator import Coordinator
    make, model = _builders("sp")
    tplan = make(strategy).build(_port_item(model),
                                 ResourceSpec.from_dict(_spec(2)))
    jplan = make(jstrategy).build(_jax_item(model),
                                  JSpec.from_dict(_spec(2)))
    got = rules.verify_elastic(tplan, dead_worker="localhost")
    want = jrules.verify_elastic(jplan, dead_worker="localhost")
    assert [(d.code, d.message) for d in got] == \
        [(d.code, d.message) for d in want]
    assert [d.code for d in got] == ["ADT430"]
    tplan.serialize()
    fake = types.SimpleNamespace(_strategy_id=tplan.id)
    assert Coordinator._shrink_unsound_reason(fake, "localhost") == \
        got[0].message


def test_unbound_sp_losses_are_the_one_rank_functions():
    """One process (no seq axis bound): ring, Ulysses and the reference
    attention agree, and the SP lm loss is the plain model's loss over
    the S - 1 targets."""
    q, k, v = [torch.as_tensor(a) for a in _qkv(4)]
    mask = torch.ones((S, S), dtype=torch.bool).tril()[None, None]
    ref = attention.reference_attention(q, k, v, mask)
    for fn in (attention.ring_attention, attention.ulysses_attention):
        np.testing.assert_allclose(fn(q, k, v, causal=True).numpy(),
                                   ref.numpy(), rtol=1e-5, atol=1e-6)
    cfg = _lm_cfg(lm)
    loss_fn, params, batch, apply_fn = lm.make_sp_train_setup(
        cfg, seq_len=LM_SEQ, batch_size=4)
    tokens = torch.as_tensor(batch["tokens"]).long()
    with torch.no_grad():
        logp = torch.log_softmax(apply_fn(params, tokens)[:, :-1], dim=-1)
        plain = -torch.gather(logp, -1, tokens[:, 1:, None]).mean()
        got = loss_fn(params, batch)
    np.testing.assert_allclose(float(got), float(plain), rtol=1e-5)
