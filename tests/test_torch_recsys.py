"""autodist_tpu_torch's recommenders and the PS family against the JAX
package, on the CPU.

- The models: NCF (``models/ncf.py``) and DLRM (``models/dlrm.py``,
  with its ``wide`` variant) from the JAX init converted by
  ``convert.params_from_jax``: forward outputs within 1e-6; the full-width
  configs' variables equal ``jax.eval_shape`` of the JAX init in name
  (``convert.jax_name``) and shape; DLRM's interaction order is
  ``jnp.tril_indices(f, k=-1)``'s; the hot-id batch is the JAX one.
- Training under the PS family: ncf tiny, dlrm tiny and dlrm tiny wide
  under ``PS()``, ``PS(wire_dtype="int8")``, ``PSLoadBalancing()``,
  ``PartitionedPS()``, ``UnevenPartitionedPS()``, ``Parallax()`` and
  ``PS(local_proxy_variable=True)``, an ``evaluate`` then 3 Adam (1e-3)
  steps of the port (``device="cpu"``) against the JAX runner's on the
  same calls: at N = 1 (a one-device JAX spec) and at N = 2 (two gloo
  ranks of ``tests/torch_dist_worker.py`` against the JAX runner on 2
  virtual devices, one 2-rank job for every N = 2 case). The host-PS
  variables, the sparse-wire tables, and the store's ``stats`` counters
  (``pulls``, ``pushes``, ``bytes_pulled``, ``bytes_pushed``) equal the
  JAX lowering's and store's exactly; at N = 2 both ranks' params and
  store digests are equal, and the ranks compare their digests every
  step (``ADT_PS_MIRROR_CHECK_EVERY=1``).
- MovieLens (``data/movielens.py``) on the bundled
  ``examples/benchmark/data/ml_tiny_synthetic.dat``: the parse, the
  leave-one-out split, the negative sampler and the eval protocol
  bit-equal to the JAX module's; the records through the port's native
  loader.

Bounds. Losses within 1e-5 relative and params within 1e-6 absolute,
the int8 wire included: it quantizes in the JAX element order
(``convert.to_jax_layout``), so the same elements share each scale
block. Observed at N = 1: losses within 1.7e-7 and params within 6e-8.
"""
import functools
import os

import jax
import numpy as np
import optax
import pytest
import torch

import autodist_tpu as jadt
import autodist_tpu_torch as adt
from autodist_tpu import strategy as jstrategy
from autodist_tpu.data import movielens as jml
from autodist_tpu.models import dlrm as jdlrm
from autodist_tpu.models import ncf as jncf
from autodist_tpu.resource_spec import ResourceSpec as JSpec
from autodist_tpu_torch import strategy
from autodist_tpu_torch.convert import jax_name, params_from_jax
from autodist_tpu_torch.data import movielens as tml
from autodist_tpu_torch.models import dlrm as tdlrm
from autodist_tpu_torch.models import ncf as tncf
from autodist_tpu_torch.resource_spec import ResourceSpec
from torch_dist_worker import LR, launch

STEPS, BATCH = 3, 8
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-6
ONE = {"nodes": [{"address": "127.0.0.1", "chief": True, "cpus": [0]}]}
TWO = {"nodes": [{"address": "127.0.0.1", "chief": True, "cpus": [0, 1]}]}
DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "examples", "benchmark", "data", "ml_tiny_synthetic.dat")

# model -> (JAX module, port module, config keywords)
MODELS = {"ncf": (jncf, tncf, {}), "dlrm": (jdlrm, tdlrm, {}),
          "dlrm_wide": (jdlrm, tdlrm, {"wide": True})}
# builder case -> (class name, keywords)
BUILDERS = {"PS": ("PS", {}),
            "PS_int8": ("PS", {"wire_dtype": "int8"}),
            "PSLoadBalancing": ("PSLoadBalancing", {}),
            "PartitionedPS": ("PartitionedPS", {}),
            "UnevenPartitionedPS": ("UnevenPartitionedPS", {}),
            "Parallax": ("Parallax", {}),
            "PS_proxy": ("PS", {"local_proxy_variable": True})}
STATS = ("pulls", "pushes", "bytes_pulled", "bytes_pushed")


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


def _config(model):
    jmod, tmod, kw = MODELS[model]
    name = "NCFConfig" if model == "ncf" else "DLRMConfig"
    return getattr(jmod, name).tiny(**kw), getattr(tmod, name).tiny(**kw)


def _setup(model, batch_size=BATCH):
    """(JAX loss, JAX params, port loss, port params, example, batches):
    the port's params converted from the JAX init; the batches the
    modules' example batches from seeds 1-3 (the same numpy draws in
    both)."""
    jmod, tmod, _ = MODELS[model]
    jcfg, tcfg = _config(model)
    jl, jp, example, _ = jmod.make_train_setup(jcfg, batch_size=batch_size)
    tl = tmod.make_train_setup(tcfg, batch_size=batch_size)[0]
    batches = [tmod.make_train_setup(tcfg, batch_size=batch_size,
                                     seed=s)[2] for s in (1, 2, 3)]
    init = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return jl, jp, tl, init, example, batches


def _builder(package, case):
    name, kw = BUILDERS[case]
    return getattr(package, name)(**kw)


def _jax_run(model, case, spec):
    """The JAX runner's evaluate, 3 steps, params, host-PS names,
    sparse-wire tables and store stats."""
    jl, jp, _, _, example, batches = _setup(model)
    try:
        ad = jadt.AutoDist(strategy_builder=_builder(jstrategy, case),
                           resource_spec=JSpec.from_dict(spec))
        runner = ad.build(jl, optax.adam(LR), jp, example)
        runner.init(jp)
        ev = float(runner.evaluate(batches[:1])["loss"])
        losses = [float(runner.run(b)["loss"]) for b in batches]
        final = params_from_jax(jax.tree_util.tree_map(
            np.asarray, runner.gather_params()))
        dstep = runner.distributed_step
        store = dstep.ps_store
        out = {"eval": ev, "losses": losses, "params": final,
               "ps_names": dstep.metadata["ps_host_resident"],
               "sparse_wire": dstep.metadata["sparse_wire"],
               "stats": ({k: store.stats[k] for k in STATS}
                         if store is not None else None)}
    finally:
        jadt.reset()
    return out


def _check(got, want, init_params):
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=LOSS_RTOL, atol=0)
    np.testing.assert_allclose(got["eval"], want["eval"], rtol=LOSS_RTOL)
    for name, value in want["params"].items():
        np.testing.assert_allclose(np.asarray(got["params"][name]),
                                   value.numpy(), atol=PARAM_ATOL, rtol=0,
                                   err_msg=name)
        assert not np.array_equal(np.asarray(got["params"][name]),
                                  init_params[name].numpy()) or \
            np.array_equal(value.numpy(), init_params[name].numpy()), name
    assert got["ps_names"] == want["ps_names"]
    assert got["sparse_wire"] == want["sparse_wire"]
    assert got["stats"] == want["stats"]


def _port_names(dstep, names):
    infos = dstep.model_item.var_infos
    return sorted(infos[n].collective_name for n in names)


# ------------------------------------------------------------------ models


@pytest.mark.parametrize("model", list(MODELS))
def test_forward_matches_jax(model):
    jmod, tmod, _ = MODELS[model]
    jcfg, tcfg = _config(model)
    _, jp, batch, japply = jmod.make_train_setup(jcfg, batch_size=BATCH)
    _, _, tbatch, tapply = tmod.make_train_setup(tcfg, batch_size=BATCH)
    for k in batch:
        np.testing.assert_array_equal(tbatch[k], batch[k])
    init = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    args = ((batch["user"], batch["item"]) if model == "ncf"
            else (batch["dense"], batch["sparse"]))
    want = np.asarray(japply(jp, *args))
    with torch.no_grad():
        got = tapply(init, *args).numpy()
    assert got.shape == want.shape == (BATCH,)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("model", ["ncf", "dlrm", "dlrm_wide"])
def test_full_width_variables_are_the_jax_models(model):
    """The default configs' variables: the JAX init's names and shapes,
    from ``jax.eval_shape`` (nothing allocated)."""
    jmod, tmod, kw = MODELS[model]
    name = "NCFConfig" if model == "ncf" else "DLRMConfig"
    jcfg = getattr(jmod, name)(**kw)
    tcfg = getattr(tmod, name)(**kw)
    model_cls = jmod.NeuMF if model == "ncf" else jmod.DLRM
    if model == "ncf":
        args = (jax.ShapeDtypeStruct((1,), np.int32),) * 2
    else:
        args = (jax.ShapeDtypeStruct((1, jcfg.num_dense), np.float32),
                jax.ShapeDtypeStruct((1, len(jcfg.table_sizes)), np.int32))
    shapes = jax.eval_shape(lambda *a: model_cls(jcfg).init(
        jax.random.PRNGKey(0), *a), *args)
    want = {"/".join(["params"] + [str(getattr(k, "key", k)) for k in path]):
            tuple(leaf.shape) for path, leaf in
            jax.tree_util.tree_flatten_with_path(shapes["params"])[0]}
    port = tmod.make_model(tcfg)
    got = {}
    for n, p in port.named_parameters():
        flax = tuple(p.shape)[::-1] if n.endswith("weight") else \
            tuple(p.shape)
        got[jax_name(n, tuple(p.shape))] = flax
    assert got == want
    if model == "dlrm":
        tables = sum(int(np.prod(s)) for n, s in want.items()
                     if "table_" in n)
        assert tables == 1_622_100 * 64
    if model == "ncf":
        tables = sum(int(np.prod(s)) for n, s in want.items()
                     if "embedding" in n)
        assert tables == 31_680_000
        assert sum(int(np.prod(s)) for s in want.values()) - tables == 41_281


def test_dlrm_interactions_take_the_jax_triangle_order():
    f = 6
    li, lj = torch.tril_indices(f, f, -1)
    ji, jj = jax.numpy.tril_indices(f, k=-1)
    assert li.tolist() == np.asarray(ji).tolist()
    assert lj.tolist() == np.asarray(jj).tolist()
    with pytest.raises(ValueError, match="bottom_mlp must end"):
        tdlrm.DLRMConfig.tiny(bottom_mlp=(16, 4))


def test_dlrm_hot_id_batch_is_the_jax_batch():
    cfg = tdlrm.DLRMConfig(table_sizes=(1000, 500), embed_dim=8,
                           bottom_mlp=(8,), top_mlp=(8,))
    jcfg = jdlrm.DLRMConfig(table_sizes=(1000, 500), embed_dim=8,
                            bottom_mlp=(8,), top_mlp=(8,))
    got = tdlrm.make_train_setup(cfg, batch_size=512, seed=4)[2]
    want = jdlrm.make_train_setup(jcfg, batch_size=512, seed=4)[2]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    # most lookups land in the first 5% of each vocabulary
    for t, size in enumerate(cfg.table_sizes):
        assert (got["sparse"][:, t] < size * 0.05).mean() > 0.7


def test_registry_has_the_recommenders():
    from autodist_tpu_torch import models
    loss_fn, params, batch, _ = models.make_train_setup(
        "ncf", config=tncf.NCFConfig.tiny(), batch_size=4)
    assert np.isfinite(float(loss_fn(params, batch)))
    loss_fn, params, batch, _ = models.make_train_setup(
        "dlrm", config=tdlrm.DLRMConfig.tiny(wide=True), batch_size=4)
    assert np.isfinite(float(loss_fn(params, batch)))
    assert "wide_dense.bias" not in params


# ------------------------------------------------------- training, N = 1


@pytest.mark.parametrize("case", list(BUILDERS))
@pytest.mark.parametrize("model", list(MODELS))
def test_one_replica_matches_jax(model, case):
    want = _jax_run(model, case, ONE)
    _, _, tl, init, example, batches = _setup(model)
    ad = adt.AutoDist(strategy_builder=_builder(strategy, case),
                      resource_spec=ResourceSpec.from_dict(ONE),
                      device="cpu")
    runner = ad.build(tl, functools.partial(torch.optim.Adam, lr=LR), init,
                      example)
    runner.init(init)
    ev = float(runner.evaluate(batches[:1])["loss"])
    losses = [float(runner.run(b)["loss"]) for b in batches]
    dstep = runner.distributed_step
    store = dstep.ps_store
    got = {"eval": ev, "losses": losses,
           "params": {n: t.numpy() for n, t in
                      runner.gather_params().items()},
           "ps_names": _port_names(dstep, dstep.ps_names),
           "sparse_wire": _port_names(dstep, dstep.sparse_wire),
           "stats": ({k: store.stats[k] for k in STATS}
                     if store is not None else None)}
    _check(got, want, init)
    if case == "PS_proxy":
        assert store is None and not dstep.ps_names
    else:
        assert dstep.ps_names and not dstep.ps_names & set(
            runner.state.params)


# ------------------------------------------------------- training, N = 2

TWO_CASES = [(m, c) for m in ("ncf", "dlrm") for c in BUILDERS] + \
    [("dlrm_wide", "Parallax")]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Every N = 2 case: the JAX 2-device run and both port ranks', from
    one 2-rank job."""
    jax_out, payload = {}, []
    for model, case in TWO_CASES:
        jax_out[(model, case)] = _jax_run(model, case, TWO)
        _, _, _, init, example, batches = _setup(model)
        name, kw = BUILDERS[case]
        payload.append({"model": model, "seq_len": 0,
                        "batch_size": BATCH, "attention": "",
                        "builder": name, "strategy": kw,
                        "example": example,
                        "init": {n: t.numpy() for n, t in init.items()},
                        "batches": batches})
    # every step the ranks compare their store mirrors' digests
    os.environ["ADT_PS_MIRROR_CHECK_EVERY"] = "1"
    try:
        ranks = launch("train", 2, tmp_path_factory.mktemp("recsys"),
                       payload)
    finally:
        os.environ.pop("ADT_PS_MIRROR_CHECK_EVERY")
    return {key: (jax_out[key], [r[i] for r in ranks])
            for i, key in enumerate(TWO_CASES)}


@pytest.mark.parametrize("model,case", TWO_CASES,
                         ids=["%s-%s" % mc for mc in TWO_CASES])
def test_two_ranks_match_jax(two_ranks, model, case):
    want, ranks = two_ranks[(model, case)]
    _, _, _, init, _, _ = _setup(model)
    for out in ranks:
        got = dict(out, ps_names=out["ps_jax_names"],
                   sparse_wire=out["sparse_wire_jax"])
        _check(got, want, init)
    r0, r1 = ranks
    assert r0["losses"] == r1["losses"]
    for name in r0["params"]:
        assert np.array_equal(r0["params"][name], r1["params"][name]), name
    assert r0["ps_digest"] == r1["ps_digest"]
    checks = 0 if case == "PS_proxy" else STEPS
    assert r0["counters"].get("ps.mirror_checks", 0) == checks


# --------------------------------------------------------------- movielens


@pytest.fixture(scope="module")
def ratings():
    return jml.load_ratings(DATA), tml.load_ratings(DATA)


def _same_ratings(a, b):
    for k in ("users", "items", "timestamps"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
        assert getattr(a, k).dtype == getattr(b, k).dtype
    assert (a.num_users, a.num_items) == (b.num_users, b.num_items)


def test_movielens_parse_and_split_are_the_jax_module_s(ratings):
    jr, tr = ratings
    _same_ratings(jr, tr)
    assert tr.n > 2000 and tr.users.dtype == np.int32
    jtrain, jhold = jml.leave_one_out_split(jr)
    ttrain, thold = tml.leave_one_out_split(tr)
    _same_ratings(jtrain, ttrain)
    assert jhold == thold and len(thold) == tr.num_users


def test_movielens_negative_sampler_is_the_jax_module_s(ratings):
    jtrain, _ = jml.leave_one_out_split(ratings[0])
    ttrain, _ = tml.leave_one_out_split(ratings[1])
    js = jml.NegativeSampler(jtrain, neg_per_pos=4, seed=3)
    ts = tml.NegativeSampler(ttrain, neg_per_pos=4, seed=3)
    for lo in (0, 128):
        u, i = ttrain.users[lo:lo + 128], ttrain.items[lo:lo + 128]
        got, want = ts.batch(u, i), js.batch(u, i)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        negs = got["label"] == 0
        assert not ts._is_positive(got["user"][negs],
                                   got["item"][negs]).any()
    assert ts.false_negatives == js.false_negatives == 0


def test_movielens_records_through_the_native_loader(ratings, tmp_path):
    ttrain, _ = tml.leave_one_out_split(ratings[1])
    path = tml.write_train_records(ttrain, str(tmp_path / "ncf.adt"))
    it = tml.train_batches(path, ttrain, pos_per_batch=64, neg_per_pos=3)
    batch = next(it)
    it.close()
    assert batch["user"].shape == (64 * 4,)
    assert batch["item"].max() < ttrain.num_items
    assert batch["label"][:64].all() and not batch["label"][64:].any()
    # the positives are training pairs
    keys = set(zip(ttrain.users.tolist(), ttrain.items.tolist()))
    assert all((int(u), int(i)) in keys for u, i in
               zip(batch["user"][:64], batch["item"][:64]))


def test_movielens_eval_protocol_is_the_jax_module_s(ratings):
    jtrain, jhold = jml.leave_one_out_split(ratings[0])
    ttrain, thold = tml.leave_one_out_split(ratings[1])
    rng = np.random.RandomState(0)
    table = rng.randn(ttrain.num_users, ttrain.num_items).astype(np.float32)

    def score(u, i):
        return table[u, i]

    def perfect(u, i):
        return np.asarray([1.0 if thold[int(a)] == int(b) else 0.0
                           for a, b in zip(u, i)], np.float32)
    got = tml.evaluate_hit_ndcg(score, thold, ttrain, num_negatives=20)
    want = jml.evaluate_hit_ndcg(score, jhold, jtrain, num_negatives=20)
    assert got == want
    best = tml.evaluate_hit_ndcg(perfect, thold, ttrain, num_negatives=20)
    assert best["hr"] == 1.0 and best["ndcg"] == 1.0
