"""autodist_tpu_torch's sparse (ids, values) gradient wire
(``ops/embedding.py``), the port's counterparts of
``tests/test_embedding_sparse.py``, on the CPU.

A DLRM-ish tower (vocab 100 000, 16 features, ``tests/
torch_dist_worker.py::tower_setup``) as in the JAX tests:

- the tap trick: outside a capture a named lookup is ``F.embedding``;
  under one the table gets no dense gradient and the taps' gradients are
  the gathered rows' — equal to the JAX taps' on the same numbers;
- at N = 2 (two gloo ranks) under ``AllReduce()``: the table goes over
  the wire as all-gathered (ids, values) pairs, the params match the
  dense path's (the same model with an unnamed lookup) within 1e-4
  relative / 1e-6 absolute (the JAX test's bounds; two summation orders,
  and Adam normalizes each step), and the ``sync.wire_bytes`` a step are
  at least 10x fewer;
- at N = 1 under ``PS()``: the store receives the pairs (batch-sized
  pushes); a tied table (another dense use) and a small vocabulary (the
  cost gate) stay dense; an unrouted lookup warns and syncs dense, or
  raises under ``require_sparse``;
- the wire helpers (``flatten_pairs``, ``scatter_add_dense``) against the
  JAX ones on the same numbers, and ``gather_pairs`` in rank order.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import autodist_tpu_torch as adt
from autodist_tpu.ops import embedding as jE
from autodist_tpu_torch import strategy
from autodist_tpu_torch.ops import embedding as E
from autodist_tpu_torch.strategy.base import GraphConfig
from torch_dist_worker import (LR, TOWER_DIM, TOWER_VOCAB, launch,
                               tower_setup)

BATCH, STEPS = 512, 3


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


def test_lookup_is_plain_outside_a_capture():
    t = torch.arange(12.0).reshape(4, 3)
    ids = torch.tensor([1, 3])
    assert torch.equal(E.embedding_lookup(t, ids, name="x"), t[ids])
    with E.capture(["other"]):
        assert torch.equal(E.embedding_lookup(t, ids, name="x"), t[ids])


def test_tap_gradients_equal_the_dense_rows_and_the_jax_taps():
    """d loss / d tap is the gathered rows' gradient; the table gets no
    dense gradient; the JAX taps give the same values."""
    t = torch.arange(12.0).reshape(4, 3).requires_grad_()
    ids = torch.tensor([1, 3, 1])
    with E.capture(["v"]) as cap:
        rows = E.embedding_lookup(t, ids, name="v")
    loss = (rows * rows).sum()
    gt, gtap = torch.autograd.grad(loss, [t] + E.make_taps(cap, ["v"]),
                                   allow_unused=True)
    assert gt is None  # the table got NO dense gradient
    np.testing.assert_allclose(gtap.numpy(), 2 * t.detach()[ids].numpy())

    def jloss(table, tap):
        with jE.capture({"v": [tap]}):
            r = jE.embedding_lookup(table, jnp.asarray(ids.numpy()),
                                    name="v")
        return jnp.sum(r * r)
    jtap = jax.grad(jloss, argnums=1)(jnp.asarray(t.detach().numpy()),
                                      jnp.zeros((3, 3)))
    np.testing.assert_array_equal(gtap.numpy(), np.asarray(jtap))


def test_wire_helpers_match_the_jax_ones():
    rng = np.random.RandomState(0)
    ids = [rng.randint(0, 10, (4, 2)).astype(np.int32),
           rng.randint(0, 10, (3,)).astype(np.int32)]
    vals = [rng.randn(4, 2, 5).astype(np.float32),
            rng.randn(3, 5).astype(np.float32)]
    ti, tv = E.flatten_pairs([torch.from_numpy(i) for i in ids],
                             [torch.from_numpy(v) for v in vals])
    ji, jv = jE.flatten_pairs([jnp.asarray(i) for i in ids],
                              [jnp.asarray(v) for v in vals])
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    got = E.scatter_add_dense(ti, tv, 10, (5,)).numpy()
    want = np.asarray(jE.scatter_add_dense(ji, jv, 10, (5,)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_require_sparse_roundtrips_through_the_plan():
    gc = GraphConfig(replicas=["a:CPU:0"], require_sparse=True)
    assert GraphConfig.from_dict(gc.to_dict()).require_sparse
    assert strategy.Parallax(require_sparse=True).build(
        _Item(), _spec()).graph_config.require_sparse


class _Item:
    def __init__(self):
        from autodist_tpu_torch.model_item import VarInfo
        self.var_infos = {"t": VarInfo("t", (10, 4), "float32",
                                       sparse=True)}
        self.trainable_var_names = ["t"]


def _spec():
    from autodist_tpu_torch.resource_spec import ResourceSpec
    return ResourceSpec.from_dict({"nodes": [{"address": "127.0.0.1",
                                              "chief": True, "cpus": [0]}]})


# ------------------------------------------------------- N = 2 AllReduce


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The tower at N = 2 under AllReduce, its lookup named (the sparse
    wire) and unnamed (dense), 3 steps each, one 2-rank job."""
    payload = []
    for model in ("tower", "tower_unnamed"):
        _, params, example, _ = tower_setup(model == "tower", BATCH)
        rng = np.random.RandomState(7)
        batches = [{"ids": rng.randint(0, TOWER_VOCAB, (BATCH,)).astype(
            np.int32), "y": rng.randn(BATCH).astype(np.float32)}
            for _ in range(STEPS)]
        payload.append({"model": model, "seq_len": 0, "batch_size": BATCH,
                        "attention": "", "example": example,
                        "init": {n: t.numpy() for n, t in params.items()},
                        "batches": batches})
    return launch("train", 2, tmp_path_factory.mktemp("sparse"), payload)


def test_sparse_wire_engages_and_gives_the_dense_numerics(two_ranks):
    for sparse, dense in two_ranks:
        assert sparse["sparse_wire"] == ["emb.table"]
        assert dense["sparse_wire"] == []
        np.testing.assert_allclose(sparse["losses"], dense["losses"],
                                   rtol=1e-5)
        for name in sparse["params"]:
            np.testing.assert_allclose(sparse["params"][name],
                                       dense["params"][name], rtol=1e-4,
                                       atol=1e-6, err_msg=name)
    (s0, _), (s1, _) = two_ranks
    for name in s0["params"]:
        assert np.array_equal(s0["params"][name], s1["params"][name])


def test_sparse_wire_bytes_are_at_least_10x_fewer(two_ranks):
    (sparse, dense), _ = two_ranks
    dense_table = TOWER_VOCAB * TOWER_DIM * 4
    assert dense["counters"]["sync.wire_bytes"] >= STEPS * dense_table
    wire = sparse["counters"]["sync.wire_bytes"]
    assert wire * 10 <= dense["counters"]["sync.wire_bytes"]
    # the pairs: 256 ids a rank, an int32 and 16 f32 values each
    assert sparse["counters"]["sync.sparse_wire_bytes"] == \
        STEPS * (BATCH // 2) * (4 + 4 * TOWER_DIM)


# ------------------------------------------------------------- N = 1 PS


def _ps_run(builder, **setup):
    """STEPS steps of the tower at N = 1 under ``builder``: (the
    sparse-wire tables, the store's stats or None, the final params)."""
    loss_fn, params, batch, _ = tower_setup(batch_size=BATCH, **setup)
    ad = adt.AutoDist(strategy_builder=builder, device="cpu")
    runner = ad.build(loss_fn, functools.partial(torch.optim.Adam, lr=LR),
                      params, batch)
    runner.init(params)
    for _ in range(STEPS):
        runner.run(batch)
    dstep = runner.distributed_step
    dstep.flush_ps()
    out = (dstep.sparse_wire, dict(dstep.ps_store.stats)
           if dstep.ps_store is not None else None, runner.gather_params())
    adt.reset()
    return out


def _same_params(got, want):
    for name, value in got.items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_sparse_ps_ships_pairs_to_the_store():
    wire, stats, params = _ps_run(strategy.PS(), named=True)
    assert wire == {"emb.table"}
    # a step pushes the pairs and the head's dense gradient
    assert stats["bytes_pushed"] == STEPS * (BATCH * (4 + 4 * TOWER_DIM)
                                             + 4 * TOWER_DIM)
    assert stats["bytes_pushed"] * 10 < STEPS * TOWER_VOCAB * TOWER_DIM * 4
    _same_params(params, _ps_run(strategy.AllReduce(), named=True)[2])


@pytest.mark.parametrize("setup", [{"tied": True}, {"vocab": 64}],
                         ids=["tied", "small_vocab"])
def test_tied_or_small_tables_stay_dense(setup):
    """A table with another dense use would lose that gradient on the
    wire; a small vocabulary's pairs would outweigh its dense gradient:
    both push dense, with the dense numerics."""
    wire, stats, params = _ps_run(strategy.PS(), named=True, **setup)
    assert wire == frozenset()
    vocab = setup.get("vocab", TOWER_VOCAB)
    assert stats["bytes_pushed"] == STEPS * 4 * TOWER_DIM * (vocab + 1)
    _same_params(params,
                 _ps_run(strategy.AllReduce(), named=True, **setup)[2])


def _warnings(monkeypatch):
    from autodist_tpu_torch.kernel import graph_transformer
    said = []
    monkeypatch.setattr(graph_transformer.logging, "warning",
                        lambda msg, *a: said.append(msg % a))
    return said


def test_an_unrouted_lookup_warns_and_syncs_dense(monkeypatch):
    said = _warnings(monkeypatch)
    wire, stats, _ = _ps_run(strategy.PS(), named=False)
    assert wire == frozenset()
    assert stats["bytes_pushed"] == \
        STEPS * 4 * TOWER_DIM * (TOWER_VOCAB + 1)
    assert any("not routed through" in m for m in said), said


def test_require_sparse_raises_on_an_unrouted_lookup():
    with pytest.raises(ValueError, match="requires the sparse gradient"):
        _ps_run(strategy.PS(require_sparse=True), named=False)


def test_require_sparse_satisfied_runs_clean(monkeypatch):
    said = _warnings(monkeypatch)
    wire, _, _ = _ps_run(strategy.Parallax(require_sparse=True), named=True)
    assert wire == {"emb.table"}
    assert not said, said
