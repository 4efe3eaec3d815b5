"""autodist_tpu_torch's input plane on the CPU, held to the JAX package's:
the ADT1 record files and the native loader (the port's own copy of the
C++ source, built into ``autodist_tpu_torch/build/``), the text corpus
helpers, ``stack_batches`` and ``DevicePrefetcher``.

Files and batches are compared bit for bit: a file either package writes
reads in the other, and one seed gives the same batches in the same
order. The real-text run trains lm tiny-sized on the repository's docs
through the port's loader, prefetcher and fused ``fit``, and must end
below the corpus's unigram entropy, as
``tests/test_real_data_pipeline.py`` holds the JAX package.
"""
import functools
import os

import numpy as np
import pytest
import torch

import autodist_tpu_torch as adt
from autodist_tpu.data import record_dataset as jrd
from autodist_tpu.data import text as jtext
from autodist_tpu_torch import strategy
from autodist_tpu_torch.data import (DevicePrefetcher, RecordFileDataset,
                                     RecordFileWriter, record_dataset, text)
from autodist_tpu_torch.data.prefetch import stack_batches

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, BATCH = 24, 4


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


def _write(writer_cls, path):
    with writer_cls(path, fields=[("x", np.float32, (3, 2)),
                                  ("y", np.int32, ())]) as w:
        for i in range(N):
            w.write({"x": np.full((3, 2), i, np.float32) + 0.5,
                     "y": np.int32(i)})
    return path


@pytest.fixture
def record_file(tmp_path):
    return _write(RecordFileWriter, str(tmp_path / "train.adt"))


def _stream(cls, path, n, **kw):
    with cls(path, BATCH, **kw) as ds:
        return [next(ds) for _ in range(n)]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_file_either_package_writes_reads_in_both(tmp_path, writer):
    """The same bytes, sidecar included, from either writer; each reader
    gives the other's batches bit for bit, over two shuffled epochs."""
    path = str(tmp_path / "w.adt")
    _write(jrd.RecordFileWriter if writer == "jax" else RecordFileWriter,
           path)
    other = _write(RecordFileWriter if writer == "jax"
                   else jrd.RecordFileWriter, str(tmp_path / "o.adt"))
    for suffix in ("", ".json"):
        with open(path + suffix, "rb") as a, open(other + suffix, "rb") as b:
            assert a.read() == b.read()
    n = 2 * N // BATCH
    got = _stream(RecordFileDataset, path, n, shuffle=True, seed=5)
    want = _stream(jrd.RecordFileDataset, path, n, shuffle=True, seed=5)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
    ids = [b["y"].tolist() for b in got]
    assert sorted(sum(ids[:N // BATCH], [])) == list(range(N))
    assert ids[:N // BATCH] != ids[N // BATCH:]   # a fresh permutation


@pytest.mark.parametrize("threads", [1, 3])
def test_one_seed_gives_one_stream(record_file, threads):
    a = _stream(RecordFileDataset, record_file, 8, seed=9,
                num_threads=threads)
    b = _stream(RecordFileDataset, record_file, 8, seed=9, num_threads=2)
    c = _stream(RecordFileDataset, record_file, 8, seed=10)
    assert all(np.array_equal(x["y"], y["y"]) for x, y in zip(a, b))
    assert not all(np.array_equal(x["y"], y["y"]) for x, y in zip(a, c))


def test_sharded_loaders_are_disjoint_and_match_jax(record_file):
    seen = {}
    for i in range(3):
        with RecordFileDataset(record_file, 4, seed=7, shard=(i, 3)) as ds:
            assert ds.num_records == 8 and ds.num_records_global == N
            ids = sum((next(ds)["y"].tolist()
                       for _ in range(ds.batches_per_epoch)), [])
        seen[i] = set(ids)
        assert seen[i] == {r for r in range(N) if r % 3 == i}
        with jrd.RecordFileDataset(record_file, 4, seed=7,
                                   shard=(i, 3)) as ds:
            assert sum((next(ds)["y"].tolist()
                        for _ in range(ds.batches_per_epoch)), []) == ids
    assert seen[0] | seen[1] | seen[2] == set(range(N))
    with pytest.raises(ValueError):
        RecordFileDataset(record_file, batch_size=4, shard=(3, 3))


def test_drop_remainder_and_copy_false_views(tmp_path, record_file):
    """``tests/test_data.py::test_drop_remainder``'s rule: records that do
    not fill a batch are dropped and the next epoch restarts; and
    ``copy=False`` batches are views valid until the next one."""
    path = str(tmp_path / "odd.adt")
    with RecordFileWriter(path, fields=[("y", np.int64, ())]) as w:
        for i in range(10):
            w.write({"y": np.int64(i)})
    with RecordFileDataset(path, 4, shuffle=False) as ds:
        assert ds.batches_per_epoch == 2
        assert [next(ds)["y"].tolist() for _ in range(3)] == \
            [[0, 1, 2, 3], [4, 5, 6, 7], [0, 1, 2, 3]]
    with RecordFileDataset(record_file, BATCH, shuffle=False,
                           copy=False) as ds:
        b1 = next(ds)
        first = b1["y"].copy()
        assert not b1["y"].flags.owndata
        next(ds)
        assert first.tolist() == [0, 1, 2, 3]
    with RecordFileDataset(record_file, BATCH, shuffle=False) as ds:
        b1 = next(ds)
        next(ds)
        assert b1["y"].tolist() == [0, 1, 2, 3]   # an owning copy
    with pytest.raises(ValueError, match="shape"):
        with RecordFileWriter(str(tmp_path / "bad.adt"),
                              [("x", np.float32, (2,))]) as w:
            w.write({"x": np.zeros(3, np.float32)})


def test_the_loader_builds_from_the_ports_own_source():
    lib = record_dataset.build_library()
    assert lib == record_dataset.library_path() and os.path.isfile(lib)
    assert os.path.dirname(lib) == record_dataset.BUILD_DIR
    assert record_dataset.SOURCE.startswith(os.path.join(
        REPO, "autodist_tpu_torch"))
    with open(record_dataset.SOURCE, "rb") as f:
        body = f.read()
    with open(os.path.join(REPO, "autodist_tpu", "native", "dataloader",
                           "dataloader.cc"), "rb") as f:
        reference = f.read()
    # the same code: the copy adds header lines only
    assert body.endswith(reference[reference.index(b"#include"):])


def test_text_helpers_equal_the_jax_ones(tmp_path):
    paths = text.repo_docs_corpus(REPO)
    assert paths == jtext.repo_docs_corpus(REPO) and len(paths) >= 3
    data = text.load_text(paths)
    assert data == jtext.load_text(paths) and len(data) > 10_000
    for seq, stride in ((64, 0), (32, 7)):
        np.testing.assert_array_equal(text.byte_windows(data, seq, stride),
                                      jtext.byte_windows(data, seq, stride))
    with pytest.raises(ValueError, match="too small"):
        text.byte_windows(b"abc", 8)
    a, b = str(tmp_path / "a.adt"), str(tmp_path / "b.adt")
    assert text.write_lm_records(paths, a, 32) == \
        jtext.write_lm_records(paths, b, 32)
    for suffix in ("", ".json"):
        with open(a + suffix, "rb") as x, open(b + suffix, "rb") as y:
            assert x.read() == y.read()
    assert text.BYTE_VOCAB == jtext.BYTE_VOCAB == 256


def test_stack_batches_pad_and_refusals():
    group = [{"x": np.full((2, 3), i, np.float32),
              "t": torch.full((2,), i)} for i in range(3)]
    out = stack_batches(group)
    assert out["x"].shape == (3, 2, 3) and isinstance(out["x"], np.ndarray)
    assert isinstance(out["t"], torch.Tensor) and out["t"].shape == (3, 2)
    padded = stack_batches(group, pad_to=5)
    assert padded["x"].shape == (5, 2, 3)
    np.testing.assert_array_equal(padded["x"][3:], np.full((2, 2, 3), 2.0))
    with pytest.raises(ValueError, match="empty group"):
        stack_batches([])
    with pytest.raises(ValueError, match="pad_to"):
        stack_batches(group, pad_to=2)


def _runner(example):
    ad = adt.AutoDist(strategy_builder=strategy.AllReduce(), device="cpu")

    def loss(p, b):
        x = torch.as_tensor(b["x"]).reshape(b["x"].shape[0], -1)
        return ((x @ p["w"]).mean() - torch.as_tensor(b["y"]).float()
                .mean()) ** 2
    params = {"w": torch.ones((6, 1))}
    runner = ad.build(loss, functools.partial(torch.optim.Adam, lr=0.01),
                      params, example)
    runner.init(params)
    return runner


def test_prefetcher_matches_the_direct_feed(record_file):
    with RecordFileDataset(record_file, 8, shuffle=False) as ds:
        example = next(ds)

    def run(mode):
        adt.reset()
        runner = _runner(example)
        with RecordFileDataset(record_file, 8, seed=3) as ds:
            if mode == "direct":
                return [float(runner.run(next(ds))["loss"])
                        for _ in range(12)]
            if mode == "prefetch":
                return [float(runner.run(b)["loss"]) for b in
                        DevicePrefetcher(ds, runner, depth=2).take(12)]
            pf = DevicePrefetcher(ds, runner, depth=2, stack=4)
            return [float(m["loss"]) for m in runner.fit(
                pf, steps=12, fuse_steps=4)]
    direct = run("direct")
    assert run("prefetch") == direct
    assert run("stacked") == direct
    with pytest.raises(ValueError):
        DevicePrefetcher([], lambda b: b, depth=0)
    with pytest.raises(ValueError):
        DevicePrefetcher([], lambda b: b, stack=0)
    assert list(DevicePrefetcher([1, 2, 3], lambda b: b * 10)) == \
        [10, 20, 30]


def test_prefetcher_stack_mode_shapes_and_tail_drop():
    batches = [{"x": np.full((4, 2), i, np.float32)} for i in range(10)]
    pf = DevicePrefetcher(iter(batches), lambda b: b, depth=2, stack=4)
    items = list(pf)
    assert len(items) == 2 and items[0]["x"].shape == (4, 4, 2)
    np.testing.assert_array_equal(items[1]["x"][0], batches[4]["x"])
    assert (pf.dropped_batches, pf.dropped_examples) == (2, 8)


def test_real_text_trains_through_the_native_loader(tmp_path):
    """docs text -> ADT1 records -> the port's native loader ->
    DevicePrefetcher(stack=4) -> fit(fuse_steps=4): the loss ends below
    the corpus's unigram entropy (the model uses context)."""
    from autodist_tpu_torch.models.lm import LMConfig, make_train_setup
    seq_len = 32
    rec = str(tmp_path / "docs.adt")
    n = text.write_lm_records(text.repo_docs_corpus(REPO), rec, seq_len)
    assert n > 300
    cfg = LMConfig(vocab_size=text.BYTE_VOCAB, d_model=64, num_layers=2,
                   num_heads=4, mlp_dim=128, max_seq_len=seq_len)
    loss_fn, params, example, _ = make_train_setup(
        cfg, seq_len=seq_len, batch_size=32, attention="default")
    ad = adt.AutoDist(strategy_builder=strategy.AllReduce(), device="cpu")
    runner = ad.build(loss_fn, functools.partial(torch.optim.Adam, lr=3e-3),
                      params, example)
    runner.init(params)
    with RecordFileDataset(rec, batch_size=32, shuffle=True, seed=0) as ds:
        pf = DevicePrefetcher(ds, runner, depth=2, stack=4)
        history = runner.fit(pf, steps=120, fuse_steps=4, metrics_every=5)
    assert len(history) == 120
    assert runner.distributed_step.dispatches == 30
    first, last = float(history[0]["loss"]), float(history[-1]["loss"])
    data = np.frombuffer(text.load_text(text.repo_docs_corpus(REPO)),
                         np.uint8)
    p = np.bincount(data, minlength=256).astype(np.float64)
    p = p[p > 0] / p.sum()
    unigram_nats = float(-(p * np.log(p)).sum())
    assert first > 0.8 * np.log(text.BYTE_VOCAB)   # starts near chance
    assert last < unigram_nats, (first, last, unigram_nats)
