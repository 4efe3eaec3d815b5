"""autodist_tpu_torch's gradient sync pieces against the JAX package's:
the int8 wire codec, the buckets, the compressors on 2 ranks, the
collective keys, the replica bookkeeping and the per-rank batch split.

- The codec (``parallel/collectives.py``): the torch codec, its numpy
  mirror and the JAX package's ``quant_wire_np`` and jnp ``quant_wire``
  are bit-equal (int8 body, f32 scales, dequantized values), on lengths
  that are and are not block multiples, with a NaN and an inf block.
- ``make_buckets``: the same keys and members in the same order as the
  JAX package's on the two packages' own ``VarInfo``s of the same model.
- The compressors' ``reduce`` on 2 gloo ranks (``torch_dist_worker``)
  against the JAX compressors inside ``shard_map`` on 2 virtual CPU
  devices, on the same per-rank inputs: None, Horovod/BF16 and their EF
  forms, the armed ``Int8Compressor`` and ``Int8CompressorEF`` and
  ``int8_block_all_reduce`` are bit-equal, EF states included, on a
  block-multiple length, a ragged one and one with a NaN block; the
  unarmed int8 compressor is the bf16 psum; PowerSGD (rank 2, from the
  same Q) is allclose at 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodist_tpu.kernel.synchronization import compressor as JC
from autodist_tpu.kernel.synchronization.all_reduce_synchronizer import \
    AllReduceSynchronizer as JSync
from autodist_tpu.kernel.synchronization.collective_key import \
    CollectiveKey as JKey
from autodist_tpu.model_item import ModelItem as JModelItem
from autodist_tpu.models import lm as jlm
from autodist_tpu.parallel import collectives as jcoll
from autodist_tpu.resource_spec import ResourceSpec as JSpec
from autodist_tpu.strategy.all_reduce_strategy import AllReduce as JAllReduce
from autodist_tpu_torch import strategy
from autodist_tpu_torch.convert import params_from_jax
from autodist_tpu_torch.kernel.replicator import ReplicaInfo
from autodist_tpu_torch.kernel.synchronization import compressor as TC
from autodist_tpu_torch.kernel.synchronization.all_reduce_synchronizer \
    import AllReduceSynchronizer as TSync
from autodist_tpu_torch.kernel.synchronization.collective_key import \
    CollectiveKey as TKey
from autodist_tpu_torch.model_item import ModelItem
from autodist_tpu_torch.models import lm as tlm
from autodist_tpu_torch.parallel import collectives as tcoll
from autodist_tpu_torch.remapper import Remapper
from autodist_tpu_torch.resource_spec import ResourceSpec
from torch_dist_worker import launch

TWO = {"nodes": [{"address": "127.0.0.1", "chief": True, "cpus": [0, 1]}]}
BLOCK = 256


def _vector(length, seed, nan_block=False):
    rng = np.random.RandomState(seed)
    x = (rng.randn(length) * np.exp(rng.randn(length))).astype(np.float32)
    if nan_block:
        x[BLOCK + 3] = np.nan
        x[2 * BLOCK + 1] = np.inf
    return x


# ------------------------------------------------------------------ codec


@pytest.mark.parametrize("length,nan_block", [
    (1, False), (255, False), (256, False), (700, False), (4096, False),
    (700, True)])
def test_codec_is_bit_equal_to_its_mirror_and_to_jax(length, nan_block):
    x = _vector(length, length, nan_block)
    port = tcoll.quant_wire(torch.from_numpy(x))
    mirror = tcoll.quant_wire_np(x)
    jax_np = jcoll.quant_wire_np(x)
    jax_jnp = jcoll.quant_wire(jnp.asarray(x))
    for other in (mirror, jax_np, jax_jnp):
        assert np.array_equal(port["q"].numpy(), np.asarray(other["q"]))
        assert np.array_equal(port["s"].numpy(), np.asarray(other["s"]),
                              equal_nan=True)
    back = tcoll.dequant_wire(port, (length,)).numpy()
    assert np.array_equal(back, tcoll.dequant_wire_np(mirror, (length,)),
                          equal_nan=True)
    assert np.array_equal(back, jcoll.dequant_wire_np(jax_np, (length,)),
                          equal_nan=True)
    assert np.isnan(back).any() == nan_block


def test_wire_sizes_and_gate_equal_jax():
    assert tcoll.wire_block_size() == jcoll.wire_block_size() == BLOCK
    for n in (1, 255, 256, 257, 10 ** 6 + 3):
        assert tcoll.int8_wire_payload_bytes(n) == \
            jcoll.int8_wire_payload_bytes(n)
    from autodist_tpu.model_item import VarInfo as JVarInfo
    from autodist_tpu_torch.model_item import VarInfo
    for shape, dtype, sparse in [((300,), "float32", False),
                                 ((100,), "float32", False),
                                 ((300,), "int32", False),
                                 ((300, 4), "bfloat16", False),
                                 ((300, 4), "float32", True)]:
        for min_block in (False, True):
            assert tcoll.wire_quantizable(
                VarInfo("v", shape, dtype, sparse=sparse), min_block) == \
                jcoll.wire_quantizable(
                    JVarInfo("v", shape, dtype, sparse=sparse), min_block)


def test_collective_keys_and_compressor_registry_equal_jax():
    for name in ("params/embed/embedding", "g0_Int8CompressorEF", ""):
        assert TKey.instance_key(name) == JKey.instance_key(name)
    assert TC.known_names() == JC.known_names()
    assert TC.parse_name("PowerSGDCompressor:4") == ("PowerSGDCompressor", 4)
    for bad in ("nope", "HorovodCompressor:2", "PowerSGDCompressor:0",
                "PowerSGDCompressor:x"):
        with pytest.raises(ValueError) as err:
            TC.create(bad)
        with pytest.raises(ValueError) as jerr:
            JC.create(bad)
        assert str(err.value) == str(jerr.value)
    with pytest.raises(ValueError, match="HorovodCompressorEF"):
        TC.create("nope")       # the message lists the registry


# ----------------------------------------------------------------- buckets


@pytest.mark.parametrize("compressor,wire,chunk", [
    ("HorovodCompressor", "fp32", 4), ("NoneCompressor", "int8", 4),
    ("NoneCompressor", "int8", 128), ("BF16CompressorEF", "fp32", 16)])
def test_make_buckets_matches_jax(compressor, wire, chunk):
    """The same bucket keys and members, in the same (instance-key)
    order, from each package's own item and plan for lm tiny."""
    jloss, jparams, batch, _ = jlm.make_train_setup(
        jlm.LMConfig.tiny(), seq_len=16, batch_size=4)
    tloss, _, _, _ = tlm.make_train_setup(tlm.LMConfig.tiny(), seq_len=16,
                                          batch_size=4)
    jitem = JModelItem(loss_fn=jloss, params=jparams,
                       example_batch=batch).prepare()
    titem = ModelItem(loss_fn=tloss, params=params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams)),
        example_batch=batch).prepare()
    kw = dict(chunk_size=chunk, compressor=compressor, wire_dtype=wire)
    jplan = JAllReduce(**kw).build(jitem, JSpec.from_dict(TWO))
    tplan = strategy.AllReduce(**kw).build(titem,
                                           ResourceSpec.from_dict(TWO))

    def concat(syncs):
        return {n: s for n, s in syncs.items()
                if s.compressor.name != "NoneCompressor"}
    jb, _ = jcoll.make_buckets(concat({
        n.var_name: JSync(n.var_name, n.synchronizer, 2)
        for n in jplan.node_config}), jitem.var_infos)
    tb, _ = tcoll.make_buckets(concat({
        n.var_name: TSync(n.var_name, n.synchronizer, 2, n_data=2)
        for n in tplan.node_config}), titem.var_infos)
    assert [b.key for b in tb] == [b.key for b in jb] and jb
    for t, j in zip(tb, jb):
        assert t.collective_names == j.var_names
        assert t.sizes == j.sizes and t.total_size == j.total_size


# ------------------------------------------------- compressors on 2 ranks


def _cases():
    rng = np.random.RandomState(7)
    pair = lambda L, seed, nan=False: np.stack(  # noqa: E731
        [_vector(L, seed, nan), _vector(L, seed + 1)])
    ef = lambda L: (rng.randn(2, L) * 1e-3).astype(np.float32)  # noqa: E731
    cases = [dict(name="none", compressor="NoneCompressor", x=pair(700, 1))]
    for comp in ("HorovodCompressor", "BF16Compressor"):
        cases.append(dict(name=comp, compressor=comp, x=pair(700, 3)))
    for comp in ("HorovodCompressorEF", "BF16CompressorEF"):
        cases.append(dict(name=comp, compressor=comp, x=pair(700, 5),
                          state=ef(700)))
    cases.append(dict(name="int8_unarmed", compressor="Int8Compressor",
                      x=pair(700, 9)))
    for L, nan in ((512, False), (700, False), (1000, True)):
        tag = "%d%s" % (L, "_nan" if nan else "")
        cases.append(dict(name="two_phase_" + tag,
                          compressor="int8_block_all_reduce",
                          x=pair(L, 11, nan)))
        cases.append(dict(name="int8_" + tag, compressor="Int8Compressor",
                          x=pair(L, 13, nan), armed=True))
        cases.append(dict(name="int8ef_" + tag,
                          compressor="Int8CompressorEF", x=pair(L, 15, nan),
                          state=ef(L), armed=True))
    q0 = np.asarray(JC.create("PowerSGDCompressor:2", "w").state_init(
        (12, 9), jnp.float32)["q"])
    cases.append(dict(name="powersgd", compressor="PowerSGDCompressor:2",
                      var_name="w", x=rng.randn(2, 12, 9).astype(np.float32),
                      state={"error": (rng.randn(2, 12, 9) * 0.1).astype(
                          np.float32), "q": np.stack([q0, q0])}))
    return cases


def _jax_reduce(case):
    """The JAX compressor's reduce inside shard_map on 2 devices, on
    device i's row of the case's inputs: (reduced [2, ...], state)."""
    from jax.sharding import Mesh, PartitionSpec as P
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    psum = lambda v: jax.lax.psum(v, "data")  # noqa: E731
    state = case.get("state")

    def body(x, st):
        x = x[0]
        st = jax.tree_util.tree_map(lambda a: a[0], st)
        if case["compressor"] == "int8_block_all_reduce":
            r, ns = jcoll.int8_block_all_reduce(x, "data", 2), None
        else:
            comp = JC.create(case["compressor"], case.get("var_name", ""))
            if case.get("armed"):
                comp.ring_axes = (("data", 2),)
            r, ns = comp.reduce(x, st, psum)
        return r[None], jax.tree_util.tree_map(lambda a: a[None], ns)
    fn = jax.shard_map(body, mesh=mesh, in_specs=(P("data"), P("data")),
                       out_specs=(P("data"), P("data")), check_vma=False)
    # Int8CompressorEF op by op: under jit, XLA's CPU backend contracts
    # its ``compensated - q * s`` (and, in some fusions, the dequant-
    # accumulate) into fused multiply-adds, one rounding fewer than the
    # ops as written, which the port and the numpy mirror compute
    with jax.disable_jit(case["compressor"] == "Int8CompressorEF"):
        r, ns = (fn if case["compressor"] == "Int8CompressorEF"
                 else jax.jit(fn))(jnp.asarray(case["x"]),
                                   jax.tree_util.tree_map(jnp.asarray, state))
    return np.asarray(r), jax.tree_util.tree_map(np.asarray, ns)


@pytest.fixture(scope="module")
def reduced(tmp_path_factory):
    """{case: (JAX (reduced, state), port ranks' [(reduced, state)])}."""
    cases = _cases()
    ranks = launch("compressors", 2, tmp_path_factory.mktemp("comp"), cases)
    return {c["name"]: (c, _jax_reduce(c), [r[c["name"]] for r in ranks])
            for c in cases}


BITWISE = [c["name"] for c in _cases() if c["name"] != "powersgd"]


@pytest.mark.parametrize("name", BITWISE)
def test_compressor_on_two_ranks_is_bit_equal_to_jax(reduced, name):
    case, (jr, jst), ranks = reduced[name]
    for rank, (r, st) in enumerate(ranks):
        assert r.dtype == jr.dtype
        assert np.array_equal(r, jr[rank], equal_nan=True), rank
        if jst is None:
            assert st is None
        else:
            assert np.array_equal(st, jst[rank], equal_nan=True), rank
    # every rank holds the same reduced bytes
    assert np.array_equal(ranks[0][0], ranks[1][0], equal_nan=True)
    if "nan" in name:
        assert np.isnan(ranks[0][0]).any()


def test_unarmed_int8_is_the_bf16_psum(reduced):
    case, _, ranks = reduced["int8_unarmed"]
    want = torch.from_numpy(case["x"]).bfloat16().float().sum(0).bfloat16()
    assert np.array_equal(ranks[0][0], want.float().numpy())


def test_powersgd_on_two_ranks_matches_jax(reduced):
    _, (jr, jst), ranks = reduced["powersgd"]
    for rank, (r, st) in enumerate(ranks):
        np.testing.assert_allclose(r, jr[rank], rtol=1e-5, atol=1e-5)
        for key in ("error", "q"):
            np.testing.assert_allclose(st[key], jst[key][rank], rtol=1e-5,
                                       atol=1e-5)


def test_powersgd_state_seeds_the_same_q_on_every_rank():
    comp = TC.create("PowerSGDCompressor:3", "params/w/kernel")
    a = comp.state_init((8, 6), torch.float32)
    b = TC.create("PowerSGDCompressor:3",
                  "params/w/kernel").state_init((8, 6), "float32")
    assert a["q"].shape == (6, 3) and torch.equal(a["q"], b["q"])
    assert comp.state_init((8,), torch.float32) is None


# ------------------------------------------------- replicas and the feed


def test_rank_takes_its_rows_of_the_global_batch():
    batch = {"x": np.arange(16, dtype=np.float32).reshape(8, 2),
             "t": torch.arange(8), "scale": 3.0, "nested": [np.ones((8, 1))]}
    for rank in (0, 1):
        out = Remapper("cpu", ReplicaInfo(2, rank)).remap_feed(batch)
        rows = slice(4 * rank, 4 * rank + 4)
        assert torch.equal(out["x"], torch.from_numpy(batch["x"][rows]))
        assert torch.equal(out["t"], batch["t"][rows])
        assert float(out["scale"]) == 3.0 and out["nested"][0].shape == (4, 1)
    one = Remapper("cpu").remap_feed(batch)
    assert one["x"].shape == (8, 2)


def test_indivisible_batch_raises_the_jax_error():
    from jax.sharding import Mesh
    from autodist_tpu.remapper import Remapper as JRemapper
    with pytest.raises(ValueError) as err:
        Remapper("cpu", ReplicaInfo(2, 0)).remap_feed(
            {"x": np.zeros((5, 3))})
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    with pytest.raises(ValueError) as jerr:
        JRemapper(mesh, "data").remap_feed({"x": np.zeros((5, 3))})
    head = "global batch dim 5 is not divisible by the 2 replicas"
    assert str(err.value).startswith(head)
    assert str(jerr.value).startswith(head)


def test_replica_info():
    info = ReplicaInfo(4, 3)
    assert (info.num_replicas, info.rank, info.batch_factor,
            info.seq_factor) == (4, 3, 4, 1)
    assert info.local_shape((8, 16)) == (2, 16)
    assert info.local_shape((6, 16)) == (6, 16)   # indivisible: unsplit
    assert info.local_rows(8) == slice(6, 8)
    with pytest.raises(ValueError, match="rank 2"):
        ReplicaInfo(2, 2)
    # a sequence axis and joint batch axes name axes of a mesh, and their
    # blocks are the JAX Remapper's, device r for rank r
    from jax.sharding import Mesh
    from autodist_tpu.remapper import Remapper as JRemapper
    from autodist_tpu_torch.parallel.mesh import ProcessMesh
    with pytest.raises(ValueError, match="axes of a mesh"):
        ReplicaInfo(2, 0, seq_axis="seq")
    batch = {"tokens": np.arange(8 * 12, dtype=np.int32).reshape(8, 12),
             "labels": np.arange(8 * 3, dtype=np.float32).reshape(8, 3),
             "scale": np.float32(2.0)}
    for axes, kw, jkw in (
            ({"data": 2, "seq": 2}, {"seq_axis": "seq",
                                     "seq_keys": ["tokens"]},
             {"seq_axis": "seq", "seq_keys": ["tokens"]}),
            ({"data": 2, "expert": 2}, {"batch_axes": ["data", "expert"]},
             {"batch_axes": ["data", "expert"]})):
        jmesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), tuple(axes))
        placed = JRemapper(jmesh, "data", **jkw).remap_feed(batch)
        for rank in range(4):
            info = ReplicaInfo(4, rank, mesh=ProcessMesh(axes, rank), **kw)
            got = Remapper("cpu", info).remap_feed(batch)
            dev = jmesh.devices.flat[rank]
            for k in ("tokens", "labels"):
                want = next(s.data for s in placed[k].addressable_shards
                            if s.device == dev)
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(want))
            assert float(got["scale"]) == 2.0
        assert info.local_shape((8, 12), "tokens") == \
            ((4, 6) if "seq_axis" in kw else (2, 12))
    # an indivisible sequence dim raises the JAX Remapper's error
    info = ReplicaInfo(2, 0, mesh=ProcessMesh({"data": 1, "seq": 2}, 0),
                       seq_axis="seq")
    with pytest.raises(ValueError) as err:
        Remapper("cpu", info).remap_feed({"labels": np.zeros((2, 5))})
    jmesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("data", "seq"))
    with pytest.raises(ValueError) as jerr:
        JRemapper(jmesh, "data", seq_axis="seq").remap_feed(
            {"labels": np.zeros((2, 5))})
    assert str(err.value) == str(jerr.value)
