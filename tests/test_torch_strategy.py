"""autodist_tpu_torch's strategy IR against the JAX package's: for the same
variable list and resource spec, the AllReduce plan and the PS family's
(``PS``, ``PSLoadBalancing``, ``PartitionedPS``, ``UnevenPartitionedPS``,
``Parallax``) serialize to the same JSON bytes (the IR is framework-free,
and the port carries a copy); the PS family over ncf, dlrm and lm tiny's
variable lists, on one node and on three (a ``resource_spec.yml``); and
the port's ``ModelItem`` lists those models' variables, sizes and table
flags as the JAX item does."""
import json

import numpy as np
import pytest
import torch

from autodist_tpu.model_item import VarInfo as JVarInfo
from autodist_tpu.resource_spec import ResourceSpec as JSpec
from autodist_tpu.strategy.all_reduce_strategy import AllReduce as JAllReduce
from autodist_tpu_torch.model_item import ModelItem, VarInfo
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy import AllReduce


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; one thread keeps
    these tests from contending with the suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Item:
    """The two fields a builder reads, over a fixed variable list."""

    def __init__(self, infos):
        self.var_infos = {i.name: i for i in infos}
        self.trainable_var_names = [i.name for i in infos]


VARS = [("embed/embedding", (1000, 64)), ("dense/kernel", (64, 64)),
        ("dense/bias", (64,)), ("head/kernel", (64, 8))]


@pytest.mark.parametrize("chunk,wire", [(128, "fp32"), (2, "int8")])
def test_allreduce_plan_bytes_match_jax(chunk, wire):
    spec_dict = {"nodes": [{"address": "127.0.0.1", "chief": True,
                            "cpus": [0, 1]}]}
    jitem = _Item([JVarInfo(n, s, "float32") for n, s in VARS])
    titem = _Item([VarInfo(n, s, "float32") for n, s in VARS])
    jplan = JAllReduce(chunk_size=chunk, wire_dtype=wire).build(
        jitem, JSpec.from_dict(spec_dict))
    tplan = AllReduce(chunk_size=chunk, wire_dtype=wire).build(
        titem, ResourceSpec.from_dict(spec_dict))
    tplan.id = jplan.id
    dump = lambda p: json.dumps(p.to_dict(), sort_keys=True)  # noqa: E731
    assert dump(tplan) == dump(jplan)


def test_model_item_reads_a_state_dict():
    params = {"w": torch.zeros(3, 4), "b": np.zeros(4, np.float32),
              "h": torch.zeros(2, dtype=torch.bfloat16)}
    item = ModelItem(loss_fn=lambda p, b: 0.0, params=params).prepare()
    assert item.var_infos["w"].shape == (3, 4)
    assert item.var_infos["h"].dtype == "bfloat16"
    assert item.total_bytes() == 3 * 4 * 4 + 4 * 4 + 2 * 2
    with pytest.raises(TypeError, match="state_dict"):
        ModelItem(loss_fn=lambda p, b: 0.0, params=[1]).prepare()


def test_model_item_default_filter_freezes_batch_stats_as_jax_does():
    """The default ``trainable_filter`` keeps flax's ``batch_stats``
    collection from training, under the port's ``.``-joined names, as the
    JAX item's default does under its ``/``-joined ones."""
    from autodist_tpu.model_item import ModelItem as JModelItem
    names = ["params/bn_init/scale", "batch_stats/bn_init/mean",
             "batch_stats/BottleneckBlock_0/norm_proj/var",
             "params/head/kernel", "outer/batch_stats/m/var",
             "params/batch_statsx/kernel"]
    jitem = JModelItem(loss_fn=lambda p, b: 0.0)
    titem = ModelItem(loss_fn=lambda p, b: 0.0)
    for name in names:
        port = name[len("params/"):] if name.startswith("params/") else name
        port = port.replace("/", ".")
        assert titem.trainable_filter(port) == jitem.trainable_filter(name), \
            name
    params = {"bn_init.weight": torch.ones(4),
              "batch_stats.bn_init.mean": torch.zeros(4),
              "batch_stats.bn_init.var": torch.ones(4)}
    item = ModelItem(loss_fn=lambda p, b: 0.0, params=params).prepare()
    assert item.trainable_var_names == ["bn_init.weight"]
    assert not item.var_infos["batch_stats.bn_init.var"].trainable
    # an explicit filter still decides alone
    item = ModelItem(loss_fn=lambda p, b: 0.0, params=params,
                     trainable_filter=lambda n: True).prepare()
    assert len(item.trainable_var_names) == 3


# --------------------------------------------------------------- PS family

THREE_NODES = """
nodes:
  - address: 10.0.0.1
    cpus: [0, 1]
    chief: true
  - address: 10.0.0.2
    cpus: [0]
  - address: 10.0.0.3
    cpus: [0]
"""
PS_BUILDERS = {"PS": ("PS", {}),
               "PS_int8": ("PS", {"wire_dtype": "int8"}),
               "PSLoadBalancing": ("PSLoadBalancing", {}),
               "PartitionedPS": ("PartitionedPS", {}),
               "UnevenPartitionedPS": ("UnevenPartitionedPS", {}),
               "Parallax": ("Parallax", {}),
               "PS_proxy_stale": ("PS", {"local_proxy_variable": True,
                                         "staleness": 1})}


def _recsys_items(model):
    """(JAX ModelItem, port ModelItem) of a tiny model from the same JAX
    init (the port's params converted)."""
    import jax
    from autodist_tpu.model_item import ModelItem as JModelItem
    from autodist_tpu.models import dlrm as jdlrm
    from autodist_tpu.models import lm as jlm
    from autodist_tpu.models import ncf as jncf
    from autodist_tpu_torch.convert import params_from_jax
    from autodist_tpu_torch.models import dlrm as tdlrm
    from autodist_tpu_torch.models import lm as tlm
    from autodist_tpu_torch.models import ncf as tncf
    if model == "ncf":
        jl, jp, batch, _ = jncf.make_train_setup(jncf.NCFConfig.tiny(),
                                                 batch_size=8)
        tl = tncf.make_train_setup(tncf.NCFConfig.tiny(), batch_size=8)[0]
    elif model == "dlrm":
        jl, jp, batch, _ = jdlrm.make_train_setup(jdlrm.DLRMConfig.tiny(),
                                                  batch_size=8)
        tl = tdlrm.make_train_setup(tdlrm.DLRMConfig.tiny(),
                                    batch_size=8)[0]
    else:
        jl, jp, batch, _ = jlm.make_train_setup(jlm.LMConfig.tiny(),
                                                seq_len=16, batch_size=8)
        tl = tlm.make_train_setup(tlm.LMConfig.tiny(), seq_len=16,
                                  batch_size=8)[0]
    jitem = JModelItem(loss_fn=jl, params=jp, example_batch=batch).prepare()
    init = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    titem = ModelItem(loss_fn=tl, params=init, example_batch=batch).prepare()
    return jitem, titem


@pytest.fixture(scope="module")
def recsys_items():
    return {m: _recsys_items(m) for m in ("ncf", "dlrm", "lm")}


@pytest.mark.parametrize("model", ["ncf", "dlrm", "lm"])
def test_model_item_lists_the_jax_variables_and_tables(recsys_items, model):
    """The port's item: the JAX item's variables in its order, their
    element counts and their sparse (lookup-table) flags — what the PS
    builders read."""
    jitem, titem = recsys_items[model]
    got = [(v.collective_name, v.num_elements, v.sparse, v.trainable)
           for v in titem.var_infos.values()]
    want = [(v.name, int(np.prod(v.shape or (1,))), v.sparse, v.trainable)
            for v in jitem.var_infos.values()]
    assert got == want
    assert any(v.sparse for v in titem.var_infos.values())


@pytest.mark.parametrize("spec", ["one", "three"])
@pytest.mark.parametrize("case", list(PS_BUILDERS))
@pytest.mark.parametrize("model", ["ncf", "dlrm", "lm"])
def test_ps_family_plan_bytes_match_jax(recsys_items, tmp_path, model, case,
                                        spec):
    """Each PS-family builder over a model's variable list (the JAX
    item's names, flax shapes and sparse flags) emits the JAX builder's
    plan, byte for byte, on one node and on three (a PS a node: owners
    round-robin, shards, uneven sizes)."""
    from autodist_tpu import strategy as jstrategy
    from autodist_tpu_torch import strategy
    jitem, _ = recsys_items[model]
    jlist = _Item([JVarInfo(v.name, tuple(v.shape), v.dtype,
                            trainable=v.trainable, sparse=v.sparse)
                   for v in jitem.var_infos.values()])
    tlist = _Item([VarInfo(v.name, tuple(v.shape), v.dtype,
                           trainable=v.trainable, sparse=v.sparse)
                   for v in jitem.var_infos.values()])
    if spec == "one":
        jspec = JSpec.from_dict({"nodes": [{"address": "127.0.0.1",
                                            "chief": True, "cpus": [0]}]})
        tspec = ResourceSpec.from_dict({"nodes": [{
            "address": "127.0.0.1", "chief": True, "cpus": [0]}]})
    else:
        path = tmp_path / "resource_spec.yml"
        path.write_text(THREE_NODES)
        jspec, tspec = JSpec(str(path)), ResourceSpec(str(path))
    name, kw = PS_BUILDERS[case]
    jplan = getattr(jstrategy, name)(**kw).build(jlist, jspec)
    tplan = getattr(strategy, name)(**kw).build(tlist, tspec)
    tplan.id = jplan.id
    dump = lambda p: json.dumps(p.to_dict(), sort_keys=True)  # noqa: E731
    assert dump(tplan) == dump(jplan)
    if spec == "three" and "Partitioned" in name:
        owners = {p.synchronizer.reduction_destination
                  for n in tplan.node_config for p in n.part_configs}
        assert len(owners) == 3
    if case == "UnevenPartitionedPS" and spec == "three":
        assert any(n.shard_sizes and len(set(n.shard_sizes)) > 1
                   for n in tplan.node_config)
