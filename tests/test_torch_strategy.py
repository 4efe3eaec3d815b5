"""autodist_tpu_torch's strategy IR against the JAX package's: for the same
variable list and resource spec, the AllReduce plan serializes to the same
JSON bytes (the IR is framework-free, and the port carries a copy)."""
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
