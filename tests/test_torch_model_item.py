"""autodist_tpu_torch's ModelItem against the JAX package's, each built by
its own package from its own model: the variable order (ROADMAP C1), the
sparse flags (C2) and the collective names, and through them the
AllReduce plan each variable gets.

lm, bert and resnet at their tiny configs (``LMConfig.tiny``,
``BertConfig.tiny``, ``ResNetTiny``), float32, with the port's params
converted from the JAX init (``convert.params_from_jax``) and one numpy
example batch for both. Every comparison is exact: names, order, flags
and each variable's ``(group, compressor, wire_dtype)`` under
``AllReduce`` at chunk sizes 4 and 128 with the fp32 and the int8 wire.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from autodist_tpu.model_item import ModelItem as JModelItem
from autodist_tpu.models import bert as jbert
from autodist_tpu.models import lm as jlm
from autodist_tpu.models import resnet as jresnet
from autodist_tpu.resource_spec import ResourceSpec as JSpec
from autodist_tpu.strategy.all_reduce_strategy import AllReduce as JAllReduce
from autodist_tpu_torch import strategy
from autodist_tpu_torch.convert import (from_jax_layout, jax_name,
                                        params_from_jax, to_jax_layout)
from autodist_tpu_torch.model_item import (ModelItem, detect_sparse_vars,
                                           trace_lookups)
from autodist_tpu_torch.models import bert as tbert
from autodist_tpu_torch.models import lm as tlm
from autodist_tpu_torch.models import resnet as tresnet
from autodist_tpu_torch.resource_spec import ResourceSpec

TWO = {"nodes": [{"address": "127.0.0.1", "chief": True, "cpus": [0, 1]}]}
MODELS = {
    "lm": (functools.partial(jlm.make_train_setup, jlm.LMConfig.tiny(),
                             seq_len=16, batch_size=4),
           functools.partial(tlm.make_train_setup, tlm.LMConfig.tiny(),
                             seq_len=16, batch_size=4)),
    "bert": (functools.partial(jbert.make_train_setup,
                               jbert.BertConfig.tiny(), seq_len=16,
                               batch_size=4, attention="xla"),
             functools.partial(tbert.make_train_setup,
                               tbert.BertConfig.tiny(), seq_len=16,
                               batch_size=4, attention="xla")),
    "resnet": (functools.partial(jresnet.make_train_setup,
                                 jresnet.ResNetTiny, num_classes=10,
                                 image_size=32, batch_size=4),
               functools.partial(tresnet.make_train_setup,
                                 tresnet.ResNetTiny, num_classes=10,
                                 image_size=32, batch_size=4)),
}


@pytest.fixture(scope="module")
def items():
    """{model: (JAX item, port item)} from one example batch each."""
    out = {}
    for name, (jsetup, tsetup) in MODELS.items():
        jloss, jparams, batch, _ = jsetup()
        tloss, _, _, _ = tsetup()
        tparams = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                         jparams))
        out[name] = (JModelItem(loss_fn=jloss, params=jparams,
                                example_batch=batch).prepare(),
                     ModelItem(loss_fn=tloss, params=tparams,
                               example_batch=batch).prepare())
    return out


@pytest.mark.parametrize("model", list(MODELS))
def test_variables_come_in_the_jax_order_under_the_jax_names(items, model):
    """C1: the port lists its variables in the JAX item's order, and each
    carries the JAX name (``convert.jax_name``) as its collective name."""
    jitem, titem = items[model]
    assert [v.collective_name for v in titem.var_infos.values()] == \
        list(jitem.var_infos)
    assert [titem.var_infos[n].collective_name
            for n in titem.trainable_var_names] == jitem.trainable_var_names
    for name, info in titem.var_infos.items():
        assert info.collective_name == jax_name(name, info.shape)


@pytest.mark.parametrize("model", list(MODELS))
def test_sparse_flags_equal_detect_sparse_vars(items, model):
    """C2: the port's traced lookups flag the tables the JAX jaxpr walk
    flags (lm: embed, pos_embed; bert: word, position and token-type
    tables; resnet: none)."""
    jitem, titem = items[model]
    port = {titem.var_infos[n].collective_name
            for n in titem.sparse_var_names}
    assert port == set(jitem.sparse_var_names)
    assert bool(port) == (model != "resnet")


@pytest.mark.parametrize("wire", ["fp32", "int8"])
@pytest.mark.parametrize("chunk", [4, 128])
@pytest.mark.parametrize("model", list(MODELS))
def test_allreduce_plan_matches_jax_variable_by_variable(items, model, chunk,
                                                         wire):
    """Each variable's (group, compressor, wire_dtype) under AllReduce
    equals the JAX plan's, each package on its own item: the groups follow
    the order (C1), the int8 wire skips the tables (C2)."""
    jitem, titem = items[model]
    jplan = JAllReduce(chunk_size=chunk, wire_dtype=wire).build(
        jitem, JSpec.from_dict(TWO))
    tplan = strategy.AllReduce(chunk_size=chunk, wire_dtype=wire).build(
        titem, ResourceSpec.from_dict(TWO))

    def table(plan, rename):
        return [(rename(n.var_name), n.synchronizer.group,
                 n.synchronizer.compressor, n.synchronizer.wire_dtype)
                for n in plan.node_config]
    names = {n: v.collective_name for n, v in titem.var_infos.items()}
    assert table(tplan, names.__getitem__) == table(jplan, lambda n: n)
    if wire == "int8" and model != "resnet":
        assert {n.synchronizer.wire_dtype for n in tplan.node_config
                if titem.var_infos[n.var_name].sparse} == {"fp32"}


def test_trace_counts_lookups_and_sees_a_tied_table():
    """``trace_lookups`` runs no data: it records each lookup's ids count
    and the tables with another use (a tied output head), which the
    lowering keeps off the sparse wire."""
    params = {"emb": torch.randn(50, 8), "w": torch.randn(8, 8),
              "pos": torch.randn(10, 8)}

    def loss_fn(p, b):
        ids = torch.as_tensor(b["ids"]).long()
        h = torch.nn.functional.embedding(ids, p["emb"].float()) @ p["w"]
        h = h + torch.nn.functional.embedding(
            torch.arange(ids.shape[1])[None], p["pos"])
        return (h @ p["emb"].t()).logsumexp(-1).mean()     # tied head
    batch = {"ids": np.zeros((4, 6), np.int32)}
    lookups, dense = trace_lookups(loss_fn, params, batch)
    assert lookups == {"emb": [24], "pos": [6]}
    assert dense == {"emb", "w"}
    assert detect_sparse_vars(loss_fn, params, batch) == {"emb", "pos"}


def test_untraceable_loss_leaves_every_variable_dense():
    def loss_fn(p, b):
        return p["w"].sum() * float(p["w"].sum())   # reads data
    item = ModelItem(loss_fn=loss_fn, params={"w": torch.ones(3)},
                     example_batch={"x": np.ones(2, np.float32)}).prepare()
    assert item.sparse_var_names == []


@pytest.mark.parametrize("shape,name", [
    ((6, 4), "params/d/kernel"), ((8, 3, 3, 3), "params/c/kernel"),
    ((6, 4), "params/e/embedding"), ((5,), "params/n/scale")])
def test_jax_layout_round_trip(shape, name):
    """Bucket wire layout: a port kernel flattens in the flax element
    order (Dense [in, out], Conv HWIO) and comes back as it was."""
    t = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    flat = to_jax_layout(t, name).reshape(-1)
    if name.endswith("kernel") and len(shape) == 2:
        assert torch.equal(flat, t.t().reshape(-1))
    if len(shape) == 4:
        assert torch.equal(flat, t.permute(2, 3, 1, 0).reshape(-1))
    back = from_jax_layout(flat, shape, name)
    assert torch.equal(back, t) and back.is_contiguous()
