"""The zoo models of the plan-layer parity tests (``test_torch_plan_verify``,
``test_torch_simulator``, ``test_torch_search``), built in both packages
at tiny sizes from the same configs:

- the JAX package's ``ModelItem`` (its loss traced, optax Adam attached);
- the port's ``ModelItem`` of the port model (its one fake-tensor trace,
  a torch Adam factory attached);
- :class:`JaxListItem`: the port's view of the JAX item's variables —
  the JAX names, flax's shapes, dtypes, table and trainable flags — with
  the port's optimizer spec and the port model's trace costs. Builders,
  rules, the cost model and the search given "the JAX inputs" read this
  one, so the two packages price the same variable list.
"""
import functools

import torch

MODELS = ("lm", "bert", "dlrm", "ncf", "tp_lm", "pipe_lm", "moe_lm")
MP_MODELS = ("tp_lm", "pipe_lm", "moe_lm")
LR = 1e-3


def _setups(model):
    """(JAX setup, port setup, mp_rules of each, mp_meta)."""
    from autodist_tpu.models import bert as jbert
    from autodist_tpu.models import dlrm as jdlrm
    from autodist_tpu.models import lm as jlm
    from autodist_tpu.models import moe_lm as jmoe
    from autodist_tpu.models import ncf as jncf
    from autodist_tpu.models import pipe_lm as jpipe
    from autodist_tpu.models import tp_lm as jtp
    from autodist_tpu_torch.models import bert, dlrm, lm, moe_lm, ncf
    from autodist_tpu_torch.models import pipe_lm, tp_lm
    if model == "lm":
        return (jlm.make_train_setup(jlm.LMConfig.tiny(), seq_len=16,
                                     batch_size=8),
                lm.make_train_setup(lm.LMConfig.tiny(), seq_len=16,
                                    batch_size=8), None, None, None)
    if model == "bert":
        return (jbert.make_train_setup(jbert.BertConfig.tiny(), seq_len=16,
                                       batch_size=8),
                bert.make_train_setup(bert.BertConfig.tiny(), seq_len=16,
                                      batch_size=8), None, None, None)
    if model == "dlrm":
        return (jdlrm.make_train_setup(jdlrm.DLRMConfig.tiny(),
                                       batch_size=8),
                dlrm.make_train_setup(dlrm.DLRMConfig.tiny(), batch_size=8),
                None, None, None)
    if model == "ncf":
        return (jncf.make_train_setup(jncf.NCFConfig.tiny(), batch_size=8),
                ncf.make_train_setup(ncf.NCFConfig.tiny(), batch_size=8),
                None, None, None)
    if model == "tp_lm":
        return (jtp.make_train_setup(jtp.TPLMConfig.tiny(), seq_len=16,
                                     batch_size=8),
                tp_lm.make_train_setup(tp_lm.TPLMConfig.tiny(), seq_len=16,
                                       batch_size=8),
                jtp.tp_rules(), tp_lm.tp_rules(), None)
    if model == "pipe_lm":
        meta = {"pp_microbatches": 2, "pp_schedule": "gpipe"}
        return (jpipe.make_train_setup(jtp.TPLMConfig.tiny(num_layers=4),
                                       seq_len=16, batch_size=8,
                                       n_microbatches=2),
                pipe_lm.make_train_setup(
                    tp_lm.TPLMConfig.tiny(num_layers=4), seq_len=16,
                    batch_size=8, n_microbatches=2),
                jpipe.pp_rules(), pipe_lm.pp_rules(), meta)
    if model == "moe_lm":
        return (jmoe.make_train_setup(jmoe.MoEConfig.tiny(), seq_len=16,
                                      batch_size=8),
                moe_lm.make_train_setup(moe_lm.MoEConfig.tiny(), seq_len=16,
                                        batch_size=8),
                jmoe.ep_rules(), moe_lm.ep_rules(), None)
    raise KeyError(model)


class JaxListItem:
    """The port's item over the JAX item's variable list (see the module
    docstring): what a builder, the rules and the cost model read."""

    def __init__(self, jitem, titem):
        from autodist_tpu_torch.model_item import VarInfo
        self.var_infos = {
            v.name: VarInfo(v.name, tuple(v.shape), str(v.dtype),
                            trainable=v.trainable, sparse=v.sparse)
            for v in jitem.var_infos.values()}
        self.optimizer_spec = titem.optimizer_spec
        self.trace_costs = titem.trace_costs
        self.example_batch = titem.example_batch
        self.mp_rules = jitem.mp_rules
        self.mp_meta = jitem.mp_meta

    @property
    def trainable_var_names(self):
        return [n for n, v in self.var_infos.items() if v.trainable]

    def total_bytes(self):
        return sum(v.byte_size for v in self.var_infos.values())


@functools.lru_cache(maxsize=None)
def items(model):
    """``(jax item, port item, port list item over the JAX variables)``
    of one zoo model, each with Adam at ``LR``."""
    import jax
    import optax
    from autodist_tpu.model_item import ModelItem as JModelItem
    from autodist_tpu_torch.model_item import ModelItem
    jsetup, tsetup, jrules, trules, meta = _setups(model)
    jl, jp, jb = jsetup[:3]
    tl, tp, tb = tsetup[:3]
    jitem = JModelItem(loss_fn=jl, optimizer=optax.adam(LR), params=jp,
                       example_batch=jb, mp_rules=jrules,
                       mp_meta=meta).prepare()
    jax.block_until_ready(jitem.opt_state_spec)
    titem = ModelItem(loss_fn=tl, optimizer=functools.partial(
        torch.optim.Adam, lr=LR), params=tp, example_batch=tb,
        mp_rules=trules, mp_meta=meta).prepare()
    return jitem, titem, JaxListItem(jitem, titem)


def specs(kind="one"):
    """(JAX spec, port spec) of the same cluster: ``one`` node of 4
    devices (CPUs, so that the plans name the same devices in both
    packages), or ``two`` hosts of 2 under a two-level topology (a fast
    intra-host level, a slow inter-host one)."""
    from autodist_tpu.resource_spec import ResourceSpec as JSpec
    from autodist_tpu.resource_spec import Topology as JTopology
    from autodist_tpu_torch.resource_spec import ResourceSpec, Topology
    if kind == "one":
        one = {"nodes": [{"address": "127.0.0.1", "chief": True,
                          "cpus": [0, 1, 2, 3]}]}
        return JSpec.from_dict(one), ResourceSpec.from_dict(one)
    topo = {"hosts": 2, "chips_per_host": 2,
            "levels": [{"name": "ici", "bandwidth_gbps": 400},
                       {"name": "dcn", "bandwidth_gbps": 25}]}
    two = {"nodes": [{"address": "10.0.0.1", "chief": True, "cpus": [0, 1]},
                     {"address": "10.0.0.2", "cpus": [0, 1]}]}
    jspec, tspec = JSpec.from_dict(two), ResourceSpec.from_dict(two)
    return (jspec.set_topology(JTopology.from_dict(topo)),
            tspec.set_topology(Topology.from_dict(topo)))


def port_name_map(titem):
    """The port item's variable names -> the JAX names."""
    return {n: v.collective_name for n, v in titem.var_infos.items()}


def one_thread():
    """Tiny shapes gain nothing from intra-op threads; one thread keeps
    these tests from contending with the suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    return n


