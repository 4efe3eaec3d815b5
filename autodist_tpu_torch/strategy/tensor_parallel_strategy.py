"""Tensor-parallel strategy builder.

PyTorch counterpart of ``autodist_tpu/strategy/tensor_parallel_strategy.py``:
the AllReduce plan plus the ``model`` mesh axis. Variables matching the
model's partition rules are stored and consumed sharded
(``VarConfig.mp_axes``; ``parallel/tensor.py`` reduces their partial
products), the rest ride the AllReduce data-parallel path. The plan is
framework-free, so the builder emits the JAX builder's plan, byte for
byte, for the same variable list and spec. ``seq_shards > 1`` adds the
``seq`` axis for TP x SP long-context runs (the model then attends with
ring or Ulysses attention, ``ops/attention.py``).
"""
import re
from typing import Dict, List, Tuple

from autodist_tpu_torch import const
from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce
from autodist_tpu_torch.strategy.base import Strategy, VarConfig
from autodist_tpu_torch.utils import logging

# rule list: (regex searched in the full var name, {dim: mesh axis})
MpRules = List[Tuple[str, Dict[int, str]]]


def apply_mp_rules(strategy: Strategy, rules: MpRules) -> int:
    """Set ``mp_axes`` on every node whose var name matches a rule (the
    first match wins). Returns the number of sharded vars."""
    compiled = [(re.compile(pat), mp) for pat, mp in rules]
    n = 0
    for node in strategy.node_config:
        for pat, mp in compiled:
            if pat.search(node.var_name):
                node.mp_axes = dict(mp)
                n += 1
                break
    return n


def add_frozen_nodes(strategy: Strategy, model_item) -> None:
    """Layout-only nodes for the frozen vars, so mp rules can shard their
    storage too (the sharded compute consumes local shards whether a
    variable trains or not)."""
    have = {n.var_name for n in strategy.node_config}
    for name, info in model_item.var_infos.items():
        if name not in have and not info.trainable:
            strategy.node_config.append(VarConfig(var_name=name))


class TensorParallel(AllReduce):
    """A data x model mesh with Megatron-sharded compute.

    ``mp_rules`` comes from the model family (``models.tp_lm.tp_rules()``);
    unmatched variables stay replicated with AllReduce gradient sync.
    ``seq_shards`` adds sequence parallelism: the mesh is ``{data, seq,
    model}``, outer to inner; ``attention`` is metadata, as in the JAX
    builder."""

    def __init__(self, tp_shards: int, mp_rules: MpRules,
                 seq_shards: int = 1, attention: str = "ring",
                 chunk_size: int = 128, all_reduce_spec: str = "AUTO",
                 compressor: str = "NoneCompressor"):
        super().__init__(chunk_size, all_reduce_spec, compressor)
        if tp_shards < 1 or seq_shards < 1:
            raise ValueError("tp_shards/seq_shards must be >= 1")
        self.tp_shards = tp_shards
        self.seq_shards = seq_shards
        self.mp_rules = list(mp_rules)
        self.attention = attention

    def build(self, model_item, resource_spec) -> Strategy:
        strategy = super().build(model_item, resource_spec)
        n_devices = len(strategy.graph_config.replicas)
        denom = self.tp_shards * self.seq_shards
        if n_devices % denom != 0:
            raise ValueError("%d devices not divisible by tp*sp=%d"
                             % (n_devices, denom))
        # axes outer -> inner: data, seq, model (the innermost axis holds
        # the per-layer reductions)
        mesh_shape = {const.DATA_AXIS: n_devices // denom}
        if self.seq_shards > 1:
            mesh_shape[const.SEQUENCE_AXIS] = self.seq_shards
            strategy.graph_config.seq_axis = const.SEQUENCE_AXIS
        mesh_shape[const.MODEL_AXIS] = self.tp_shards
        strategy.graph_config.mesh_shape = mesh_shape
        add_frozen_nodes(strategy, model_item)
        n = apply_mp_rules(strategy, self.mp_rules)
        logging.info("TensorParallel: %d/%d vars model-sharded over %d-way "
                     "tp (mesh %s)", n, len(strategy.node_config),
                     self.tp_shards, strategy.graph_config.mesh_shape)
        return strategy
