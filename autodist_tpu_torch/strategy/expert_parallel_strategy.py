"""Expert-parallel (MoE) strategy builder.

PyTorch counterpart of
``autodist_tpu/strategy/expert_parallel_strategy.py``: the AllReduce plan
plus the ``expert`` mesh axis. Expert-stacked variables matching the
model's rules shard their stack dim over it and tokens route by
all-to-all (``parallel/expert.py``); the batch dim shards over data and
expert jointly (``GraphConfig.batch_axes``), so every rank holds
distinct tokens and the expert axis doubles as data parallelism for the
dense layers (GShard, arXiv 2006.16668). The plan is framework-free, so
the builder emits the JAX builder's plan, byte for byte.
"""
from autodist_tpu_torch import const
from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce
from autodist_tpu_torch.strategy.base import Strategy
from autodist_tpu_torch.strategy.tensor_parallel_strategy import (
    MpRules, add_frozen_nodes, apply_mp_rules)
from autodist_tpu_torch.utils import logging


class ExpertParallel(AllReduce):
    """A ``{data, expert}`` mesh with all-to-all token routing;
    ``mp_rules`` from the model family (``models.moe_lm.ep_rules()``)."""

    def __init__(self, ep_shards: int, mp_rules: MpRules,
                 chunk_size: int = 128, all_reduce_spec: str = "AUTO",
                 compressor: str = "NoneCompressor"):
        super().__init__(chunk_size, all_reduce_spec, compressor)
        if ep_shards < 1:
            raise ValueError("ep_shards must be >= 1")
        self.ep_shards = ep_shards
        self.mp_rules = list(mp_rules)

    def build(self, model_item, resource_spec) -> Strategy:
        strategy = super().build(model_item, resource_spec)
        n_devices = len(strategy.graph_config.replicas)
        if n_devices % self.ep_shards != 0:
            raise ValueError("%d devices not divisible by ep_shards=%d"
                             % (n_devices, self.ep_shards))
        mesh_shape = {const.DATA_AXIS: n_devices // self.ep_shards,
                      const.EXPERT_AXIS: self.ep_shards}
        strategy.graph_config.mesh_shape = mesh_shape
        strategy.graph_config.batch_axes = [const.DATA_AXIS,
                                            const.EXPERT_AXIS]
        add_frozen_nodes(strategy, model_item)
        n = apply_mp_rules(strategy, self.mp_rules)
        logging.info("ExpertParallel: %d/%d vars expert-sharded, mesh %s",
                     n, len(strategy.node_config), mesh_shape)
        return strategy
