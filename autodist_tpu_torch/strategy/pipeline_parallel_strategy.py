"""Pipeline-parallel strategy builder.

PyTorch counterpart of ``autodist_tpu/strategy/pipeline_parallel_strategy.py``:
the AllReduce plan plus the ``pipe`` mesh axis. Layer-stacked variables
matching the model's rules shard their stack dim over it
(``VarConfig.mp_axes``) and the model streams microbatches through the
stages (``parallel/pipeline.py``); ``tp_shards`` adds the ``model`` axis
innermost. The plan is framework-free, so the builder emits the JAX
builder's plan, byte for byte, for the same variable list and spec.
"""
from autodist_tpu_torch import const
from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce
from autodist_tpu_torch.strategy.base import Strategy
from autodist_tpu_torch.strategy.tensor_parallel_strategy import (
    MpRules, add_frozen_nodes, apply_mp_rules)
from autodist_tpu_torch.utils import logging


class PipelineParallel(AllReduce):
    """A pipe x data (x model) mesh with microbatch pipelining.

    ``mp_rules`` comes from the model family
    (``models.pipe_lm.pp_rules(model_axis=...)``); ``n_microbatches``,
    ``schedule`` and ``virtual_stages`` are recorded in the plan
    (``graph_config.pp_*``): the model's loss must be built with the same
    values (``AutoDist.build``'s ``mp_meta`` guard checks them)."""

    def __init__(self, pp_shards: int, mp_rules: MpRules,
                 n_microbatches: int = 4, tp_shards: int = 1,
                 chunk_size: int = 128, all_reduce_spec: str = "AUTO",
                 compressor: str = "NoneCompressor",
                 schedule: str = "gpipe", virtual_stages: int = 2):
        super().__init__(chunk_size, all_reduce_spec, compressor)
        if pp_shards < 1 or tp_shards < 1:
            raise ValueError("pp_shards/tp_shards must be >= 1")
        if n_microbatches < 1:
            raise ValueError("n_microbatches must be >= 1")
        if schedule not in ("gpipe", "1f1b", "interleaved"):
            raise ValueError(
                "schedule must be 'gpipe', '1f1b' or 'interleaved'")
        if schedule == "interleaved":
            if virtual_stages < 2:
                raise ValueError("interleaved schedule needs "
                                 "virtual_stages >= 2")
            if n_microbatches % pp_shards:
                raise ValueError(
                    "interleaved schedule needs n_microbatches (%d) "
                    "divisible by pp_shards (%d)"
                    % (n_microbatches, pp_shards))
        self.pp_shards = pp_shards
        self.tp_shards = tp_shards
        self.n_microbatches = n_microbatches
        self.schedule = schedule
        self.virtual_stages = virtual_stages if schedule == "interleaved" \
            else None
        self.mp_rules = list(mp_rules)

    def build(self, model_item, resource_spec) -> Strategy:
        strategy = super().build(model_item, resource_spec)
        n_devices = len(strategy.graph_config.replicas)
        denom = self.pp_shards * self.tp_shards
        if n_devices % denom != 0:
            raise ValueError("%d devices not divisible by pp*tp=%d"
                             % (n_devices, denom))
        # outer -> inner: pipe (rank-to-rank moves), data, model (the
        # per-layer reductions)
        mesh_shape = {const.PIPELINE_AXIS: self.pp_shards,
                      const.DATA_AXIS: n_devices // denom}
        if self.tp_shards > 1:
            mesh_shape[const.MODEL_AXIS] = self.tp_shards
        gc = strategy.graph_config
        gc.mesh_shape = mesh_shape
        gc.pp_microbatches = self.n_microbatches
        gc.pp_schedule = self.schedule
        gc.pp_virtual = self.virtual_stages
        add_frozen_nodes(strategy, model_item)
        n = apply_mp_rules(strategy, self.mp_rules)
        logging.info("PipelineParallel: %d/%d vars pipe-sharded, mesh %s, "
                     "%d microbatches, %s schedule", n,
                     len(strategy.node_config), mesh_shape,
                     self.n_microbatches, self.schedule)
        return strategy
