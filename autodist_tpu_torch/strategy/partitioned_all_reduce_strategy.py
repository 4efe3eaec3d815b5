"""Partitioned AllReduce: split each variable, then all-reduce each shard.

PyTorch counterpart of
``autodist_tpu/strategy/partitioned_all_reduce_strategy.py``: each
partitionable variable is split along axis 0 (smallest divisor >1, capped
by the replica count) and every shard gets its own AllReduceSynchronizer.
The lowering (``kernel/graph_transformer.py``, ``kernel/partitioner.py``)
stores each rank's padded shard, all-gathers the full value before the
loss, reduce-scatters the gradient and applies the optimizer to the
shard. The plan is framework-free: for the same variable list and spec
it is the JAX builder's, byte for byte.
"""
from autodist_tpu_torch.strategy.all_reduce_strategy import replica_devices
from autodist_tpu_torch.strategy.base import (AllReduceSynchronizer,
                                              GraphConfig, Strategy,
                                              StrategyBuilder, VarConfig)
from autodist_tpu_torch.strategy.partitioned_ps_strategy import (
    make_partition_str, smallest_divisor_shards)


class PartitionedAR(StrategyBuilder):
    def __init__(self, chunk_size: int = 128, all_reduce_spec: str = "AUTO",
                 compressor: str = "NoneCompressor", max_shards: int = 0):
        self.chunk_size = chunk_size
        self.all_reduce_spec = all_reduce_spec
        self.compressor = compressor
        self.max_shards = max_shards

    def build(self, model_item, resource_spec) -> Strategy:
        n_replicas = max(len(resource_spec.devices), 2)
        max_shards = self.max_shards or n_replicas
        nodes = []
        group_counter = 0
        for name in model_item.trainable_var_names:
            info = model_item.var_infos[name]
            # the JAX item's shape: shards split flax's axis 0
            shape = info.flax_shape
            dim0 = shape[0] if shape else 0
            num_shards = smallest_divisor_shards(dim0, max_shards)
            group = group_counter // max(self.chunk_size, 1)
            if num_shards <= 1:
                nodes.append(VarConfig(
                    var_name=name,
                    synchronizer=AllReduceSynchronizer(
                        spec=self.all_reduce_spec, compressor=self.compressor,
                        group=group)))
                group_counter += 1
                continue
            part_configs = []
            for shard_idx in range(num_shards):
                part_configs.append(VarConfig(
                    var_name="%s/part_%d" % (name, shard_idx),
                    synchronizer=AllReduceSynchronizer(
                        spec=self.all_reduce_spec, compressor=self.compressor,
                        group=group)))
                group_counter += 1
            nodes.append(VarConfig(
                var_name=name,
                partitioner=make_partition_str(len(shape), 0, num_shards),
                part_configs=part_configs))
        return Strategy(node_config=nodes,
                        graph_config=GraphConfig(
                            replicas=replica_devices(resource_spec)))
