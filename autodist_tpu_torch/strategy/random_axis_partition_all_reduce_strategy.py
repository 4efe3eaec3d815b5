"""Partitioned AllReduce along a randomly-chosen axis.

PyTorch counterpart of
``autodist_tpu/strategy/random_axis_partition_all_reduce_strategy.py``:
like PartitionedAR, but the split axis is chosen at random among the
partitionable axes (seeded with Python's ``random``, so the ranks — and
the JAX builder, for the same variable list — pick the same axes); sparse
(embedding) variables are forced to axis 0.
"""
import random

from autodist_tpu_torch.strategy.all_reduce_strategy import replica_devices
from autodist_tpu_torch.strategy.base import (AllReduceSynchronizer,
                                              GraphConfig, Strategy,
                                              VarConfig)
from autodist_tpu_torch.strategy.partitioned_all_reduce_strategy import \
    PartitionedAR
from autodist_tpu_torch.strategy.partitioned_ps_strategy import (
    make_partition_str, smallest_divisor_shards)


class RandomAxisPartitionAR(PartitionedAR):
    def __init__(self, chunk_size: int = 128, all_reduce_spec: str = "AUTO",
                 compressor: str = "NoneCompressor", max_shards: int = 0,
                 seed: int = 0):
        super().__init__(chunk_size, all_reduce_spec, compressor, max_shards)
        self.seed = seed

    def build(self, model_item, resource_spec) -> Strategy:
        rng = random.Random(self.seed)
        n_replicas = max(len(resource_spec.devices), 2)
        max_shards = self.max_shards or n_replicas
        nodes = []
        group_counter = 0
        for name in model_item.trainable_var_names:
            info = model_item.var_infos[name]
            # candidate axes with a usable divisor, of the JAX item's
            # shape (flax's axes)
            shape = info.flax_shape
            candidates = []
            for ax, dim in enumerate(shape):
                if smallest_divisor_shards(dim, max_shards) > 1:
                    candidates.append(ax)
            if info.sparse:
                candidates = [0] if 0 in candidates else []
            group = group_counter // max(self.chunk_size, 1)
            if not candidates:
                nodes.append(VarConfig(
                    var_name=name,
                    synchronizer=AllReduceSynchronizer(
                        spec=self.all_reduce_spec, compressor=self.compressor,
                        group=group)))
                group_counter += 1
                continue
            axis = rng.choice(candidates)
            num_shards = smallest_divisor_shards(shape[axis], max_shards)
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
                partitioner=make_partition_str(len(shape), axis,
                                               num_shards),
                part_configs=part_configs))
        return Strategy(node_config=nodes,
                        graph_config=GraphConfig(
                            replicas=replica_devices(resource_spec)))
