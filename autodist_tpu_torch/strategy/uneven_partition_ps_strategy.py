"""Unevenly partitioned PS.

A copy of ``autodist_tpu/strategy/uneven_partition_ps_strategy.py``
(reference ``autodist/strategy/uneven_partition_ps_strategy.py``): as
PartitionedPS, but the shard count is the first NON-divisor of dim0
(>= 2), so the shards are deliberately uneven (reference ``:128-137``);
the host store keeps them ragged, never padded.
"""
from autodist_tpu_torch.strategy.base import GraphConfig, Strategy, VarConfig
from autodist_tpu_torch.strategy.partitioned_ps_strategy import (
    PartitionedPS, make_partition_str)
from autodist_tpu_torch.strategy.ps_strategy import (reduction_devices,
                                                     replica_devices)


def first_non_divisor_shards(dim0: int, max_shards: int) -> int:
    if dim0 <= 2 or max_shards < 2:
        return 1
    for k in range(2, max_shards + 1):
        if dim0 % k != 0:
            return k
    return 1


def uneven_shard_sizes(dim0: int, num_shards: int):
    """Ceil-split: the first shards get one extra element."""
    base, rem = divmod(dim0, num_shards)
    return [base + (1 if i < rem else 0) for i in range(num_shards)]


class UnevenPartitionedPS(PartitionedPS):
    def build(self, model_item, resource_spec) -> Strategy:
        destinations = reduction_devices(resource_spec)
        n_ps = len(destinations)
        nodes = []
        rr = 0
        for name in model_item.trainable_var_names:
            info = model_item.var_infos[name]
            dim0 = info.shape[0] if info.shape else 0
            num_shards = first_non_divisor_shards(dim0, max(n_ps, 3))
            if num_shards <= 1:
                nodes.append(VarConfig(
                    var_name=name,
                    synchronizer=self._ps(destinations[rr % n_ps])))
                rr += 1
                continue
            part_configs = []
            for shard_idx in range(num_shards):
                part_configs.append(VarConfig(
                    var_name="%s/part_%d" % (name, shard_idx),
                    synchronizer=self._ps(destinations[rr % n_ps])))
                rr += 1
            nodes.append(VarConfig(
                var_name=name,
                partitioner=make_partition_str(len(info.shape), 0,
                                               num_shards),
                part_configs=part_configs,
                shard_sizes=uneven_shard_sizes(dim0, num_shards)))
        return Strategy(node_config=nodes,
                        graph_config=GraphConfig(
                            replicas=replica_devices(resource_spec)))
