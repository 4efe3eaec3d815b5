"""Partitioned PS: each variable sharded across the parameter servers.

A copy of ``autodist_tpu/strategy/partitioned_ps_strategy.py`` (reference
``autodist/strategy/partitioned_ps_strategy.py:104-136``): each
partitionable variable is split along axis 0 into ``num_shards`` equal
shards (the smallest divisor of dim0 above 1, capped by the number of
reduction devices), the shards are round-robined over the PSes, and the
node carries a ``partitioner`` string and one config a shard. Scalars
and unsplittable variables take a plain PS assignment. The partitioned
AllReduce builders share the shard-count helpers.
"""
from autodist_tpu_torch.strategy.base import (GraphConfig, PSSynchronizer,
                                              Strategy, StrategyBuilder,
                                              VarConfig)
from autodist_tpu_torch.strategy.ps_strategy import (reduction_devices,
                                                     replica_devices)


def smallest_divisor_shards(dim0: int, max_shards: int) -> int:
    """Smallest divisor of dim0 in (1, max_shards]; 1 when none exists."""
    if dim0 <= 1 or max_shards <= 1:
        return 1
    best = 1
    for k in range(2, max_shards + 1):
        if dim0 % k == 0:
            return k
    return best


def largest_divisor_shards(dim0: int, max_shards: int) -> int:
    """Largest divisor of dim0 that is <= max_shards (>= 1)."""
    for k in range(min(dim0, max_shards), 0, -1):
        if dim0 % k == 0:
            return k
    return 1


def make_partition_str(rank: int, axis: int, num_shards: int) -> str:
    counts = ["1"] * max(rank, 1)
    counts[axis] = str(num_shards)
    return ",".join(counts)


class PartitionedPS(StrategyBuilder):
    def __init__(self, local_proxy_variable: bool = False, sync: bool = True,
                 staleness: int = 0, num_shards: int = 0,
                 require_sparse: bool = False):
        self._local_proxy_variable = local_proxy_variable
        self._sync = sync
        self._staleness = staleness
        self._num_shards_override = num_shards
        self._require_sparse = require_sparse

    def _num_shards(self, dim0: int, n_ps: int) -> int:
        if self._num_shards_override:
            return largest_divisor_shards(dim0, self._num_shards_override)
        return smallest_divisor_shards(dim0, max(n_ps, 2))

    def _ps(self, destination) -> PSSynchronizer:
        return PSSynchronizer(reduction_destination=destination,
                              local_replication=self._local_proxy_variable,
                              sync=self._sync, staleness=self._staleness)

    def build(self, model_item, resource_spec) -> Strategy:
        destinations = reduction_devices(resource_spec)
        n_ps = len(destinations)
        nodes = []
        rr = 0  # round-robin pointer across all shards
        for name in model_item.trainable_var_names:
            info = model_item.var_infos[name]
            dim0 = info.shape[0] if info.shape else 0
            num_shards = self._num_shards(dim0, n_ps) if dim0 > 1 else 1
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
                part_configs=part_configs))
        return Strategy(node_config=nodes,
                        graph_config=GraphConfig(
                            replicas=replica_devices(resource_spec),
                            require_sparse=self._require_sparse))
