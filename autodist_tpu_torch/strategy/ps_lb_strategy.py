"""PS with greedy load balancing by variable byte size.

A copy of ``autodist_tpu/strategy/ps_lb_strategy.py`` (reference
``autodist/strategy/ps_lb_strategy.py:63-117``): variables are assigned
to parameter servers greedily, largest first onto the least-loaded
server. This is the reference's default builder (``autodist/autodist.py:70``)
and ``AutoDist``'s.
"""
import heapq

from autodist_tpu_torch.strategy.base import (GraphConfig, PSSynchronizer,
                                              Strategy, StrategyBuilder,
                                              VarConfig)
from autodist_tpu_torch.strategy.ps_strategy import (reduction_devices,
                                                     replica_devices)


def byte_size_load_fn(var_info) -> float:
    """Estimated PS load of one variable, in bytes. A sparse (lookup)
    table is read row-wise, so its load is discounted to one row's bytes
    times a nominal 128-row batch, capped by its full size."""
    size = float(var_info.byte_size)
    if var_info.sparse and var_info.shape:
        rows = max(int(var_info.shape[0]), 1)
        size = min(size, size / rows * 128.0)
    return max(size, 1.0)


def greedy_assign(var_infos, destinations, load_fn=byte_size_load_fn):
    """Greedy bin packing: by load, largest first, onto the least-loaded
    PS."""
    heap = [(0.0, i, dest) for i, dest in enumerate(destinations)]
    heapq.heapify(heap)
    assignment = {}
    for info in sorted(var_infos, key=lambda v: -load_fn(v)):
        load, i, dest = heapq.heappop(heap)
        assignment[info.name] = dest
        heapq.heappush(heap, (load + load_fn(info), i, dest))
    return assignment


class PSLoadBalancing(StrategyBuilder):
    def __init__(self, local_proxy_variable: bool = False, sync: bool = True,
                 staleness: int = 0):
        self._local_proxy_variable = local_proxy_variable
        self._sync = sync
        self._staleness = staleness
        if staleness > 0:
            assert sync, "staleness is only meaningful for sync training"

    def build(self, model_item, resource_spec) -> Strategy:
        destinations = reduction_devices(resource_spec)
        infos = [model_item.var_infos[n]
                 for n in model_item.trainable_var_names]
        assignment = greedy_assign(infos, destinations)
        nodes = [
            VarConfig(
                var_name=info.name,
                synchronizer=PSSynchronizer(
                    reduction_destination=assignment[info.name],
                    local_replication=self._local_proxy_variable,
                    sync=self._sync,
                    staleness=self._staleness))
            for info in infos
        ]
        return Strategy(node_config=nodes,
                        graph_config=GraphConfig(
                            replicas=replica_devices(resource_spec)))
