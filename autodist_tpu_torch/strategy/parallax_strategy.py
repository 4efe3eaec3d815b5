"""Parallax: dense variables to AllReduce, sparse ones to load-balanced PS.

A copy of ``autodist_tpu/strategy/parallax_strategy.py`` (reference
``autodist/strategy/parallax_strategy.py:24-71``, after Parallax, arXiv
1808.02621): dense-gradient variables synchronize by all-reduce, and
lookup tables (``VarInfo.sparse``, from ``ModelItem``'s lookup trace) go
to load-balanced parameter servers, where a step moves only the rows it
read.
"""
from autodist_tpu_torch.strategy.base import (AllReduceSynchronizer,
                                              GraphConfig, PSSynchronizer,
                                              Strategy, StrategyBuilder,
                                              VarConfig)
from autodist_tpu_torch.strategy.ps_lb_strategy import (byte_size_load_fn,
                                                        greedy_assign)
from autodist_tpu_torch.strategy.ps_strategy import (reduction_devices,
                                                     replica_devices)


class Parallax(StrategyBuilder):
    def __init__(self, chunk_size: int = 128, all_reduce_spec: str = "AUTO",
                 compressor: str = "NoneCompressor",
                 local_proxy_variable: bool = False, sync: bool = True,
                 staleness: int = 0, require_sparse: bool = False):
        self.chunk_size = chunk_size
        self.all_reduce_spec = all_reduce_spec
        self.compressor = compressor
        self._local_proxy_variable = local_proxy_variable
        self._sync = sync
        self._staleness = staleness
        # the dense/sparse split is the point of Parallax: a user can
        # demand that the sparse wire engages (the lowering then raises
        # on an unrouted lookup instead of syncing it dense)
        self._require_sparse = require_sparse

    def build(self, model_item, resource_spec) -> Strategy:
        infos = [model_item.var_infos[n]
                 for n in model_item.trainable_var_names]
        dense = [i for i in infos if not i.sparse]
        sparse = [i for i in infos if i.sparse]
        destinations = reduction_devices(resource_spec)
        sparse_assignment = greedy_assign(sparse, destinations,
                                          byte_size_load_fn)
        nodes = []
        for idx, info in enumerate(dense):
            nodes.append(VarConfig(
                var_name=info.name,
                synchronizer=AllReduceSynchronizer(
                    spec=self.all_reduce_spec, compressor=self.compressor,
                    group=idx // self.chunk_size)))
        for info in sparse:
            nodes.append(VarConfig(
                var_name=info.name,
                synchronizer=PSSynchronizer(
                    reduction_destination=sparse_assignment[info.name],
                    local_replication=self._local_proxy_variable,
                    sync=self._sync, staleness=self._staleness)))
        return Strategy(node_config=nodes,
                        graph_config=GraphConfig(
                            replicas=replica_devices(resource_spec),
                            require_sparse=self._require_sparse))
