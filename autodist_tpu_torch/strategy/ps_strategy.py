"""PS strategy: every variable synchronized through one parameter server.

A copy of ``autodist_tpu/strategy/ps_strategy.py`` (reference
``autodist/strategy/ps_strategy.py:38-55``): every trainable variable
gets a ``PSSynchronizer`` whose reduction destination is the first node's
host CPU; the replicas are all compute devices (the cards; on card-less
nodes, the CPUs). The plan is framework-free, so the builder emits the
JAX builder's nodes for the same variable list and spec.
"""
from autodist_tpu_torch.strategy.base import (GraphConfig, PSSynchronizer,
                                              Strategy, StrategyBuilder,
                                              VarConfig)


def reduction_devices(resource_spec):
    """One host-CPU reduction device per node (the PS candidates)."""
    return ["%s:CPU:0" % addr for addr in resource_spec.node_addresses]


def replica_devices(resource_spec):
    return [d.name_string() for d in resource_spec.devices]


class PS(StrategyBuilder):
    def __init__(self, local_proxy_variable: bool = False, sync: bool = True,
                 staleness: int = 0, require_sparse: bool = False,
                 wire_dtype: str = "fp32", compute_dtype: str = "f32"):
        self._local_proxy_variable = local_proxy_variable
        self._sync = sync
        self._staleness = staleness
        self._require_sparse = require_sparse
        # "int8": the host<->device PS wire ships blockwise int8 + scales
        # (no-proxy dense float variables only; the others keep fp32)
        self._wire_dtype = wire_dtype
        # "bf16": the managed bf16 compute tier (the f32 master stays on
        # the PS)
        self._compute_dtype = compute_dtype
        if staleness > 0:
            assert sync, "staleness is only meaningful for sync training"

    def build(self, model_item, resource_spec) -> Strategy:
        from autodist_tpu_torch.parallel.collectives import wire_quantizable
        destination = reduction_devices(resource_spec)[0]

        def wire_for(name):
            # dense float, no proxy, at least one scale block
            info = model_item.var_infos.get(name)
            if self._local_proxy_variable or not wire_quantizable(
                    info, min_block=True):
                return "fp32"
            return self._wire_dtype

        nodes = [
            VarConfig(
                var_name=name,
                synchronizer=PSSynchronizer(
                    reduction_destination=destination,
                    local_replication=self._local_proxy_variable,
                    sync=self._sync,
                    staleness=self._staleness,
                    wire_dtype=wire_for(name)))
            for name in model_item.trainable_var_names
        ]
        return Strategy(node_config=nodes,
                        graph_config=GraphConfig(
                            replicas=replica_devices(resource_spec),
                            require_sparse=self._require_sparse,
                            compute_dtype=self._compute_dtype))
