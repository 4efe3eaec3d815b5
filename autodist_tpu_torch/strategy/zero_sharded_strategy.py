"""ZeroSharded strategy: replicated params, cross-replica sharded update.

PyTorch counterpart of ``autodist_tpu/strategy/zero_sharded_strategy.py``:
the ZeRO stage-1 weight update (arXiv 2004.13336) as a zoo builder. Every
eligible dense variable gets a :class:`ZeroShardedSynchronizer`: the
lowering reduce-scatters its gradient over the replicas, applies the
optimizer to each replica's owned 1/P flat shard only (the optimizer
state is created sharded, never materialized whole), and all-gathers the
update back onto the replicated params
(``kernel/synchronization/zero_synchronizer.py``).

Ineligible variables fall back to plain AllReduce:

- sparse (lookup-indexed) variables: the reduce-scatter would densify
  their batch-row-sized gradient to the full table (ADT312);
- variables smaller than one per-replica shard (ADT313).

``wire_dtype="int8"`` quantizes both wire crossings through the
blockwise codec (dense float variables of at least one scale block per
shard; the rest stay fp32). The plan is framework-free: for the same
variable list and spec it is the JAX builder's, byte for byte.
"""
from autodist_tpu_torch.strategy.all_reduce_strategy import replica_devices
from autodist_tpu_torch.strategy.base import (AllReduceSynchronizer,
                                              GraphConfig, Strategy,
                                              StrategyBuilder, VarConfig,
                                              ZeroShardedSynchronizer)


def zero_shardable(info, num_replicas: int) -> bool:
    """The ONE eligibility gate for ZeroSharded sync: dense variables
    with at least one element per replica shard."""
    if info is None or getattr(info, "sparse", False):
        return False
    if getattr(info, "num_elements", 0) < max(int(num_replicas), 1):
        return False
    return True


def zero_wire_quantizable(info, num_replicas: int) -> bool:
    """int8 eligibility for the ZeRO rs/ag wire: dense float AND at
    least one scale block PER SHARD — the kernel rounds each replica's
    shard up to whole blocks, so a variable below ``P x block`` elements
    would ship MORE padded int8 bytes than the fp32 wire."""
    from autodist_tpu_torch.parallel.collectives import (wire_block_size,
                                                         wire_quantizable)
    if not wire_quantizable(info):
        return False
    return (getattr(info, "num_elements", 0)
            >= max(int(num_replicas), 1) * wire_block_size())


class ZeroSharded(StrategyBuilder):
    def __init__(self, chunk_size: int = 128, wire_dtype: str = "fp32",
                 compute_dtype: str = "f32", overlap: bool = False):
        if chunk_size < 1:
            raise ValueError("chunk_size must be >= 1")
        # overlap: the per-unit sync schedule (reverse layer order) — the
        # per-var reduce-scatters launch as their gradients become ready
        self.overlap = overlap
        # chunk_size buckets the AllReduce FALLBACK vars (small/sparse)
        self.chunk_size = chunk_size
        # "int8": blockwise-quantized rs + update all-gather wire
        self.wire_dtype = wire_dtype
        # "bf16": managed bf16 compute beside the f32 sharded master
        self.compute_dtype = compute_dtype

    def build(self, model_item, resource_spec) -> Strategy:
        n_replicas = max(len(resource_spec.devices), 1)
        nodes = []
        for idx, name in enumerate(model_item.trainable_var_names):
            info = model_item.var_infos.get(name)
            if zero_shardable(info, n_replicas):
                quantizable = zero_wire_quantizable(info, n_replicas)
                nodes.append(VarConfig(
                    var_name=name,
                    synchronizer=ZeroShardedSynchronizer(
                        wire_dtype=(self.wire_dtype if quantizable
                                    else "fp32"))))
            else:
                nodes.append(VarConfig(
                    var_name=name,
                    synchronizer=AllReduceSynchronizer(
                        group=idx // self.chunk_size)))
        return Strategy(node_config=nodes,
                        graph_config=GraphConfig(
                            replicas=replica_devices(resource_spec),
                            compute_dtype=self.compute_dtype,
                            overlap=self.overlap))
