"""AllReduce strategy: dense gradient all-reduce across all replicas.

PyTorch counterpart of ``autodist_tpu/strategy/all_reduce_strategy.py``:
every variable gets an ``AllReduceSynchronizer``; variables are grouped in
index order into buckets of ``chunk_size`` (group id = idx // chunk_size).
The plan is framework-free, so the builder emits the same nodes as the JAX
one for the same variable list and spec. The lowering runs the plan with
one process a replica (``kernel/graph_transformer.py``).
"""
from autodist_tpu_torch.parallel.collectives import wire_quantizable
from autodist_tpu_torch.strategy.base import (AllReduceSynchronizer,
                                              GraphConfig, Strategy,
                                              StrategyBuilder, VarConfig)


def replica_devices(resource_spec):
    return [d.name_string() for d in resource_spec.devices]


class AllReduce(StrategyBuilder):
    def __init__(self, chunk_size: int = 128, all_reduce_spec: str = "AUTO",
                 compressor: str = "NoneCompressor",
                 wire_dtype: str = "fp32", compute_dtype: str = "f32",
                 overlap: bool = False):
        if chunk_size < 1:
            raise ValueError("chunk_size must be >= 1")
        self.chunk_size = chunk_size
        self.all_reduce_spec = all_reduce_spec
        self.compressor = compressor
        self.wire_dtype = wire_dtype
        self.compute_dtype = compute_dtype
        self.overlap = overlap

    def build(self, model_item, resource_spec) -> Strategy:
        nodes = []
        for idx, name in enumerate(model_item.trainable_var_names):
            info = model_item.var_infos.get(name)
            quantizable = wire_quantizable(info, min_block=True)
            nodes.append(VarConfig(
                var_name=name,
                synchronizer=AllReduceSynchronizer(
                    spec=self.all_reduce_spec,
                    compressor=self.compressor,
                    group=idx // self.chunk_size,
                    wire_dtype=(self.wire_dtype if quantizable else "fp32"))))
        return Strategy(node_config=nodes,
                        graph_config=GraphConfig(
                            replicas=replica_devices(resource_spec),
                            compute_dtype=self.compute_dtype,
                            overlap=self.overlap))
