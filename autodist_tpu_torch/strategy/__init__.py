"""Strategy IR and the builders the port has so far: ``AllReduce``,
``PartitionedAR``, ``RandomAxisPartitionAR``, ``ZeroSharded`` and the
``WithRemat`` wrapper."""
from autodist_tpu_torch.strategy.base import (AllReduceSynchronizer,  # noqa: F401
                                              GraphConfig, PSSynchronizer,
                                              Strategy, StrategyBuilder,
                                              StrategyCompiler, VarConfig,
                                              ZeroShardedSynchronizer)
from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce  # noqa: F401
from autodist_tpu_torch.strategy.partitioned_all_reduce_strategy import \
    PartitionedAR  # noqa: F401
from autodist_tpu_torch.strategy.random_axis_partition_all_reduce_strategy \
    import RandomAxisPartitionAR  # noqa: F401
from autodist_tpu_torch.strategy.remat import WithRemat  # noqa: F401
from autodist_tpu_torch.strategy.zero_sharded_strategy import (  # noqa: F401
    ZeroSharded, zero_shardable, zero_wire_quantizable)
