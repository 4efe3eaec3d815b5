"""Strategy IR and the builders the port has so far: the AllReduce family
(``AllReduce``, ``PartitionedAR``, ``RandomAxisPartitionAR``,
``ZeroSharded``), the PS family (``PS``, ``PSLoadBalancing``,
``PartitionedPS``, ``UnevenPartitionedPS``, ``Parallax``),
``TensorParallel``, ``PipelineParallel``, ``SequenceParallelAR``,
``ExpertParallel`` and the ``WithRemat`` wrapper."""
from autodist_tpu_torch.strategy.base import (AllReduceSynchronizer,  # noqa: F401
                                              GraphConfig, PSSynchronizer,
                                              Strategy, StrategyBuilder,
                                              StrategyCompiler, VarConfig,
                                              ZeroShardedSynchronizer)
from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce  # noqa: F401
from autodist_tpu_torch.strategy.expert_parallel_strategy import \
    ExpertParallel  # noqa: F401
from autodist_tpu_torch.strategy.parallax_strategy import Parallax  # noqa: F401
from autodist_tpu_torch.strategy.partitioned_all_reduce_strategy import \
    PartitionedAR  # noqa: F401
from autodist_tpu_torch.strategy.partitioned_ps_strategy import \
    PartitionedPS  # noqa: F401
from autodist_tpu_torch.strategy.pipeline_parallel_strategy import \
    PipelineParallel  # noqa: F401
from autodist_tpu_torch.strategy.ps_lb_strategy import \
    PSLoadBalancing  # noqa: F401
from autodist_tpu_torch.strategy.ps_strategy import PS  # noqa: F401
from autodist_tpu_torch.strategy.random_axis_partition_all_reduce_strategy \
    import RandomAxisPartitionAR  # noqa: F401
from autodist_tpu_torch.strategy.remat import WithRemat  # noqa: F401
from autodist_tpu_torch.strategy.sequence_parallel_strategy import \
    SequenceParallelAR  # noqa: F401
from autodist_tpu_torch.strategy.tensor_parallel_strategy import \
    TensorParallel  # noqa: F401
from autodist_tpu_torch.strategy.uneven_partition_ps_strategy import \
    UnevenPartitionedPS  # noqa: F401
from autodist_tpu_torch.strategy.zero_sharded_strategy import (  # noqa: F401
    ZeroSharded, zero_shardable, zero_wire_quantizable)
