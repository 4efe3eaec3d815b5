"""Strategy IR and the builders the port has so far (``AllReduce``)."""
from autodist_tpu_torch.strategy.base import (AllReduceSynchronizer,  # noqa: F401
                                              GraphConfig, PSSynchronizer,
                                              Strategy, StrategyBuilder,
                                              StrategyCompiler, VarConfig)
from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce  # noqa: F401
