"""Serving: bucketed forward inference, the micro-batcher in front of it,
continuous-batching decode and the load-adaptive fleet autoscaler (the
JAX package's ``serving`` exports). At N > 1 ranks each engine is one
controller and N - 1 executors (``serving/plane.py``)."""
from autodist_tpu_torch.serving.engine import (InferenceEngine,  # noqa: F401
                                               ServingConfig,
                                               ServingUnavailable)
from autodist_tpu_torch.serving.batcher import (MicroBatcher,  # noqa: F401
                                                active_batchers)
from autodist_tpu_torch.serving.decode import (DecodeConfig,  # noqa: F401
                                               DecodeEngine, DecodeSetup,
                                               SlotScheduler,
                                               active_decoders)
from autodist_tpu_torch.serving.autoscale import (  # noqa: F401
    AutoscalePolicy, AutoscaleSignals, FleetAutoscaler)

__all__ = ["InferenceEngine", "MicroBatcher", "ServingConfig",
           "ServingUnavailable", "active_batchers", "AutoscalePolicy",
           "AutoscaleSignals", "FleetAutoscaler", "DecodeConfig",
           "DecodeEngine", "DecodeSetup", "SlotScheduler",
           "active_decoders"]
