"""Serving: bucketed forward inference and continuous-batching decode."""
from autodist_tpu_torch.serving.engine import (InferenceEngine,  # noqa: F401
                                               ServingConfig,
                                               ServingUnavailable)
