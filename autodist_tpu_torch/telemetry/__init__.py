"""Span tracing and the counter/gauge/histogram registry (a copy of the
JAX package's ``telemetry/spans.py``), the flight recorder
(``blackbox.py``) and the online straggler detector (``goodput.py``)."""
from autodist_tpu_torch.telemetry.blackbox import (  # noqa: F401
    FlightRecorder, get_flight_recorder)
from autodist_tpu_torch.telemetry.goodput import StragglerEwma  # noqa: F401

__all__ = ["FlightRecorder", "get_flight_recorder", "StragglerEwma"]
