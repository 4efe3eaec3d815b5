"""Span tracing and the counter/gauge/histogram registry (a copy of the
JAX package's ``telemetry/spans.py``)."""
