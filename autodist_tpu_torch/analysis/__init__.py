"""Diagnostics and the plan rules the port's slice runs (copies of the
JAX package's framework-free analysis modules)."""
