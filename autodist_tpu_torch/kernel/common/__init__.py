"""Helpers shared by the kernels."""
