"""Gradient synchronizer kernels: the all-reduce family and its compressors."""
