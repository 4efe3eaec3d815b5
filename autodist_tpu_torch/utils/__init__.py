"""Logging and the kernel build helper."""
