"""Attention ops: the reference paths and the flash-attention kernel."""
