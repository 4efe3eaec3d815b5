"""Lowering of a compiled strategy to the programs a Runner executes."""
