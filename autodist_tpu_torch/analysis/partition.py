"""Partitioner-string parsing — the single implementation.

A ``VarConfig.partitioner`` is a comma-joined per-axis shard-count string
like ``"4,1"`` (reference ``kernel/partitioner.py:38-150``
PartitionerConfig). Both the compile path (``strategy/base.py``
``VarConfig.partition_axis``/``num_shards``) and the linter
(``analysis/rules.py`` ADT2xx) parse through here, so a malformed string
produces the same ``ADT201`` diagnostic everywhere instead of a raw
``int()`` traceback.

This module is a dependency-free leaf (it imports only the diagnostics
types) so ``strategy/base.py`` can import it without cycles.
"""
from typing import List, Optional

from autodist_tpu_torch.analysis.diagnostics import DiagnosticError, error


def parse_partitioner(partitioner: str, var_name: str = "") -> List[int]:
    """Parse ``"4,1"`` into ``[4, 1]``.

    Raises :class:`DiagnosticError` (code ``ADT201``, a ``ValueError``)
    on malformed input: empty/dangling segments (``"4,"``), non-integer
    counts (``"a,1"``), or counts < 1 (``"0,1"``).
    """
    fixit = ('use a comma-joined list of per-axis shard counts >= 1, '
             'e.g. "4,1" for 4 shards along axis 0')
    tokens = str(partitioner).split(",")
    counts = []
    for tok in tokens:
        tok = tok.strip()
        if not tok:
            raise DiagnosticError(error(
                "ADT201",
                "malformed partitioner %r: empty shard count segment"
                % (partitioner,), var=var_name, fixit=fixit))
        try:
            c = int(tok)
        except ValueError:
            raise DiagnosticError(error(
                "ADT201",
                "malformed partitioner %r: %r is not an integer"
                % (partitioner, tok), var=var_name, fixit=fixit))
        if c < 1:
            raise DiagnosticError(error(
                "ADT201",
                "malformed partitioner %r: shard count %d < 1"
                % (partitioner, c), var=var_name, fixit=fixit))
        counts.append(c)
    return counts


def partition_axis_of(counts: List[int]) -> Optional[int]:
    """First axis with more than one shard (None when unpartitioned)."""
    for ax, c in enumerate(counts):
        if c > 1:
            return ax
    return None


def num_shards_of(counts: List[int]) -> int:
    n = 1
    for c in counts:
        n *= c
    return n


def split_axes_of(counts: List[int]) -> List[int]:
    """Every axis with more than one shard (the lowering supports one)."""
    return [ax for ax, c in enumerate(counts) if c > 1]
