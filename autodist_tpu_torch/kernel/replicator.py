"""Replicator — data-parallel replication bookkeeping.

PyTorch counterpart of ``autodist_tpu/kernel/replicator.py``. Under JAX's
SPMD the mesh's batch axes are the replica set; in the port each replica
is one process of the ``torch.distributed`` group, so the replica facts
are the group's: the replica count is the world size and this replica
is the process's rank. :class:`ReplicaInfo` is the lowering's and the
remapper's single source for them: the batch division factor, the rows
of the host-global batch this rank takes, and the per-replica shape of a
batch leaf. The sequence axis has no port yet: ``seq_factor`` is 1 and
naming sequence keys raises.
"""
from typing import Optional, Tuple


class ReplicaInfo:
    def __init__(self, num_replicas: int = 1, rank: int = 0, seq_keys=None):
        if seq_keys:
            raise NotImplementedError(
                "sequence-parallel batch keys %r: the port has no sequence "
                "axis yet (ROADMAP A item 9)" % (sorted(seq_keys),))
        if not 0 <= rank < num_replicas:
            raise ValueError("rank %d outside the %d replicas"
                             % (rank, num_replicas))
        self.num_replicas = int(num_replicas)
        self.rank = int(rank)

    @property
    def batch_factor(self) -> int:
        """Leading-dim division factor from host-global to per-replica."""
        return self.num_replicas

    @property
    def seq_factor(self) -> int:
        """Sequence-dim division factor (1: no sequence parallelism)."""
        return 1

    def local_shape(self, shape: Tuple[int, ...],
                    name: Optional[str] = None) -> Tuple[int, ...]:
        """Per-replica shape of a batch leaf, when divisible."""
        shape = list(shape)
        if len(shape) >= 1 and shape[0] % self.batch_factor == 0:
            shape[0] //= self.batch_factor
        return tuple(shape)

    def local_rows(self, rows: int) -> slice:
        """This rank's rows ``[r*B/N, (r+1)*B/N)`` of a leading dim of
        ``rows`` — the block order of ``P(batch_axes)`` in the JAX
        package. Raises the JAX package's ``ValueError`` when ``rows``
        does not divide."""
        if rows % self.batch_factor != 0:
            raise ValueError(
                "global batch dim %d is not divisible by the %d replicas; "
                "pad or resize the batch (every replica takes an even "
                "shard)" % (rows, self.batch_factor))
        per = rows // self.batch_factor
        return slice(self.rank * per, (self.rank + 1) * per)
