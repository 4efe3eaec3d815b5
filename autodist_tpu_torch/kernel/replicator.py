"""Replicator — data-parallel replication bookkeeping.

PyTorch counterpart of ``autodist_tpu/kernel/replicator.py``. Under JAX's
SPMD the mesh's batch axes are the replica set; in the port each device
is one process of the ``torch.distributed`` group, so the replica facts
come from the group and, under a mesh (``parallel/mesh.py``), from this
rank's place on it. :class:`ReplicaInfo` is the lowering's and the
remapper's single source for them: the processes (``num_processes``,
``process_rank``), the data replicas (``num_replicas``: the data axis's
size, every process without a mesh) and this process's replica
(``rank``: its data index), the batch division factor, the rows of the
host-global batch this rank takes — the ranks of one model line take the
same rows, as the JAX package splits the batch over the data axis alone
(``P(batch_axes)`` with ``batch_axes = (data,)``) — and the per-replica
shape of a batch leaf. The sequence axis has no port yet:
``seq_factor`` is 1 and naming sequence keys raises.
"""
from typing import Optional, Tuple

from autodist_tpu_torch import const


class ReplicaInfo:
    """``processes`` ranks of the group and this process's ``rank``;
    ``mesh`` (a ``parallel.mesh.ProcessMesh`` over them) gives the data
    axis's size and this rank's index on it."""

    def __init__(self, processes: int = 1, rank: int = 0, seq_keys=None,
                 mesh=None):
        if seq_keys:
            raise NotImplementedError(
                "sequence-parallel batch keys %r: the port has no sequence "
                "axis yet (ROADMAP A item 9)" % (sorted(seq_keys),))
        if not 0 <= rank < processes:
            raise ValueError("rank %d outside the %d replicas"
                             % (rank, processes))
        if mesh is not None and (mesh.size != processes
                                 or mesh.rank != rank):
            raise ValueError("the mesh %r does not cover rank %d of %d "
                             "processes" % (mesh, rank, processes))
        self.num_processes = int(processes)
        self.process_rank = int(rank)
        self.mesh = mesh
        if mesh is None:
            self.num_replicas, self.rank = self.num_processes, \
                self.process_rank
        else:
            self.num_replicas = mesh.axis_size(const.DATA_AXIS)
            self.rank = mesh.axis_index(const.DATA_AXIS)

    def with_mesh(self, mesh) -> "ReplicaInfo":
        """The same processes laid out on ``mesh``."""
        return ReplicaInfo(self.num_processes, self.process_rank, mesh=mesh)

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
        """This replica's rows ``[r*B/N, (r+1)*B/N)`` of a leading dim of
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
