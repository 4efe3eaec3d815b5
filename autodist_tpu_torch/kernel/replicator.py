"""Replicator — data-parallel replication bookkeeping.

PyTorch counterpart of ``autodist_tpu/kernel/replicator.py``. Under JAX's
SPMD the mesh's batch axes are the replica set; in the port each device
is one process of the ``torch.distributed`` group, so the replica facts
come from the group and, under a mesh (``parallel/mesh.py``), from this
rank's place on it. :class:`ReplicaInfo` is the lowering's and the
remapper's single source for them: the processes (``num_processes``,
``process_rank``), the data replicas (``num_replicas``: the batch axes'
total size, every process without a mesh) and this process's replica
(``rank``: its index over the batch axes), the batch and sequence
division factors, the rows of the host-global batch this rank takes and
the columns of a sequence leaf, and the per-replica shape of a batch
leaf. As in the JAX package, dim 0 splits over every batch axis jointly
(``P(batch_axes)``: the data axis alone by default, ``(data, expert)``
under ``ExpertParallel``, the first axis major), so the ranks of one
model, pipe or seq line take the same rows; with a sequence axis, dim 1
of a sequence leaf splits over it (``P(batch_axes, seq_axis)``): only the
leaves named in ``seq_keys`` where those are named, every leaf of rank
two or more otherwise.
"""
from typing import Optional, Sequence, Tuple

from autodist_tpu_torch import const


class ReplicaInfo:
    """``processes`` ranks of the group and this process's ``rank``;
    ``mesh`` (a ``parallel.mesh.ProcessMesh`` over them) gives the batch
    axes' sizes and this rank's index on them; ``seq_axis`` (one of the
    mesh's axes) splits the sequence leaves, ``seq_keys`` names them."""

    def __init__(self, processes: int = 1, rank: int = 0, seq_keys=None,
                 mesh=None, seq_axis: Optional[str] = None,
                 batch_axes: Optional[Sequence[str]] = None):
        if not 0 <= rank < processes:
            raise ValueError("rank %d outside the %d replicas"
                             % (rank, processes))
        if mesh is not None and (mesh.size != processes
                                 or mesh.rank != rank):
            raise ValueError("the mesh %r does not cover rank %d of %d "
                             "processes" % (mesh, rank, processes))
        if mesh is None and (seq_axis or batch_axes):
            raise ValueError("seq_axis and batch_axes name axes of a mesh; "
                             "this ReplicaInfo has none")
        self.num_processes = int(processes)
        self.process_rank = int(rank)
        self.mesh = mesh
        self.seq_axis = seq_axis or None
        self.seq_keys = frozenset(seq_keys) if seq_keys else None
        if mesh is None:
            self.batch_axes = ()
            self.num_replicas, self.rank = self.num_processes, \
                self.process_rank
        else:
            self.batch_axes = tuple(batch_axes or (const.DATA_AXIS,))
            missing = [a for a in self.batch_axes + ((seq_axis,) if seq_axis
                                                     else ())
                       if a not in mesh.axes]
            if missing:
                raise ValueError("axes %s are not axes of the mesh %s"
                                 % (missing, mesh.axes))
            # the joint index over the batch axes, the first axis major
            # (the block order of P(batch_axes))
            self.num_replicas, self.rank = 1, 0
            for a in self.batch_axes:
                self.rank = self.rank * mesh.axis_size(a) + \
                    mesh.axis_index(a)
                self.num_replicas *= mesh.axis_size(a)

    def with_mesh(self, mesh, seq_axis: Optional[str] = None, seq_keys=None,
                  batch_axes: Optional[Sequence[str]] = None
                  ) -> "ReplicaInfo":
        """The same processes laid out on ``mesh``."""
        return ReplicaInfo(self.num_processes, self.process_rank,
                           seq_keys=seq_keys, mesh=mesh, seq_axis=seq_axis,
                           batch_axes=batch_axes)

    @property
    def batch_factor(self) -> int:
        """Leading-dim division factor from host-global to per-replica."""
        return self.num_replicas

    @property
    def seq_factor(self) -> int:
        """Sequence-dim division factor (1 without a sequence axis)."""
        return self.mesh.axis_size(self.seq_axis) if self.seq_axis else 1

    def seq_applies(self, ndim: int, name: Optional[str] = None) -> bool:
        """Whether dim 1 of a leaf of rank ``ndim`` named ``name`` splits
        over the sequence axis: with ``seq_keys`` only the named leaves
        (a one-hot label leaf [B, C] must not have its class dim sliced),
        without them every leaf of rank two or more."""
        if not self.seq_axis or ndim < 2:
            return False
        return self.seq_keys is None or name in self.seq_keys

    def local_shape(self, shape: Tuple[int, ...],
                    name: Optional[str] = None) -> Tuple[int, ...]:
        """Per-replica shape of a batch leaf, when divisible."""
        shape = list(shape)
        if len(shape) >= 1 and shape[0] % self.batch_factor == 0:
            shape[0] //= self.batch_factor
        if self.seq_applies(len(shape), name) \
                and shape[1] % self.seq_factor == 0:
            shape[1] //= self.seq_factor
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

    def local_cols(self, cols: int, name: Optional[str] = None) -> slice:
        """This rank's chunk ``[s*S/n, (s+1)*S/n)`` of a sequence dim of
        ``cols`` (s its index on the sequence axis); the JAX Remapper's
        ``ValueError`` when ``cols`` does not divide."""
        n = self.seq_factor
        if cols % n != 0:
            raise ValueError(
                "sequence dim %d of %r is not divisible by the %d "
                "sequence shards (not a sequence leaf? declare the token "
                "keys via SequenceParallelAR(seq_keys=[...]))"
                % (cols, name, n))
        per = cols // n
        s = self.mesh.axis_index(self.seq_axis)
        return slice(s * per, (s + 1) * per)
