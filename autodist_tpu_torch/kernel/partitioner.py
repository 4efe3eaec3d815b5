"""Variable partitioner — sharded storage layouts for variables and their
optimizer state.

PyTorch counterpart of ``autodist_tpu/kernel/partitioner.py``. A
partitioned variable is stored as this rank's shard: the split axis is
zero-padded to a multiple of the data axis's size (every process without
a mesh; ceil-split, so every shard has one shape) and the rank at data
index i keeps the i-th slice: the ranks of one data index (a model, pipe,
seq or expert line) hold the same shard, as on the JAX mesh, whose
layouts live on its data axis. The partitioner string's shard count is
kept as metadata (``num_shards``), as in the JAX package, even where it
is smaller than the axis. The step
all-gathers the full value before the loss (:meth:`VarLayout.gather_full`)
and reduce-scatters the full gradient back to the shard
(:meth:`VarLayout.reduce_scatter_grad_launch`, one ``all_to_all_single``
and a local sum, ``parallel/collectives.py``); the optimizer applies to
the shard, whose moments are shard-shaped too. Checkpoints hold the
original, unpadded layout (``DistributedStep.gather_params``).

The split axis indexes the variable in the JAX package's layout (its
flax shape and element order, ``convert.to_jax_layout``: a Dense
``weight [out, in]`` splits ``[in, out]``'s axis), so each rank stores
the elements the JAX package's shard holds, in that layout: a shard is
what the optimizer sees, and a norm over it (``optim.clip_global_norm``)
is the JAX one.

A model-parallel layout (``mp_axes``: ``((dim, mesh axis), ...)``, the
JAX ``VarLayout.mp_axes``) stores this rank's slice of each listed dim,
cut evenly by its index on that mesh axis (``parallel/mesh.py``), and
the compute consumes the slice as it is (``parallel/tensor.py``): no
gather before the loss, no padding (the sizes must divide: ADT206). The
dims index the JAX layout, which must be the port's too (a model written
over the JAX pytree, ``models/tp_lm.py``). A size-1 axis leaves the
variable replicated, as in the JAX package.
"""
import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from autodist_tpu_torch import const
from autodist_tpu_torch.analysis.diagnostics import DiagnosticError, Severity
from autodist_tpu_torch.analysis.rules import check_mp_axes_node
from autodist_tpu_torch.convert import from_flax, to_flax
from autodist_tpu_torch.parallel import collectives
from autodist_tpu_torch.strategy.base import Strategy
from autodist_tpu_torch.utils import logging


@dataclasses.dataclass(frozen=True)
class VarLayout:
    """Storage layout of one variable over the replicas (``partitioned``:
    the reference's ``PartitionedVariable``)."""
    name: str
    partitioned: bool = False
    axis: int = 0                 # split axis (of the JAX layout)
    orig_dim: int = 0             # original size of the split axis
    padded_dim: int = 0           # padded size (multiple of the axis size)
    num_shards: int = 1           # the strategy's shard count (metadata)
    # the JAX layout of the variable: its JAX name and flax shape, and
    # the port's shape (none: the port's tensor is split as it is)
    jax_name: str = ""
    flax_shape: Tuple[int, ...] = ()
    shape: Tuple[int, ...] = ()
    mp_axes: Tuple[Tuple[int, str], ...] = ()   # ((dim, mesh axis), ...)

    @property
    def mp_axis_names(self) -> Tuple[str, ...]:
        return tuple(a for _, a in self.mp_axes)

    def mp_local(self, full: torch.Tensor, mesh) -> torch.Tensor:
        """This rank's slice of the full value (or of a state leaf of its
        shape), as a new contiguous tensor."""
        for dim, axis in self.mp_axes:
            n = full.shape[dim] // mesh.axis_size(axis)
            full = full.narrow(dim, mesh.axis_index(axis) * n, n)
        return full.contiguous()

    def mp_gather(self, local: torch.Tensor, mesh) -> torch.Tensor:
        """The full value from the slices of this rank's lines: an
        all-gather over each mesh axis's group, concatenated on its dim
        (a collective every rank of those groups must join)."""
        for dim, axis in reversed(self.mp_axes):
            n = mesh.axis_size(axis)
            lead = local.movedim(dim, 0).contiguous()
            full = collectives.all_gather_flat(lead.reshape(-1),
                                               mesh.group(axis), n)
            local = full.reshape((n * lead.shape[0],) + tuple(
                lead.shape[1:])).movedim(0, dim).contiguous()
        return local

    def to_flax(self, t: torch.Tensor) -> torch.Tensor:
        """A full value of the port's layout in the JAX layout."""
        if not self.flax_shape:
            return t
        return to_flax(t, self.jax_name, self.flax_shape)

    def from_flax(self, t: torch.Tensor) -> torch.Tensor:
        """Inverse of :meth:`to_flax`, a contiguous tensor."""
        if not self.flax_shape:
            return t
        return from_flax(t, self.shape, self.jax_name)

    def pad(self, t: torch.Tensor) -> torch.Tensor:
        """Zero-pad the split axis to ``padded_dim`` (full-tensor form)."""
        if not self.partitioned or self.padded_dim == self.orig_dim:
            return t
        widths = [0, 0] * t.dim()
        # F.pad lists the last dim first
        widths[2 * (t.dim() - 1 - self.axis) + 1] = \
            self.padded_dim - self.orig_dim
        return F.pad(t, widths)

    def unpad(self, t: torch.Tensor) -> torch.Tensor:
        if not self.partitioned or self.padded_dim == self.orig_dim:
            return t
        return t.narrow(self.axis, 0, self.orig_dim)

    def shard_dim(self, n: int) -> int:
        return self.padded_dim // n

    def local(self, full: torch.Tensor, rank: int, n: int) -> torch.Tensor:
        """Rank ``rank``'s shard of the full (unpadded) value of the
        port's layout, in the JAX layout, as a new contiguous tensor."""
        if not self.partitioned:
            return full
        rows = self.shard_dim(n)
        return self.pad(self.to_flax(full)).narrow(
            self.axis, rank * rows, rows).contiguous()

    def gather_full(self, local: torch.Tensor, group, n: int
                    ) -> torch.Tensor:
        """All-gather the ranks' shards into the full (unpadded) value,
        in the port's layout."""
        if not self.partitioned or n <= 1:
            return local
        lead = local.movedim(self.axis, 0).contiguous()
        full = collectives.all_gather_flat(lead.reshape(-1), group, n)
        full = full.reshape((n * lead.shape[0],) + tuple(lead.shape[1:]))
        return self.from_flax(
            self.unpad(full.movedim(0, self.axis)).contiguous())

    def reduce_scatter_grad_launch(self, grad_full: torch.Tensor, group,
                                   n: int, async_op: bool = False):
        """Launch the pad + reduce-scatter of the full gradient (the
        port's layout): each rank gets the summed gradient of its own
        shard, in the JAX layout (sum, not mean — the caller normalizes).
        Returns a ``collectives.Pending``."""
        if not self.partitioned:
            raise ValueError("reduce_scatter_grad on unpartitioned var %s"
                             % self.name)
        rows = self.padded_dim
        lead = self.pad(self.to_flax(grad_full)).movedim(
            self.axis, 0).contiguous()
        rest = tuple(lead.shape[1:])
        pending = collectives.reduce_scatter_flat_launch(
            lead.reshape(-1), group, n, async_op)

        def finish():
            shard = pending.wait().reshape((rows // n,) + rest)
            return shard.movedim(0, self.axis).contiguous()
        return collectives.Pending((), finish)


def _mp_layout(node, info, mesh_axis_sizes: Dict[str, int]) -> VarLayout:
    """The model-parallel layout of a node's ``mp_axes`` (the JAX
    ``VariablePartitioner._mp_layout``): checked by the rule function the
    linter runs (ADT205/206/207, raised as a ``DiagnosticError``); axes
    of size 1 dropped; ``mp_axes`` wins over a ``partitioner``, with the
    JAX warning."""
    bad = [d for d in check_mp_axes_node(node.var_name, node.mp_axes,
                                         tuple(info.shape), mesh_axis_sizes)
           if d.severity >= Severity.ERROR]
    if bad:
        raise DiagnosticError(bad[0])
    flax_shape = tuple(getattr(info, "flax_shape", None) or info.shape)
    if flax_shape != tuple(info.shape):
        raise ValueError(
            "var %s: mp_axes index the JAX layout %s, and the port holds "
            "this variable as %s; write the model over the JAX layout "
            "(as models/tp_lm.py does) to shard it"
            % (node.var_name, flax_shape, tuple(info.shape)))
    mp = tuple((dim, axis) for dim, axis in sorted(node.mp_axes.items())
               if mesh_axis_sizes[axis] > 1)
    if node.partitioner is not None:
        logging.warning("var %s: mp_axes and partitioner both set; "
                        "mp_axes wins (ZeRO+MP on one var unsupported)",
                        node.var_name)
    return VarLayout(name=node.var_name, mp_axes=mp)


class VariablePartitioner:
    """Computes ``{var_name: VarLayout}`` from a compiled Strategy:
    variables whose node has ``mp_axes`` get a model-parallel layout over
    the mesh (``mesh_axis_sizes``, by default the data axis alone);
    variables whose node has a ``partitioner`` string get a partitioned
    layout over the data axis, of ``num_replicas`` ranks (its size);
    everything else is replicated (the JAX ``VariablePartitioner``)."""

    @staticmethod
    def apply(strategy: Strategy, var_infos, num_replicas: int,
              mesh_axis_sizes: Optional[Dict[str, int]] = None
              ) -> Dict[str, VarLayout]:
        sizes = mesh_axis_sizes or {const.DATA_AXIS: num_replicas}
        layouts: Dict[str, VarLayout] = {}
        for node in strategy.node_config:
            info = var_infos.get(node.var_name)
            if info is None:
                continue
            if node.mp_axes:
                layouts[node.var_name] = _mp_layout(node, info, sizes)
                continue
            axis = node.partition_axis
            if node.partitioner is None or axis is None or num_replicas <= 1:
                layouts[node.var_name] = VarLayout(name=node.var_name)
                continue
            flax_shape = tuple(getattr(info, "flax_shape", None)
                               or info.shape)
            dim = flax_shape[axis]
            if dim < num_replicas:
                # fewer rows than replicas: mostly-padding shards gathered
                # every step for no benefit
                logging.warning("var %s dim %d < %d replicas; keeping "
                                "replicated", node.var_name, dim,
                                num_replicas)
                layouts[node.var_name] = VarLayout(name=node.var_name)
                continue
            padded = -(-dim // num_replicas) * num_replicas
            layouts[node.var_name] = VarLayout(
                name=node.var_name, partitioned=True, axis=axis,
                orig_dim=dim, padded_dim=padded,
                num_shards=node.num_shards,
                jax_name=info.collective_name, flax_shape=flax_shape,
                shape=tuple(info.shape))
        for name in var_infos:
            layouts.setdefault(name, VarLayout(name=name))
        return layouts
