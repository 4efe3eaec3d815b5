"""The process mesh: named axes over the ranks of the default
``torch.distributed`` group, their process groups, and the axis binding
the model-parallel ops read.

PyTorch counterpart of ``autodist_tpu/parallel/mesh.py`` (the device
grid) and of ``autodist_tpu/parallel/sequence.py::axis_bound`` (whether
a mesh axis is bound). The JAX package reshapes its device list row-major
over the axes in major-to-minor order (``build_mesh``); the port reshapes
the ranks 0..N-1 the same way, so rank r of a ``{data: D, model: T}``
mesh sits at data index r // T and model index r % T, where the JAX
package's device r does. Each line of ranks along an axis (the ranks that
agree on every other coordinate) is one process group, made with
``torch.distributed.new_group`` by every rank, in one order: axes in the
mesh's order, lines by their lowest rank. An axis that spans every rank
uses the default group.

The binding stands for the JAX ``shard_map`` scope: inside the training
step the model and pipe axes are bound (:func:`bind`), and
``parallel/tensor.py``'s ops reduce over the model axis's group and
``parallel/pipeline.py``'s schedules move activations along the pipe
axis's; outside (tracing, one process, evaluation
before a build) it is unbound and the same ops compute the plain,
unsharded function, so one model definition serves all of them. A size-1
axis is never bound: its collectives would be identities.

:class:`HostGroups` splits the ranks by the host the resource spec puts
them on, for the hierarchical all-reduce schedule
(``collectives.hierarchical_psum``): one group a host (the JAX
package's ICI axes) and one group a local index across the hosts (its
DCN axes, JAX ``dcn_axes``).
"""
import contextlib
import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch.distributed as dist

from autodist_tpu_torch import const


class ProcessMesh:
    """``axes`` (``{name: size}``, major to minor) over ``size`` ranks,
    and ``rank``'s coordinate on each axis."""

    def __init__(self, axes: Dict[str, int], rank: int = 0):
        if not axes:
            raise ValueError("a mesh needs at least one axis")
        self.axes = {str(k): int(v) for k, v in axes.items()}
        if any(v < 1 for v in self.axes.values()):
            raise ValueError("mesh axis sizes must be >= 1: %s" % self.axes)
        self.size = int(np.prod(list(self.axes.values())))
        if not 0 <= rank < self.size:
            raise ValueError("rank %d outside the mesh %s of %d ranks"
                             % (rank, self.axes, self.size))
        self.rank = int(rank)
        self._grid = np.arange(self.size).reshape(tuple(self.axes.values()))
        where = np.argwhere(self._grid == self.rank)[0]
        self.coords = {a: int(i) for a, i in zip(self.axes, where)}
        self._groups: Optional[Dict[str, object]] = None

    def axis_size(self, name: str) -> int:
        return self.axes.get(name, 1)

    def axis_index(self, name: str) -> int:
        return self.coords.get(name, 0)

    def lines(self, name: str) -> List[List[int]]:
        """Every line of ranks along axis ``name``, ordered by their lowest
        rank; each line in the axis's index order."""
        axis = list(self.axes).index(name)
        moved = np.moveaxis(self._grid, axis, -1).reshape(
            -1, self.axes[name])
        return sorted((list(map(int, row)) for row in moved),
                      key=lambda line: line[0])

    def build_groups(self) -> None:
        """Create the process groups of every axis of size > 1: one
        ``new_group`` a line, called by every rank in the same order (a
        rank outside a line calls it too, as ``new_group`` requires); an
        axis over every rank takes the default group. Idempotent."""
        if self._groups is not None:
            return
        groups: Dict[str, object] = {}
        for name, size in self.axes.items():
            if size <= 1:
                continue
            if size == self.size:
                groups[name] = None
                continue
            for ranks in self.lines(name):
                group = dist.new_group(ranks)
                if self.rank in ranks:
                    groups[name] = group
        self._groups = groups

    def group(self, name: str):
        """The process group of this rank's line along ``name`` (None: the
        default group)."""
        if self._groups is None:
            raise RuntimeError("ProcessMesh.build_groups() first")
        return self._groups[name]

    def __repr__(self):
        return "ProcessMesh(%s, rank=%d, coords=%s)" % (self.axes, self.rank,
                                                        self.coords)


class HostGroups:
    """The intra-host and inter-host process groups of ranks laid out as
    ``hosts`` (rank r on ``hosts[r]``): the ranks of each host, in rank
    order, and, across hosts in order of first appearance, the ranks
    holding the same local index. Every rank makes every group, in one
    order (hosts, then local indexes), as ``new_group`` requires. Each
    host must hold as many ranks as every other (a JAX mesh's ICI axes
    are the same size on every host), else ``ValueError``."""

    def __init__(self, hosts: Sequence[str], rank: int):
        order: Dict[str, List[int]] = {}
        for r, h in enumerate(hosts):
            order.setdefault(h, []).append(r)
        per_host = {len(v) for v in order.values()}
        if len(per_host) != 1:
            raise ValueError(
                "the hierarchical all-reduce needs the same number of ranks "
                "on every host; the resource spec has %s"
                % {h: len(v) for h, v in order.items()})
        self.intra_ranks = list(order.values())
        self.n_intra = per_host.pop()
        self.inter_ranks = [[ranks[i] for ranks in self.intra_ranks]
                            for i in range(self.n_intra)]
        self.n_inter = len(self.intra_ranks)
        self.intra = self.inter = None
        for ranks in self.intra_ranks:
            group = dist.new_group(ranks) if self.n_intra > 1 else None
            if rank in ranks:
                self.intra = group
        for ranks in self.inter_ranks:
            group = dist.new_group(ranks) if self.n_inter > 1 else None
            if rank in ranks:
                self.inter = group

    def __repr__(self):
        return "HostGroups(%d hosts x %d ranks)" % (self.n_inter,
                                                    self.n_intra)


@dataclasses.dataclass(frozen=True)
class AxisBinding:
    """A bound mesh axis: its size, this rank's index on it and the
    process group of its line."""
    name: str
    size: int
    index: int
    group: object = None


_BOUND: Dict[str, AxisBinding] = {}


def axis_bound(name: str) -> bool:
    """True inside :func:`bind` for an axis of size > 1 (the JAX
    ``axis_bound``)."""
    return name in _BOUND


def binding(name: str) -> Optional[AxisBinding]:
    """The bound axis ``name``; None when it is not bound."""
    return _BOUND.get(name)


@contextlib.contextmanager
def bind(mesh: Optional[ProcessMesh],
         names: Sequence[str] = (const.MODEL_AXIS, const.PIPELINE_AXIS)
         ) -> Iterator[None]:
    """Bind ``names`` of ``mesh`` (those of size > 1) for the body; the
    previous bindings come back on the way out. ``mesh`` None binds
    nothing."""
    saved = dict(_BOUND)
    try:
        if mesh is not None:
            for name in names:
                if mesh.axis_size(name) > 1:
                    _BOUND[name] = AxisBinding(name, mesh.axis_size(name),
                                               mesh.axis_index(name),
                                               mesh.group(name))
        yield
    finally:
        _BOUND.clear()
        _BOUND.update(saved)
