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
mesh's order, lines by their lowest rank; so is each block spanned by a
set of axes the caller names (the batch axes, ``(data, expert)`` under
``ExpertParallel``, over which serving gathers its rows). An axis, or a
set, that spans every rank uses the default group (or the group the
caller gives: a serving plane's copy of the mesh has gloo groups of its
own).

The binding stands for the JAX ``shard_map`` scope: inside the training
step the model, pipe, seq and expert axes are bound (:func:`bind`), and
``parallel/tensor.py``'s ops reduce over the model axis's group,
``parallel/pipeline.py``'s schedules move activations along the pipe
axis's, ``ops/attention.py``'s ring and Ulysses attention and
``parallel/sequence.py`` exchange over the seq axis's, and
``parallel/expert.py`` routes tokens over the expert axis's; outside
(tracing, one process, evaluation before a build) it is unbound and the
same ops compute the plain, unsharded function, so one model definition
serves all of them. A size-1 axis is never bound: its collectives would
be identities.

The exchanges over a bound axis live here, so that every family of
model parallelism shares them: :func:`ppermute` (the JAX
``lax.ppermute``), :func:`all_to_all` (``lax.all_to_all(...,
tiled=True)``) and :func:`psum`, each differentiable. A permute and an
all-to-all are each ONE ``all_to_all_single`` over the axis's group
(:func:`_move`), with zero-sized splits to the ranks that get nothing:
a collective, so a two-way exchange cannot deadlock, and gloo runs it on
CUDA tensors (two ranks share one card, where NCCL refuses them; gloo's
``send`` of a CUDA tensor aborts the process). The moves are counted in
telemetry counters named by the axis (``pp.*`` on the pipe axis,
``sp.*`` on the seq axis, ``ep.*`` on the expert axis):
``<p>.p2p_sends`` and ``<p>.p2p_bytes`` for each non-empty payload a
permute sends, ``<p>.a2a_calls`` and ``<p>.a2a_bytes`` for each
all-to-all and the bytes of the tensor that enters it, forward and
backward alike.

:class:`HostGroups` splits the ranks by the host the resource spec puts
them on, for the hierarchical all-reduce schedule
(``collectives.hierarchical_psum``): one group a host (the JAX
package's ICI axes) and one group a local index across the hosts (its
DCN axes, JAX ``dcn_axes``).
"""
import contextlib
import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from autodist_tpu_torch import const
from autodist_tpu_torch.telemetry import spans as tel

Perm = Sequence[Tuple[int, int]]


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
        return self.blocks((name,))

    def _key(self, names: Sequence[str]) -> Tuple[str, ...]:
        """The axes of ``names`` of size > 1, in the mesh's order."""
        want = set(names)
        return tuple(a for a, n in self.axes.items() if a in want and n > 1)

    def blocks(self, names: Sequence[str]) -> List[List[int]]:
        """Every block of ranks spanned jointly by the axes ``names`` (the
        ranks that agree on every other coordinate), ordered by their
        lowest rank; each block in the joint index order, the first axis
        of ``names`` major (the block order of ``P(names)``)."""
        names = list(names)
        order = [list(self.axes).index(a) for a in names]
        rest = [i for i in range(len(self.axes)) if i not in order]
        moved = np.transpose(self._grid, rest + order).reshape(
            -1, int(np.prod([self.axes[a] for a in names] or [1])))
        return sorted((list(map(int, row)) for row in moved),
                      key=lambda block: block[0])

    def size_of(self, names: Sequence[str]) -> int:
        """The joint size of the axes ``names``."""
        return int(np.prod([self.axis_size(a) for a in names] or [1]))

    def build_groups(self, joint: Sequence[Sequence[str]] = (),
                     backend: Optional[str] = None,
                     full_group=None) -> None:
        """Create the process groups of every axis of size > 1, and of each
        set of axes in ``joint`` spanning more than one of them: one
        ``new_group`` a line (or block), called by every rank in the same
        order (a rank outside a line calls it too, as ``new_group``
        requires), of ``backend`` (None: the default group's); an axis, or
        a set, over every rank takes ``full_group`` (None: the default
        group). Idempotent."""
        if self._groups is not None:
            return
        groups: Dict[object, object] = {}
        sets = [(name,) for name, size in self.axes.items() if size > 1]
        for names in joint:
            key = self._key(names)
            if len(key) > 1 and key not in sets:
                sets.append(key)
        for key in sets:
            if self.size_of(key) == self.size:
                groups[key] = full_group
                continue
            for ranks in self.blocks(key):
                group = dist.new_group(ranks, backend=backend)
                if self.rank in ranks:
                    groups[key] = group
        self._groups = groups

    def group(self, name: str):
        """The process group of this rank's line along ``name`` (None: the
        default group, or the mesh's ``full_group``)."""
        return self.group_of((name,))

    def group_of(self, names: Sequence[str]):
        """The process group of this rank's block over the axes ``names``
        (one axis, or a set :meth:`build_groups` was given), its axes of
        size 1 left out."""
        if self._groups is None:
            raise RuntimeError("ProcessMesh.build_groups() first")
        return self._groups[self._key(names)]

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


#: the axes a training step binds (the JAX step's shard_map scope)
MODEL_PARALLEL_AXES = (const.MODEL_AXIS, const.PIPELINE_AXIS,
                       const.SEQUENCE_AXIS, const.EXPERT_AXIS)


@contextlib.contextmanager
def bind(mesh: Optional[ProcessMesh],
         names: Sequence[str] = MODEL_PARALLEL_AXES) -> Iterator[None]:
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


# --------------------------------------------------------- the exchanges

_COUNTER_PREFIX = {const.PIPELINE_AXIS: "pp", const.SEQUENCE_AXIS: "sp",
                   const.EXPERT_AXIS: "ep"}


def _prefix(b: AxisBinding) -> str:
    return _COUNTER_PREFIX.get(b.name, b.name)


def _move(sends: Dict[int, torch.Tensor], recvs: Dict[int, torch.Size],
          like: torch.Tensor, b: AxisBinding,
          count: bool = True) -> Dict[int, torch.Tensor]:
    """One exchange over the axis's group: this rank sends ``sends[dst]``
    to axis index ``dst`` and receives a tensor of ``recvs[src]``'s shape
    from axis index ``src`` (every payload of ``like``'s dtype and
    device), as one ``all_to_all_single``. Every rank of the line must
    call it with matching ends. ``count`` adds each payload to the
    axis's ``p2p`` counters."""
    in_splits, out_splits = [0] * b.size, [0] * b.size
    parts = []
    for dst in sorted(sends):
        t = sends[dst].reshape(-1).to(like.dtype)
        in_splits[dst] = t.numel()
        parts.append(t)
        if count:
            tel.counter_add(_prefix(b) + ".p2p_sends")
            tel.counter_add(_prefix(b) + ".p2p_bytes",
                            t.numel() * t.element_size())
    for src, shape in recvs.items():
        out_splits[src] = int(torch.Size(shape).numel())
    inp = torch.cat(parts) if parts else like.new_empty(0)
    out = like.new_empty(sum(out_splits))
    dist.all_to_all_single(out, inp, out_splits, in_splits, group=b.group)
    got, at = {}, 0
    for src in range(b.size):
        if src in recvs:
            got[src] = out[at:at + out_splits[src]].view(recvs[src])
        at += out_splits[src]
    return got


def _permute(x: Optional[torch.Tensor], perm: Perm, like: torch.Tensor,
             b: AxisBinding) -> Optional[torch.Tensor]:
    """``lax.ppermute`` of ``x`` over the pairs ``perm`` (``(src, dst)``
    axis indexes, each at most once a side): the tensor from this rank's
    source, or None when no pair ends here. A rank that is no pair's
    source passes None. No gradient."""
    index = b.index
    sends = {dst: x for src, dst in perm if src == index}
    recvs = {src: like.shape for src, dst in perm if dst == index}
    return _move(sends, recvs, like, b).get(next(iter(recvs), None))


def _inverse(perm: Perm) -> List[Tuple[int, int]]:
    return [(dst, src) for src, dst in perm]


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, b):
        ctx.perm, ctx.b = perm, b
        out = _permute(x, perm, x, b)
        return out if out is not None else torch.zeros_like(x)

    @staticmethod
    def backward(ctx, grad):
        out = _permute(grad, _inverse(ctx.perm), grad, ctx.b)
        return (out if out is not None else torch.zeros_like(grad)), \
            None, None


def ppermute(x: torch.Tensor, perm: Perm, axis_name: str) -> torch.Tensor:
    """The JAX ``lax.ppermute`` over the bound axis ``axis_name``: rank
    ``dst`` of each pair ``(src, dst)`` gets rank ``src``'s ``x``, a rank
    that is no pair's destination gets zeros; the backward moves the
    cotangent along the inverse permutation."""
    return _PPermute.apply(x, list(perm), binding(axis_name))


def _all_to_all(x: torch.Tensor, b: AxisBinding, split_axis: int,
                concat_axis: int) -> torch.Tensor:
    """The tiled all-to-all: chunk j of ``x`` along ``split_axis`` goes to
    axis index j, and the chunks received are concatenated along
    ``concat_axis`` in the order of their sources. One ``_move`` with
    equal splits."""
    n = b.size
    if x.shape[split_axis] % n != 0:
        raise ValueError("all_to_all: dim %d of %s is not divisible by the "
                         "%d ranks of axis %r" % (split_axis,
                                                  tuple(x.shape), n, b.name))
    tel.counter_add(_prefix(b) + ".a2a_calls")
    tel.counter_add(_prefix(b) + ".a2a_bytes", x.numel() * x.element_size())
    chunks = x.chunk(n, dim=split_axis)
    got = _move(dict(enumerate(chunks)), {j: chunks[0].shape
                                          for j in range(n)},
                x, b, count=False)
    return torch.cat([got[j] for j in range(n)], dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, b, split_axis, concat_axis):
        ctx.b, ctx.axes = b, (split_axis, concat_axis)
        return _all_to_all(x, b, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, grad):
        split_axis, concat_axis = ctx.axes
        return _all_to_all(grad, ctx.b, concat_axis, split_axis), \
            None, None, None


def all_to_all(x: torch.Tensor, axis_name: str, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """The JAX ``lax.all_to_all(x, axis_name, split_axis, concat_axis,
    tiled=True)`` over the bound axis: ``x``'s ``split_axis`` shrinks by
    the axis size and its ``concat_axis`` grows by it. The backward is
    the inverse all-to-all. Unbound: ``x``."""
    b = binding(axis_name)
    if b is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllToAll.apply(x, b, split_axis, concat_axis)
    return _all_to_all(x, b, split_axis, concat_axis)


def _all_reduce(x: torch.Tensor, b: AxisBinding) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=b.group)
    return out


class _PSum(torch.autograd.Function):
    """The sum over the axis's group; the backward sums the cotangent over
    it too (the transpose of ``psum`` under ``shard_map``)."""

    @staticmethod
    def forward(ctx, x, b):
        ctx.b = b
        return _all_reduce(x, b)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.b), None


def psum(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """The JAX ``lax.psum`` over the bound axis; ``x`` when unbound."""
    b = binding(axis_name)
    if b is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _PSum.apply(x, b)
    return _all_reduce(x, b)
