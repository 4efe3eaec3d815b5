"""Remapper — feed/fetch adaptation between user values and the device.

PyTorch counterpart of ``autodist_tpu/remapper.py``. Each replica is one
process (``kernel/replicator.py::ReplicaInfo``):

- **feed**: the host-global batch, as the JAX ``Runner.run`` takes it.
  Rank r takes rows ``[r*B/N, (r+1)*B/N)`` of every leaf with a leading
  dim (the block order of the JAX package's ``P(batch_axes)``, r its
  index over the batch axes); under a sequence axis, its chunk of dim 1
  of each sequence leaf (``P(batch_axes, seq_axis)``; the leaves
  ``seq_keys`` names, by their ``/``-joined path, or every leaf of rank
  two or more); an indivisible dim raises the JAX package's
  ``ValueError``; scalars are replicated. numpy leaves (and Python
  scalars) become tensors on the runner's device; tensors are moved
  there when they live elsewhere. With one replica nothing is split. A
  decode state is slot-major (:meth:`Remapper.remap_dstate`): its per-slot
  leaves split their slot dim alone, and its caches, which each rank
  already holds for its own slots only, are never split. A stacked ``[k, ...]``
  feed of the fused superstep splits from dim 1 (:meth:`Remapper.
  remap_feed_stack`), and a rank may feed its own shard
  (:meth:`Remapper.remap_feed_local`). Tensors this remapper placed
  (``data.DevicePrefetcher``'s) pass through untouched.
- **fetch**: tensor leaves (step metrics, serving outputs) come back as
  numpy arrays; a scalar such as the loss as a 0-d array, which
  ``float()`` reads. The step's metrics are already reduced over the
  replicas, so every rank fetches the same global values. numpy has no
  bfloat16, so bfloat16 leaves come back as float32 (exact: every
  bfloat16 value is a float32 value).
"""
from typing import Any, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from autodist_tpu_torch.kernel.replicator import ReplicaInfo

# the decode state's top-level leaves each rank holds for its own slots
# only: the KV caches of ``serving/decode.py``'s ``DecodeSetup`` contract
CACHE_KEYS = ("k", "v")


def path_name(path) -> str:
    """A pytree key path as the JAX package names a batch leaf:
    ``/``-joined keys (``tokens``, ``inputs/ids``)."""
    parts = []
    for k in path:
        for attr in ("key", "idx", "name"):
            if hasattr(k, attr):
                parts.append(str(getattr(k, attr)))
                break
    return "/".join(parts)


class Remapper:
    def __init__(self, device, replica_info: Optional[ReplicaInfo] = None):
        self.device = torch.device(device)
        self.replica_info = replica_info or ReplicaInfo()
        self.num_replicas = self.replica_info.num_replicas
        # marks the tensors this remapper placed, with their layout
        self._token = object()

    def _local(self, leaf, dim: int = 0, name: Optional[str] = None):
        """This rank's rows of a leaf along ``dim`` and, for a sequence
        leaf, its chunk of dim ``dim + 1`` (the leaf itself when nothing
        splits)."""
        info = self.replica_info
        ndim = np.ndim(leaf)
        if ndim <= dim:
            return leaf
        shape = np.shape(leaf)
        index = [slice(None)] * (dim + 2)
        if self.num_replicas > 1:
            index[dim] = info.local_rows(shape[dim])
        if info.seq_factor > 1 and info.seq_applies(ndim - dim, name):
            index[dim + 1] = info.local_cols(shape[dim + 1], name)
        if all(i == slice(None) for i in index):
            return leaf
        return leaf[tuple(index[:ndim])]

    def _placed(self, leaf, layout: str) -> bool:
        """True for a tensor this remapper placed on its device in
        ``layout`` (``"step"`` or ``"stacked"``): it passes through."""
        return (isinstance(leaf, torch.Tensor)
                and getattr(leaf, "_adt_layout", None) == (self._token,
                                                           layout))

    def mark_placed(self, tree, stacked: bool = False):
        """Mark the tensors of ``tree`` (this rank's shard, on the device)
        as placed, so that :meth:`remap_feed` (or :meth:`remap_feed_stack`
        with ``stacked``) passes them through untouched."""
        layout = ("stacked" if stacked else "step")
        for leaf in pytree.tree_leaves(tree):
            if isinstance(leaf, torch.Tensor):
                leaf._adt_layout = (self._token, layout)
        return tree

    def _shard_leaf(self, leaf, dim: int, name: str):
        if isinstance(leaf, torch.Tensor):
            return self._local(leaf, dim, name)
        if isinstance(leaf, (np.ndarray, np.generic, int, float, bool)):
            return np.asarray(self._local(np.asarray(leaf), dim, name))
        return leaf

    def shard_host(self, batch, stacked: bool = False):
        """This rank's shard of every leaf of ``batch``, where it lives:
        rows split from dim 0, or from dim 1 of a ``stacked`` ``[k, ...]``
        feed, whose dim 0 is the microstep dim and is never split (and a
        sequence leaf's next dim over the sequence axis)."""
        dim = 1 if stacked else 0
        return pytree.tree_map_with_path(
            lambda path, leaf: self._shard_leaf(leaf, dim, path_name(path)),
            batch)

    def _place(self, batch, layout: str, split: bool):
        stacked = layout == "stacked"

        def place(path, leaf):
            if self._placed(leaf, layout):
                return leaf
            if split:
                leaf = self._shard_leaf(leaf, 1 if stacked else 0,
                                        path_name(path))
            if isinstance(leaf, torch.Tensor):
                return leaf.to(self.device)
            if isinstance(leaf, np.ndarray):
                return torch.as_tensor(leaf, device=self.device)
            return leaf
        return self.mark_placed(pytree.tree_map_with_path(place, batch),
                                stacked)

    def remap_feed(self, batch) -> Any:
        """This rank's shard of every leaf of ``batch``, on the device.
        Leaves this remapper already placed (``data.DevicePrefetcher``'s)
        pass through untouched."""
        return self._place(batch, "step", split=True)

    def remap_feed_stack(self, stacked_batch) -> Any:
        """Place a STACKED ``[k, ...]`` batch for the fused superstep:
        dim 0 is the microstep dim, never split over the ranks; the
        per-rank split applies from dim 1. One transfer feeds k
        microsteps. Leaves already placed stacked pass through; a scalar
        leaf raises (every leaf needs the leading ``[k]`` dim)."""
        for path, leaf in pytree.tree_flatten_with_path(stacked_batch)[0]:
            if np.ndim(leaf) == 0:
                raise ValueError(
                    "stacked feed %r is a scalar — every leaf needs the "
                    "leading [k] microstep dim" % pytree.keystr(path))
        return self._place(stacked_batch, "stacked", split=True)

    def remap_feed_local(self, local_batch) -> Any:
        """Place a PROCESS-LOCAL batch as this rank's shard of the global
        batch: each rank loads only its own rows (for one,
        ``RecordFileDataset(shard=(rank, world_size))``) instead of every
        rank holding the whole global batch; nothing is split. The result
        is marked placed, so ``run``/``remap_feed`` pass it through. With
        one replica, the same as :meth:`remap_feed`."""
        return self._place(local_batch, "step", split=False)

    def remap_dstate(self, dstate) -> Any:
        """Place a continuous-batching decode state: the per-slot leaves
        (``token``, ``cursor``, ``alive``: the engine's whole ``[slots]``
        arrays) give this rank its rows ``[r*S/N, (r+1)*S/N)`` of the slot
        dim — never a sequence chunk, whatever the plan's sequence axis —
        and the :data:`CACHE_KEYS` leaves, the KV caches each rank
        holds for its own slots only, pass through as they are (the JAX
        lowering shards every slot-major leaf over the batch axes; here
        the caches are born sharded)."""
        def place(path, leaf):
            if path_name(path[:1]) in CACHE_KEYS:
                return leaf
            if self.num_replicas > 1 and np.ndim(leaf) >= 1:
                leaf = leaf[self.replica_info.local_rows(np.shape(leaf)[0])]
            if isinstance(leaf, np.ndarray):
                return torch.as_tensor(leaf, device=self.device)
            if isinstance(leaf, torch.Tensor):
                return leaf.to(self.device)
            return leaf
        return pytree.tree_map_with_path(place, dstate)

    def remap_fetch(self, fetched) -> Any:
        """Bring step outputs to the host as numpy arrays."""
        def get(leaf):
            if not isinstance(leaf, torch.Tensor):
                return leaf
            leaf = leaf.detach()
            if leaf.dtype == torch.bfloat16:
                leaf = leaf.float()
            return leaf.cpu().numpy()
        return pytree.tree_map(get, fetched)
