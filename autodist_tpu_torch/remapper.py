"""Remapper — feed/fetch adaptation between user values and the device.

PyTorch counterpart of ``autodist_tpu/remapper.py``. Each replica is one
process (``kernel/replicator.py::ReplicaInfo``):

- **feed**: the host-global batch, as the JAX ``Runner.run`` takes it.
  Rank r takes rows ``[r*B/N, (r+1)*B/N)`` of every leaf with a leading
  dim (the block order of the JAX package's ``P(batch_axes)``); an
  indivisible leading dim raises the JAX package's ``ValueError``;
  scalars are replicated. numpy leaves (and Python scalars) become
  tensors on the runner's device; tensors are moved there when they live
  elsewhere and pass through untouched when they are already there.
  With one replica nothing is split.
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


class Remapper:
    def __init__(self, device, replica_info: Optional[ReplicaInfo] = None):
        self.device = torch.device(device)
        self.replica_info = replica_info or ReplicaInfo()
        self.num_replicas = self.replica_info.num_replicas

    def _local(self, leaf):
        """This rank's rows of a leaf (the leaf itself with one replica)."""
        if self.num_replicas == 1 or np.ndim(leaf) == 0:
            return leaf
        return leaf[self.replica_info.local_rows(np.shape(leaf)[0])]

    def remap_feed(self, batch) -> Any:
        """This rank's shard of every leaf of ``batch``, on the device."""
        def place(leaf):
            if isinstance(leaf, torch.Tensor):
                return self._local(leaf).to(self.device)
            if isinstance(leaf, (np.ndarray, np.generic, int, float, bool)):
                return torch.as_tensor(np.asarray(self._local(
                    np.asarray(leaf))), device=self.device)
            return leaf
        return pytree.tree_map(place, batch)

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
