"""Remapper — feed/fetch adaptation between user values and the device.

PyTorch counterpart of ``autodist_tpu/remapper.py``. The port runs one
process on one device, so there is one replica and nothing to split:

- **feed**: numpy leaves (and Python scalars) of a batch pytree become
  tensors on the runner's device; tensors are moved there when they live
  elsewhere and pass through untouched when they are already there.
- **fetch**: tensor leaves (step metrics, serving outputs) come back as
  numpy arrays; a scalar such as the loss as a 0-d array, which
  ``float()`` reads. numpy has no bfloat16, so bfloat16 leaves come back
  as float32 (exact: every bfloat16 value is a float32 value).
"""
from typing import Any

import numpy as np
import torch
from torch.utils import _pytree as pytree


class Remapper:
    def __init__(self, device):
        self.device = torch.device(device)
        self.num_replicas = 1

    def remap_feed(self, batch) -> Any:
        """Place every leaf of ``batch`` on the device."""
        def place(leaf):
            if isinstance(leaf, torch.Tensor):
                return leaf.to(self.device)
            if isinstance(leaf, (np.ndarray, np.generic, int, float, bool)):
                return torch.as_tensor(np.asarray(leaf), device=self.device)
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
