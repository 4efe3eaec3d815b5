"""Synchronizer base class (PyTorch counterpart of
``autodist_tpu/kernel/synchronization/synchronizer.py``).

Holds the replica count and contributes a gradient transform to the
training step: ``sync(grad, state) -> (mean-reduced grad, new state)``.
Where the JAX kernel's ``psum`` is ``jax.lax.psum`` over the mesh's data
axis inside ``shard_map``, the port's is ``torch.distributed.all_reduce``
(SUM) over the process group it was given: one process a replica, the
group's backend whatever the caller created (NCCL across cards, gloo on
the CPU or over CUDA tensors). The port never picks the backend and
never moves tensors to suit one; a collective the backend cannot run on
the tensors' device raises.
"""
from abc import ABC, abstractmethod

import torch

from autodist_tpu_torch.parallel import collectives


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``group`` (None: the default group),
    as a new tensor; ``x`` is left as it was. Counts the payload in
    ``sync.wire_bytes``."""
    return collectives.all_reduce_sum_launch(x, group).wait()


class Synchronizer(ABC):
    def __init__(self, var_name: str, config, num_replicas: int,
                 process_group=None):
        self.var_name = var_name
        self.config = config
        self.num_replicas = num_replicas  # ranks reducing this gradient
        self.process_group = process_group

    def psum(self, x):
        return all_reduce_sum(x, self.process_group)

    @abstractmethod
    def sync(self, grad, state):
        """Reduce this variable's gradient across the replicas, returning
        the mean and the synchronizer's new state."""

    def state_init(self, grad_shape, dtype):
        """Per-step carried state (compressor residuals); None if
        stateless."""
        return None
