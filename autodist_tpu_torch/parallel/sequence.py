"""Sequence (context) parallelism helpers.

PyTorch counterpart of ``autodist_tpu/parallel/sequence.py``. Models run
in the training step with the sequence dimension sharded over the
``seq`` mesh axis (``parallel/mesh.py``), attending globally through
ring or Ulysses attention (``ops/attention.py``). These helpers give an
SP-aware model the pieces the sharding takes away:

- :func:`position_offset`: the global position of the local chunk's
  first token;
- :func:`shift_left`: the next chunk's first element, for next-token
  targets that cross shard boundaries;
- :func:`global_mean` / :func:`global_weighted_mean`: reductions that are
  right under sharding (a mean of shard-weighted means is NOT the global
  weighted mean; these sum numerator and denominator over the axis).

Each helper is the one-rank function when the axis is not bound (one
process, tracing), so one model definition serves both paths.
"""
import torch

from autodist_tpu_torch import const
from autodist_tpu_torch.parallel import mesh


def axis_bound(axis_name: str) -> bool:
    """True inside the step's binding of this axis (size > 1)."""
    return mesh.axis_bound(axis_name)


def axis_size(axis_name: str) -> int:
    b = mesh.binding(axis_name)
    return 1 if b is None else b.size


def position_offset(local_seq_len: int,
                    axis_name: str = const.SEQUENCE_AXIS) -> int:
    """Global position of local position 0 on this shard (0 unbound)."""
    b = mesh.binding(axis_name)
    return 0 if b is None else b.index * int(local_seq_len)


def shift_left(x: torch.Tensor, axis_name: str = const.SEQUENCE_AXIS,
               axis: int = 1) -> torch.Tensor:
    """Shift a seq-sharded tensor left by one GLOBAL position: element i
    gets element i + 1, the boundary element fetched from the next shard
    (the last global position wraps; mask it out in the loss). The fetch
    is one permute over the axis, differentiable only when ``x`` needs a
    gradient (integer tokens move as they are)."""
    local = torch.roll(x, -1, dims=axis)
    b = mesh.binding(axis_name)
    if b is None:
        return local
    n = b.size
    first = x.narrow(axis, 0, 1).contiguous()
    perm = [(i, (i - 1) % n) for i in range(n)]   # r receives from r + 1
    if torch.is_grad_enabled() and x.requires_grad:
        incoming = mesh.ppermute(first, perm, axis_name)
    else:
        incoming = mesh._permute(first, perm, first, b)
    keep = local.narrow(axis, 0, local.shape[axis] - 1)
    return torch.cat([keep, incoming], dim=axis)


def global_mean(x: torch.Tensor, axis_name: str = const.SEQUENCE_AXIS):
    """The true mean across shards, for METRICS. Do not use it as a loss:
    the step already averages the ranks' losses and gradients, so a loss
    returns the plain local mean (whose mean over the ranks is the global
    mean for equal shards)."""
    b = mesh.binding(axis_name)
    if b is None:
        return x.mean()
    return mesh.psum(x.mean(), axis_name) / b.size


def global_weighted_mean(values: torch.Tensor, weights: torch.Tensor,
                         axis_name: str = const.SEQUENCE_AXIS):
    """The SP-exact weighted-mean LOSS term: ``sum(v*w) / global_sum(w)``.

    Returns the rank's contribution scaled by the axis size, so that the
    step's mean over the ranks recovers ``sum_all(v*w) / sum_all(w)`` —
    the loss value (after the metrics' mean) and the gradients (after the
    sync's sum / N) both come out globally right."""
    num = torch.sum(values * weights)
    den = torch.sum(weights)
    b = mesh.binding(axis_name)
    if b is None:
        return num / torch.clamp_min(den, 1e-9)
    den_global = mesh.psum(den, axis_name)
    return b.size * num / torch.clamp_min(den_global, 1e-9)
