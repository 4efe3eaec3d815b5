"""ZeRO-sharded weight-update kernel (arXiv 2004.13336, stage 1).

PyTorch counterpart of
``autodist_tpu/kernel/synchronization/zero_synchronizer.py``. Where the
other synchronizer kernels contribute a gradient transform, the sharded
weight update owns the whole update path of its variable, so the
lowering (``kernel/graph_transformer.py``) drives it through three
phases:

1. :meth:`ZeroSynchronizer.reduce_scatter_launch` — the full gradient
   flattens in the JAX package's element order (``convert.to_jax_layout``:
   a Dense ``weight [out, in]`` as flax's ``[in, out]``), pads to
   ``n_data`` uniform flat shards and reduce-scatters over the data axis
   (each rank receives the summed gradient of the shard it owns), sums
   that shard over the groups of the mesh's other axes of size > 1, then
   divides by every process (the JAX ``psum_scatter`` over the data axis
   and ``psum`` over the extra axes, over all devices);
2. the lowering applies the optimizer to the owned shard only
   (``optim.OptimizerSpec.delta`` on a little ``{"v": shard}`` tree),
   against the variable's optimizer-state shard, created sharded in
   ``sync_state['zero']`` and never materialized whole;
3. :meth:`ZeroSynchronizer.gather_update` — the shard's UPDATE (the
   delta, not the param) all-gathers back; every rank adds the identical
   delta to its replicated f32 param, which therefore stays bit-equal
   across the ranks.

Because the flat order is the JAX package's, each rank's shard holds the
same elements as the JAX replica's at that data index: the
``sync_state['zero']`` leaves are the JAX package's as they are, and the
int8 wire's scale blocks cover the same elements in both packages. Under
a mesh (``parallel/mesh.py``) the shards follow the data axis alone: the
ranks of one data index (a model, pipe, seq or expert line) hold the same
shard, and the ``[N, ...]`` rows of a checkpoint put data index i at row
``i * leading_stride`` (the JAX ``leading_stride``: the product of the
axes after the data axis).

``wire_dtype="int8"`` swaps both crossings for the blockwise-quantized
forms (``collectives.int8_block_reduce_scatter`` /
``int8_block_all_gather``): the shard size rounds up to whole scale
blocks so every shard's scales are its own, and gathering the small
*delta* keeps the lossy wire off the master weights.

The static per-step payloads (:meth:`rs_payload_bytes` /
:meth:`ag_payload_bytes`) feed the ``zero.rs_bytes``/``zero.ag_bytes``
counters with the JAX package's formula.
"""

import numpy as np
import torch
import torch.nn.functional as F

from autodist_tpu_torch.convert import from_jax_layout, to_jax_layout
from autodist_tpu_torch.parallel import collectives


def zero_shard_elems(num_elements: int, n_data: int,
                     wire_dtype: str = "fp32") -> int:
    """Per-replica flat shard size: ceil split over the replicas, rounded
    up to whole scale blocks on the int8 wire."""
    n_data = max(int(n_data), 1)
    shard = -(-int(num_elements) // n_data)
    if wire_dtype == "int8":
        block = collectives.wire_block_size()
        shard = -(-shard // block) * block
    return int(shard)


def zero_wire_payload_bytes(num_elements: int, n_data: int,
                            wire_dtype: str = "fp32",
                            itemsize: int = 4) -> float:
    """Bytes ONE rs (or ag) crossing of a ZeRO-sharded variable ships:
    the padded flat payload at full width, or the int8 body + f32 scale
    sidecar over the per-shard-block-rounded padding."""
    padded = zero_shard_elems(num_elements, n_data, wire_dtype) \
        * max(int(n_data), 1)
    if wire_dtype == "int8":
        q, _ = collectives.int8_wire_payload_bytes(padded, itemsize)
        return float(q)
    return float(padded) * 4.0


def relayout_zero_sync_leaf(saved, n_old: int, zs, n_new: int,
                            old_stride: int = 1):
    """Re-lay one saved ``sync_state['zero']`` leaf (``[rows, ...]``, row
    r rank r's) for ``n_new`` ranks: concatenate the saved shards of the
    ``n_old`` data indexes (data index i at row ``i * old_stride``) into
    the global flat value, re-pad to the new shard size, and give rank r
    the shard of its data index (``(r // zs.leading_stride) %
    zs.n_data``, the JAX function's rule). Returns the ``[n_new, ...]``
    array, or ``None`` when the leaf cannot be re-laid (the caller starts
    fresh). ``zs`` is the new plan's :class:`ZeroSynchronizer` of the
    variable."""
    saved = np.asarray(saved)
    if saved.ndim == 1:
        # shared little leaf (the optimizer count): replica-identical
        return np.broadcast_to(saved[:1], (n_new,)).copy()
    old_stride = max(int(old_stride), 1)
    if saved.ndim != 2 or saved.shape[0] < n_old * old_stride:
        return None
    flat_old = np.concatenate([saved[i * old_stride]
                               for i in range(n_old)])
    flat_new = np.zeros(zs.n_data * zs.shard_elems, saved.dtype)
    m = min(flat_old.shape[0], flat_new.shape[0], zs.num_elements)
    flat_new[:m] = flat_old[:m]
    blocks = flat_new.reshape(zs.n_data, zs.shard_elems)
    return np.stack([blocks[(r // zs.leading_stride) % zs.n_data]
                     for r in range(n_new)])


class ZeroSynchronizer:
    """Per-variable sharded-update kernel: host-side shape math shared by
    the lowering, the checkpoints and the byte accounting, and the three
    phases of the step."""

    def __init__(self, var_name: str, config, shape, dtype: str,
                 n_data: int, rank: int, total: int,
                 collective_name: str = "", process_group=None,
                 extra_groups=(), leading_stride: int = 1):
        self.var_name = var_name
        self.shape = tuple(int(d) for d in shape)
        self.dtype = dtype
        # the data axis: its size, this rank's index on it and its group
        # (None: the default group)
        self.n_data = max(int(n_data), 1)
        self.rank = int(rank)
        # the JAX name: the flat element order is that variable's in flax
        self.collective_name = collective_name or var_name
        self.process_group = process_group
        # the groups of the mesh's other axes of size > 1, whose ranks
        # hold the same shard, and every process of the job (the mean's
        # divisor)
        self.extra_groups = tuple(extra_groups)
        self.total = int(total)
        # the data axis's row stride in a checkpoint's [N, ...] rows
        self.leading_stride = max(int(leading_stride), 1)
        self.wire_dtype = getattr(config, "wire_dtype", "fp32") or "fp32"
        self.num_elements = int(np.prod(self.shape or (1,)))
        self.shard_elems = zero_shard_elems(self.num_elements, self.n_data,
                                            self.wire_dtype)
        self.padded_elems = self.shard_elems * self.n_data

    # ------------------------------------------------------------ phases

    def _pad_flat(self, t: torch.Tensor) -> torch.Tensor:
        flat = to_jax_layout(t.to(torch.float32),
                             self.collective_name).reshape(-1)
        return F.pad(flat, (0, self.padded_elems - self.num_elements))

    def reduce_scatter_launch(self, grad_full: torch.Tensor,
                              async_op: bool = False):
        """Launch phase 1: full gradient -> this rank's mean-normalized
        ``[shard_elems]`` flat chunk (a ``collectives.Pending``): the
        reduce-scatter over the data axis, then the sum over each extra
        axis's group, over every process."""
        flat = self._pad_flat(grad_full)
        n, group = self.n_data, self.process_group
        if self.wire_dtype == "int8":
            pending = collectives.int8_block_reduce_scatter_launch(
                flat, group, n, async_op=async_op)
        else:
            pending = collectives.reduce_scatter_flat_launch(
                flat, group, n, async_op)

        def finish():
            local = pending.wait()[:self.shard_elems]
            for extra in self.extra_groups:
                local = collectives.all_reduce_sum_launch(local,
                                                          extra).wait()
            return local / self.total
        return collectives.Pending((), finish)

    def local_shard(self, param_full: torch.Tensor) -> torch.Tensor:
        """This rank's owned ``[shard_elems]`` flat f32 slice of a full
        variable-shaped value (the replicated param, or a moment of a
        full-layout optimizer state)."""
        flat = self._pad_flat(param_full)
        return flat[self.rank * self.shard_elems:
                    (self.rank + 1) * self.shard_elems]

    def gather_update(self, update_shard: torch.Tensor) -> torch.Tensor:
        """Phase 3: the owned shard's update delta -> the full-shape delta
        every rank applies (all-gathered; the int8 wire dequantizes the
        SAME bytes everywhere, so the applied delta is bit-identical)."""
        upd = update_shard.to(torch.float32)
        n, group = self.n_data, self.process_group
        if self.wire_dtype == "int8":
            full = collectives.int8_block_all_gather(upd, group, n)
        else:
            full = collectives.all_gather_flat(upd, group, n)
        return from_jax_layout(full[:self.num_elements], self.shape,
                               self.collective_name).to(
            getattr(torch, self.dtype))

    # -------------------------------------------------- host-side helpers

    def opt_state_init(self, optimizer, device=None) -> dict:
        """This rank's optimizer-state shard: the optimizer's state of a
        little ``{"v": [shard_elems]}`` tree. Always f32, whatever the
        param's dtype: the sharded update's state and arithmetic keep
        full precision (arXiv 2004.13336)."""
        return optimizer.init({"v": torch.zeros(
            (self.shard_elems,), dtype=torch.float32, device=device)})

    def unshard(self, rows) -> torch.Tensor:
        """The ranks' shards, ``[n_data, shard_elems]`` in rank order (or
        their list), -> the full variable-shaped f32 value in the port's
        layout."""
        flat = torch.cat([torch.as_tensor(r).reshape(-1) for r in rows])
        return from_jax_layout(flat[:self.num_elements], self.shape,
                               self.collective_name)

    # ------------------------------------------------------ byte accounting

    def _wire_payload(self) -> float:
        itemsize = torch.empty((), dtype=getattr(torch, self.dtype)
                               ).element_size()
        return zero_wire_payload_bytes(self.num_elements, self.n_data,
                                       self.wire_dtype, itemsize)

    def rs_payload_bytes(self) -> float:
        """Static per-step reduce-scatter payload bytes (int8 body + scale
        sidecar on the quantized wire)."""
        return self._wire_payload() if self.n_data > 1 else 0.0

    def ag_payload_bytes(self) -> float:
        """Static per-step update all-gather payload bytes."""
        return self._wire_payload() if self.n_data > 1 else 0.0
