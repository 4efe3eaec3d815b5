"""A fused superstep as one CUDA graph.

The JAX package compiles k training microsteps into one program
(``lax.scan`` under ``jit``, ``DistributedStep.multi_step``) and
dispatches it once. On the card the counterpart is one CUDA graph,
captured once over the k microsteps and replayed: the host launches it
with one call, and none of the step's kernels waits for the host between
launches. :class:`GraphedSuperstep` is that graph for one (k, feed
structure, shapes), with its static tensors (``donate`` changes only
what :meth:`GraphedSuperstep.replay` returns, not the graph):

- the **state** (params, optimizer state, compressor state) and, with
  host-PS variables, the **carry** (each PS variable's full value and
  full optimizer state, ``DistributedStep.run_multi``): the graph's own
  copy. A replay whose state or carry is not that copy (the first one,
  or one after a restore or a flush of the carry) copies it in first;
  with ``donate=True`` the new state and carry it returns hold the
  graph's tensors, so the next replay copies nothing. Steps that write
  their state in place (loss_fn mode, and the carry's optimizer apply)
  leave the graph's tensors where they are; a step_fn that returns new
  tensors has them copied back into the graph's state at the end of the
  graph;
- the **stacked feed** ``[k, ...]``: each replay copies the caller's
  feed into it on the device;
- the **stacked metrics** ``[k, ...]``: cloned out after each replay, so
  a pending :class:`~autodist_tpu_torch.runtime.runner.MetricsHandle`
  never aliases the next replay's metrics.

Capture follows PyTorch's rules for a whole training step in a graph: a
warm-up of one eager microstep on a side stream first (the kernels'
``nvcc`` builds, cuBLAS/cuDNN handles and workspaces, the dK/dV kernel's
shared-memory attribute), on a scratch copy of the state, so the warm-up
trains nothing the caller sees (the carry is cloned with it: DLRM's is
1.2 GB, which the clone holds a second time); then capture in a private
memory pool, which holds one superstep's activations and, with host-PS
variables, the densified gradients and the wire codec's buffers. A
capture that fails raises: nothing runs the eager loop on the card
instead.

The flash kernels' wrappers count launches in Python, which a replay
does not run. The launches a capture records are therefore taken back
out of the counts (nothing ran during the capture) and added again at
every replay (:func:`~autodist_tpu_torch.ops.flash_attention.
add_launch_counts`). Under replay these counts are bookkeeping, not a
count where the launch happens: ``chip_smoke.py`` phase 13 (a) holds
them to the kernels counted by name in a device trace of one replay.
"""
import torch
from torch.utils import _pytree as pytree

from autodist_tpu_torch.kernel.graph_transformer import _clone, _clone_state
from autodist_tpu_torch.ops import flash_attention as fa
from autodist_tpu_torch.train_state import TrainState


def _same(t):
    return t


def _parts(state: TrainState, carry=None):
    return (state.params, state.opt_state, state.sync_state, carry or ())


def _copy_into(dst, src):
    """Copy each tensor of the tree ``src`` into the tensor at the same
    place of the tree ``dst``, skipping a tensor that already is its
    destination; raises when the trees differ."""
    d_leaves, d_spec = pytree.tree_flatten(dst)
    s_leaves, s_spec = pytree.tree_flatten(src)
    if d_spec != s_spec:
        raise ValueError("a captured superstep was fed a tree of another "
                         "structure: %s, captured for %s" % (s_spec, d_spec))
    if any(isinstance(d, (dict, list, tuple)) for d in d_leaves):
        # a container pytree does not open (a dict subclass) would hide
        # its tensors from the copies: the graph would read stale ones
        raise TypeError("a captured superstep's state or feed holds a "
                        "container torch.utils._pytree does not flatten: "
                        "%s" % sorted({type(d).__name__ for d in d_leaves
                                       if isinstance(d, (dict, list,
                                                         tuple))}))
    for d, s in zip(d_leaves, s_leaves):
        if isinstance(d, torch.Tensor) and d is not s:
            d.copy_(s, non_blocking=True)


class GraphedSuperstep:
    """One CUDA graph of ``k`` microsteps of ``dstep`` over feeds shaped
    as ``stacked_batch``; :meth:`replay` runs a superstep."""

    # eager microsteps run on a scratch state before the capture
    warmup_microsteps = 1

    def __init__(self, dstep, state: TrainState, stacked_batch, k: int,
                 carry=None):
        self.k = k
        self._state = _clone_state(state)
        self._carry = _clone(carry) if carry is not None else None
        self._batch = _clone(stacked_batch)
        side = torch.cuda.Stream(device=dstep.device)
        side.wait_stream(torch.cuda.current_stream(dstep.device))
        with torch.cuda.stream(side):
            first = pytree.tree_map(lambda t: t[0], self._batch)
            out, _ = dstep._step(self._state, first, self._carry)
            _copy_into(_parts(self._state), _parts(out))
        torch.cuda.current_stream(dstep.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        before = fa.launch_counts()
        try:
            with torch.cuda.graph(self.graph):
                out, self._metrics = dstep._loop(self._state, self._batch, k,
                                                 self._carry)
                _copy_into(_parts(self._state), _parts(out))
        except Exception as e:
            raise RuntimeError(
                "capturing the %d-microstep superstep as a CUDA graph "
                "failed (%s: %s); the step must not read values back to the "
                "host" % (k, type(e).__name__, e)) from e
        finally:
            recorded = fa.launch_counts()
            fa.set_launch_counts(before)
        self.launches = {
            name: {v: n - before[name].get(v, 0) for v, n in by.items()
                   if n != before[name].get(v, 0)}
            for name, by in recorded.items()}

    def replay(self, state: TrainState, stacked_batch, donate: bool,
               carry=None):
        """One superstep from ``state`` (and the PS ``carry``) on
        ``stacked_batch``, all on the card: ``(new_state, new_carry,
        stacked metrics)``. ``donate=True`` returns the graph's own
        tensors, updated; ``donate=False`` returns copies, and ``state``
        and ``carry`` are left as they were."""
        _copy_into(self._batch, stacked_batch)
        mine, given = _parts(self._state, self._carry), _parts(state, carry)
        kept = None
        if not donate:
            # after a donated replay the caller's tensors are the graph's
            # own, which the replay writes: keep their values to put back
            own = {id(t) for t in pytree.tree_leaves(mine)}
            if any(id(t) in own for t in pytree.tree_leaves(given)):
                kept = _clone(given)
        _copy_into(mine, given)
        self.graph.replay()
        fa.add_launch_counts(self.launches)
        out = mine if donate else _clone(mine)
        if kept is not None:
            _copy_into(mine, kept)
        params, opt_state, sync_state, new_carry = pytree.tree_map(_same, out)
        new_state = TrainState(step=state.step + self.k, params=params,
                               opt_state=opt_state, sync_state=sync_state)
        return (new_state, new_carry if carry is not None else None,
                _clone(self._metrics))
