"""Device prefetch: overlap the host-to-device copy with device compute.

PyTorch counterpart of ``autodist_tpu/data/prefetch.py``. While step N
computes, batch N+1 (and N+2, ...) is already on its way to the device:
the prefetcher places ``depth`` batches ahead of consumption.

On ``cuda`` (a Runner on a CUDA device) each host batch goes through a
reused ring of pinned (page-locked) staging buffers, ``depth + 1`` slots
of them, and from there a ``non_blocking`` copy runs on a side stream,
behind which the consumer's stream waits (an event) when it takes the
batch. The device tensors are ``record_stream``'d on the consumer's
stream, so the caching allocator does not hand their memory out again
before the consumer's work on them is done. A pageable copy would hold
the host for the whole transfer and run on the compute stream. On the
CPU placement is the remapper's ``remap_feed`` (``remap_feed_stack`` in
stack mode), as in the JAX package.
"""
import collections
from typing import Callable, Iterable, Iterator

import numpy as np
import torch
from torch.utils import _pytree as pytree

from autodist_tpu_torch.telemetry import spans as tel
from autodist_tpu_torch.utils import logging


def stack_batches(group, pad_to: int = None):
    """Stack a list of same-structure batches into one ``[k, ...]`` feed
    (the fused superstep's input): tensor leaves with ``torch.stack``
    where they live, host leaves with ``np.stack``. The ONE stacking
    rule, shared by :class:`DevicePrefetcher`'s stack mode and
    ``Runner.fit``'s grouping.

    ``pad_to=n`` (>= len(group)) pads the stacked leading dim to ``n`` by
    repeating the last element (the serving path's pad-to-bucket rule:
    the caller masks rows ``>= len(group)`` out). Training callers keep
    the default: a padded training step would weight the repeated
    examples into the gradient."""
    if not group:
        raise ValueError("stack_batches on an empty group — nothing to "
                         "stack (or pad)")
    if pad_to is not None:
        if pad_to < len(group):
            raise ValueError(
                "stack_batches(pad_to=%d) with %d items — pad_to must be "
                ">= the group size" % (pad_to, len(group)))
        group = list(group) + [group[-1]] * (pad_to - len(group))

    def stack(*leaves):
        if isinstance(leaves[0], torch.Tensor):
            return torch.stack(leaves)
        return np.stack([np.asarray(x) for x in leaves])
    return pytree.tree_map(stack, *group)


class _PinnedRing:
    """Reused pinned staging buffers and the side stream that copies
    them to the device. A slot is a list of pinned tensors, one a leaf,
    reallocated when a leaf's shape or dtype changes; it is written again
    only after its last copy finished (its event)."""

    def __init__(self, device, slots: int):
        self.device = device
        self.stream = torch.cuda.Stream(device=device)
        self._slots = [([], None) for _ in range(slots)]
        self._next = 0

    def place(self, host_tree):
        """Start the copy of ``host_tree``'s leaves to the device; returns
        ``(device tree, event)``. Leaves already on the device pass
        through."""
        leaves, spec = pytree.tree_flatten(host_tree)
        bufs, done = self._slots[self._next]
        if done is not None:
            done.synchronize()      # the slot's last copy has finished
        host = [torch.from_numpy(np.ascontiguousarray(x))
                if isinstance(x, np.ndarray) else x for x in leaves]
        if len(bufs) != len(host) or any(
                isinstance(h, torch.Tensor) and (
                    b is None or b.shape != h.shape or b.dtype != h.dtype)
                for b, h in zip(bufs, host)):
            bufs = [torch.empty(h.shape, dtype=h.dtype, pin_memory=True)
                    if isinstance(h, torch.Tensor)
                    and h.device.type == "cpu" else None for h in host]
        out = []
        with torch.cuda.stream(self.stream):
            for b, h in zip(bufs, host):
                if b is None:
                    out.append(h)
                    continue
                b.copy_(h)
                out.append(b.to(self.device, non_blocking=True))
            event = torch.cuda.Event()
            event.record(self.stream)
        self._slots[self._next] = (bufs, event)
        self._next = (self._next + 1) % len(self._slots)
        return pytree.tree_unflatten(out, spec), event


class DevicePrefetcher:
    """Wraps a host-batch iterator; yields device-resident batches (this
    rank's shard) with ``depth`` placements in flight.

    ``runner_or_place``: a Runner (placement through its remapper: on
    ``cuda`` through pinned buffers on a side stream, see the module
    docstring), or any callable that places one host batch.

        pf = DevicePrefetcher(dataset, runner, depth=2)
        for batch in pf:                      # already on the device
            metrics = runner.run(batch)       # remap_feed passes it through

    ``stack=k`` (> 1) is the fused superstep's feed mode: k consecutive
    host batches are stacked into ONE ``[k, ...]`` feed and placed as a
    stacked feed, so one copy feeds the whole superstep:

        pf = DevicePrefetcher(dataset, runner, depth=2, stack=4)
        runner.fit(pf, fuse_steps=4, metrics_every=8)

    (``fit`` recognizes a matching ``stack_k`` and consumes the items
    whole.) A trailing group smaller than k is dropped with a warning and
    counted in ``dropped_batches``/``dropped_examples``: a smaller stack
    would capture another superstep.
    """

    def __init__(self, iterable: Iterable, runner_or_place, depth: int = 2,
                 stack: int = 1):
        if stack < 1:
            raise ValueError("stack must be >= 1")
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self.stack_k = stack
        self._ring = None
        if callable(runner_or_place):
            # a custom placement: in stack mode it receives the stacked
            # [k, ...] host batch
            self._place: Callable = runner_or_place
        else:
            remapper = runner_or_place.remapper
            if remapper.device.type == "cuda":
                self._ring = _PinnedRing(remapper.device, depth + 1)
                self._remapper = remapper
                self._place = self._place_pinned
            elif stack > 1:
                self._place = remapper.remap_feed_stack
            else:
                self._place = remapper.remap_feed
        self._depth = depth
        self._it = iter(iterable)
        self._queue = collections.deque()
        self._exhausted = False
        # the data stack mode's dropped tails cost
        self.dropped_batches = 0
        self.dropped_examples = 0

    def _place_pinned(self, host_batch):
        """This rank's shard of ``host_batch`` through the pinned ring:
        ``(device tree, the copy's event)``."""
        stacked = self.stack_k > 1
        shard = self._remapper.shard_host(host_batch, stacked)
        placed, event = self._ring.place(shard)
        return self._remapper.mark_placed(placed, stacked), event

    def _next_host_item(self):
        """One queue item's host batch: a plain batch, or a [k, ...]
        stacked group in stack mode. Raises StopIteration when done."""
        if self.stack_k == 1:
            return next(self._it)
        group = []
        for _ in range(self.stack_k):
            try:
                group.append(next(self._it))
            except StopIteration:
                break
        if not group:
            raise StopIteration
        if len(group) < self.stack_k:
            examples = sum(self._batch_examples(b) for b in group)
            self.dropped_batches += len(group)
            self.dropped_examples += examples
            tel.counter_add("prefetch.dropped_batches", len(group))
            tel.counter_add("prefetch.dropped_examples", examples)
            tel.instant("prefetch.dropped_tail", "prefetch",
                        batches=len(group), examples=examples)
            logging.warning(
                "DevicePrefetcher(stack=%d): dropping trailing group of "
                "%d batch(es) / %d example(s) this epoch — a short stack "
                "would capture another superstep (totals so far: %d "
                "batches, %d examples)", self.stack_k, len(group),
                examples, self.dropped_batches, self.dropped_examples)
            raise StopIteration
        return stack_batches(group)

    @staticmethod
    def _batch_examples(batch) -> int:
        """Leading-dim example count of one host batch (0 if opaque)."""
        for leaf in pytree.tree_leaves(batch):
            shape = np.shape(leaf)
            if len(shape) >= 1:
                return int(shape[0])
        return 0

    def _fill(self):
        while not self._exhausted and len(self._queue) < self._depth:
            try:
                host_batch = self._next_host_item()
            except StopIteration:
                self._exhausted = True
                return
            with tel.span("prefetch.place", "prefetch",
                          stack=self.stack_k):
                self._queue.append(self._place(host_batch))
        # occupancy after filling: 0 means the consumer is about to stall
        # on the host side
        tel.gauge_set("prefetch.queue_depth", len(self._queue))

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        self._fill()
        if not self._queue:
            raise StopIteration
        out = self._queue.popleft()
        if self._ring is not None:
            out, event = out
            consumer = torch.cuda.current_stream(self._ring.device)
            consumer.wait_event(event)
            for leaf in pytree.tree_leaves(out):
                if isinstance(leaf, torch.Tensor) and \
                        leaf.device.type == "cuda":
                    leaf.record_stream(consumer)
        tel.counter_add("prefetch.batches")
        self._fill()  # start the replacement copy at once
        return out

    def take(self, n: int) -> Iterator:
        """Bounded view: yield at most n batches (for endless datasets)."""
        for _ in range(n):
            try:
                yield next(self)
            except StopIteration:
                return
