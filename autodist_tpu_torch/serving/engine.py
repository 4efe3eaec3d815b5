"""InferenceEngine — bucketed forward-only execution of one strategy
(PyTorch counterpart of ``autodist_tpu/serving/engine.py``).

The engine owns a built Runner's forward program
(``DistributedStep.predict_program``) and runs request groups padded to a
fixed set of batch buckets (e.g. {1, 8, 32, 128}). JAX compiles one
program per bucket and the buckets bound its compile cache; the eager
port keeps the same bucket discipline so request shapes, padding and
fan-out behave as in the JAX package.

The JAX engine also serves host-PS variables from a shared snapshot with a
bounded degradation window; the port's slice has no host-PS variables, so
the snapshot is always empty and never degrades — the window logic comes
with the PS family.

Requests are SINGLE EXAMPLES: pytrees shaped like one row of the feed (no
leading batch dim). ``stack_batches(..., pad_to=bucket)`` stacks a group
into the bucket's ``[bucket, ...]`` feed; rows past the real request
count repeat the last example and are masked out of the fetches.
"""
import dataclasses
import threading
import time
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from autodist_tpu_torch.telemetry import spans as tel


class ServingUnavailable(RuntimeError):
    """Typed load-shed: the serving tier cannot answer right now — queue
    overflow, or a drain for a planned departure. Callers retry elsewhere;
    nothing hangs. ``retry_after_s`` (when set) is the shed's Retry-After."""

    def __init__(self, *args, retry_after_s=None):
        super().__init__(*args)
        self.retry_after_s = retry_after_s


@dataclasses.dataclass
class ServingConfig:
    """Engine knobs. ``buckets``: padded batch sizes (None = {1, 8, 32,
    128}). The JAX config's micro-batcher, brownout and host-PS snapshot
    knobs arrive with the port of those pieces."""

    buckets: Optional[Sequence[int]] = None


DEFAULT_BUCKETS = (1, 8, 32, 128)


def stack_batches(group, pad_to: int = None):
    """Stack a list of same-structure examples into one ``[k, ...]`` feed
    (a copy of the JAX package's ``data/prefetch.py::stack_batches``):
    tensor leaves with ``torch.stack``, the rest with ``np.stack``.
    ``pad_to=n`` (>= len(group)) pads the leading dim to ``n`` by repeating
    the last element — the serving pad-to-bucket rule; the caller masks
    rows ``>= len(group)`` out of the fetches."""
    if not group:
        raise ValueError("stack_batches on an empty group — nothing to "
                         "stack (or pad)")
    if pad_to is not None:
        if pad_to < len(group):
            raise ValueError(
                "stack_batches(pad_to=%d) with %d items — pad_to must be "
                ">= the group size" % (pad_to, len(group)))
        group = list(group) + [group[-1]] * (pad_to - len(group))

    def stack(*ls):
        if isinstance(ls[0], torch.Tensor):
            return torch.stack(ls)
        return np.stack([np.asarray(x) for x in ls])
    return pytree.tree_map(stack, *group)


class InferenceEngine:
    """Bucketed forward-only inference over a built (initialized) Runner.

    ``serve_fn(full_params, batch) -> fetches`` defines the fetch set;
    ``example_request`` is ONE example fixing the feed structure."""

    def __init__(self, runner, serve_fn: Callable, example_request,
                 config: Optional[ServingConfig] = None):
        self._runner = runner
        self._dstep = runner.distributed_step
        self._serve_fn = serve_fn
        self._example_request = example_request
        self.config = config or ServingConfig()
        replicas = runner.remapper.num_replicas
        self.buckets = self._resolve_buckets(self.config.buckets, replicas)
        # built at the LARGEST bucket: its row count is what classifies
        # per-example outputs (distinctive where a bucket of 1 is not)
        self._program = self._dstep.predict_program(
            serve_fn, donate_batch=True,
            example_batch=stack_batches([example_request],
                                        pad_to=self.buckets[-1]))
        self._lock = threading.Lock()
        self.stats = {"batches": 0, "padded_rows": 0, "degraded": 0,
                      "snapshot_refreshes": 0}
        self._warmed = False

    @staticmethod
    def _resolve_buckets(buckets, replicas: int) -> Tuple[int, ...]:
        if buckets is None:
            buckets = sorted({max(-(-b // replicas), 1) * replicas
                              for b in DEFAULT_BUCKETS})
        buckets = tuple(sorted(int(b) for b in buckets))
        if not buckets or buckets[0] < 1:
            raise ValueError("buckets must be positive, got %r"
                             % (buckets,))
        if len(set(buckets)) != len(buckets):
            raise ValueError("duplicate buckets: %r" % (buckets,))
        bad = [b for b in buckets if b % replicas]
        if bad:
            raise ValueError(
                "bucket sizes %s are not multiples of the %d batch "
                "replicas" % (bad, replicas))
        return buckets

    @property
    def max_batch(self) -> int:
        return self.buckets[-1]

    def bucket_for(self, n: int) -> int:
        """Smallest bucket holding ``n`` requests."""
        if n < 1:
            raise ValueError("empty request group")
        for b in self.buckets:
            if n <= b:
                return b
        raise ServingUnavailable(
            "request group of %d exceeds the largest bucket %d"
            % (n, self.buckets[-1]))

    def _snapshot(self):
        """The host-PS values feed of the next dispatch: a pull each
        dispatch (``{}`` with no host-resident variable; the JAX engine's
        cached snapshot waits with ROADMAP A item 8)."""
        return self._dstep.pull_ps()

    def warmup(self):
        """Run every bucket once on repeats of the example request (first
        kernel builds and allocator growth happen here, not on the first
        request)."""
        for b in self.buckets:
            with tel.span("serve.warmup", "serve", bucket=b):
                self.run_batch([self._example_request] * b)
        self._warmed = True
        tel.counter_add("serve.compiles", len(self.buckets))
        return self

    def recompiles_after_warmup(self) -> int:
        """Eager programs compile nothing per shape: always 0 (kept for the
        JAX engine's stats contract)."""
        return 0

    def run_batch(self, requests, to_host: bool = True) -> Tuple[dict, int]:
        """Execute one request group: pad to the nearest bucket, run the
        program, mask the padded rows. Returns ``(fetches, n)`` with every
        per-example leaf sliced to the ``n`` real requests — as numpy on
        the host, or with ``to_host=False`` as tensors left on the device
        (the decode engine keeps prefilled caches there)."""
        n = len(requests)
        bucket = self.bucket_for(n)
        host = stack_batches(list(requests), pad_to=bucket)
        with self._lock:
            if bucket > n:
                self.stats["padded_rows"] += bucket - n
                tel.counter_add("serve.padded_rows", bucket - n)
            state = self._runner.state
            if state is None:
                raise RuntimeError("InferenceEngine over an uninitialized "
                                   "Runner — call runner.init() first")
            t0 = time.perf_counter()
            with tel.span("serve.dispatch", "serve", n=n, bucket=bucket):
                ps_vals = self._snapshot()
                placed = self._runner.remapper.remap_feed(host)
                device_out = self._program(state, ps_vals, placed)
            t1 = time.perf_counter()
            with tel.span("serve.readback", "serve", n=n, bucket=bucket):
                fetched = (self._runner.remapper.remap_fetch(device_out)
                           if to_host else device_out)
            tel.hist_observe("serve.dispatch_ms", (t1 - t0) * 1e3)
            tel.hist_observe("serve.readback_ms",
                             (time.perf_counter() - t1) * 1e3)
            self.stats["batches"] += 1
        tel.counter_add("serve.batches")
        masked = pytree.tree_map(
            lambda is_batch, a: a[:n] if is_batch else a,
            self._program.batch_mask, fetched)
        return masked, n

    def predict(self, requests) -> list:
        """Run a request list through one padded batch and return one
        fetch tree PER REQUEST (row i of every per-example leaf)."""
        fetched, n = self.run_batch(requests)
        return self.fan_out(fetched, n)

    def fan_out(self, fetched, n: int) -> list:
        """Split one masked fetch tree into ``n`` per-request trees."""
        return [pytree.tree_map(
            lambda is_batch, a, _i=i: a[_i] if is_batch else a,
            self._program.batch_mask, fetched)
            for i in range(n)]
