"""InferenceEngine — bucketed forward-only execution of one strategy
(PyTorch counterpart of ``autodist_tpu/serving/engine.py``).

The engine owns a built Runner's forward program
(``DistributedStep.predict_program``) and runs request groups padded to a
fixed set of batch buckets (e.g. {1, 8, 32, 128}). JAX compiles one
program per bucket and the buckets bound its compile cache; the eager
port keeps the same bucket discipline so request shapes, padding and
fan-out behave as in the JAX package.

Host-PS variables are served from one snapshot shared by the requests,
as in the JAX engine: pulled onto the device, refreshed at most every
``snapshot_max_age_s``; a refresh that fails (an owner out of reach, the
store's own degraded window used up) serves the last good snapshot for up
to ``degraded_batches`` consecutive batches, then sheds with
:class:`ServingUnavailable` (the engine stays alive and retries the
refresh at the next batch).

Requests are SINGLE EXAMPLES: pytrees shaped like one row of the feed (no
leading batch dim), as host (numpy) leaves. ``stack_batches(...,
pad_to=bucket)`` stacks a group into the bucket's ``[bucket, ...]`` feed;
rows past the real request count repeat the last example and are masked
out of the fetches.

At N > 1 ranks the engine is one controller and N - 1 executors
(``serving/plane.py``): every rank builds it, in the same order as its
other engines; the chief (rank 0) dispatches — :meth:`run_batch`
broadcasts the padded bucket and its snapshot-refresh decision, then each
rank runs its ``bucket / B`` rows (B the batch replicas: the batch axes'
size, so the ranks of one model, pipe, seq or expert line run the same
rows, with that plan's axes bound) and the per-example outputs come back
whole — while each follower's loop runs the chief's headers from the
engine's construction until the chief's :meth:`close`. A follower's
:meth:`follow` waits for that.
"""
import dataclasses
import threading
import time
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from autodist_tpu_torch import const
from autodist_tpu_torch.serving.plane import ServingPlane
from autodist_tpu_torch.telemetry import spans as tel
from autodist_tpu_torch.utils import logging


class ServingUnavailable(RuntimeError):
    """Typed load-shed: the serving tier cannot answer right now — queue
    overflow, or a drain for a planned departure. Callers retry elsewhere;
    nothing hangs. ``retry_after_s`` (when set) is the shed's Retry-After."""

    def __init__(self, *args, retry_after_s=None):
        super().__init__(*args)
        self.retry_after_s = retry_after_s


@dataclasses.dataclass
class ServingConfig:
    """Engine and micro-batcher knobs (the JAX ``ServingConfig``).

    ``buckets``: padded batch sizes, each a multiple of the batch replica
    count (None = {1, 8, 32, 128} rounded up to multiples).
    ``max_delay_ms``: the batching deadline — how long the first request
    of a group may wait for company. ``max_queue``: backpressure bound;
    submits past it shed. ``snapshot_max_age_s``: the host-PS snapshot's
    refresh period. ``degraded_batches``: consecutive batches that may
    serve the last good snapshot while refreshes fail (None = max(strategy
    staleness, ``ADT_PS_MAX_LAG``, 1)).

    Brownout: when the queue sits above ``brownout_queue_frac *
    max_queue`` for ``brownout_sustain_s``, the micro-batcher widens the
    group deadline by ``brownout_delay_factor`` so that dispatches run at
    full buckets; ``brownout_delay_factor=1.0`` disables it."""

    buckets: Optional[Sequence[int]] = None
    max_delay_ms: float = 2.0
    max_queue: int = 1024
    snapshot_max_age_s: float = 0.1
    degraded_batches: Optional[int] = None
    brownout_queue_frac: float = 0.75
    brownout_sustain_s: float = 1.0
    brownout_delay_factor: float = 4.0

    def __post_init__(self):
        if self.max_delay_ms < 0:
            raise ValueError("max_delay_ms must be >= 0")
        if self.max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        if (self.degraded_batches is not None
                and self.degraded_batches < 0):
            raise ValueError("degraded_batches must be >= 0")
        if not 0.0 < self.brownout_queue_frac <= 1.0:
            raise ValueError("brownout_queue_frac must be in (0, 1]")
        if self.brownout_sustain_s < 0:
            raise ValueError("brownout_sustain_s must be >= 0")
        if self.brownout_delay_factor < 1.0:
            raise ValueError("brownout_delay_factor must be >= 1.0 "
                             "(1.0 disables brownout)")


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
    ``example_request`` is ONE example fixing the feed structure. ``plane``
    and ``keep_local`` serve the decode engine's prefill: it runs on the
    decode engine's plane, and its caches stay on their rank."""

    def __init__(self, runner, serve_fn: Callable, example_request,
                 config: Optional[ServingConfig] = None, plane=None,
                 keep_local=()):
        self._runner = runner
        self._dstep = runner.distributed_step
        self._serve_fn = serve_fn
        self._example_request = example_request
        self.config = config or ServingConfig()
        replicas = runner.remapper.num_replicas
        self.buckets = self._resolve_buckets(self.config.buckets, replicas)
        self._owns_plane = plane is None and self._dstep.num_replicas > 1
        if self._owns_plane:
            plane = ServingPlane(self._dstep.rank, self._dstep.num_replicas,
                                 "engine", self._dstep.mesh,
                                 self._dstep.replica_info.batch_axes)
        self._plane = plane
        # built at the LARGEST bucket: its row count is what classifies
        # per-example outputs (distinctive where a bucket of 1 is not)
        self._program = self._dstep.predict_program(
            serve_fn, donate_batch=True,
            example_batch=stack_batches([example_request],
                                        pad_to=self.buckets[-1]),
            group=plane.group if plane is not None else None,
            keep_local=keep_local,
            mesh=plane.mesh if plane is not None else None)
        # the host-PS snapshot and its degradation state (run_batch holds
        # the lock around it)
        self._lock = threading.Lock()
        self._ps_vals = None
        self._snap_t = 0.0
        self._degraded_used = 0
        self.stats = {"batches": 0, "padded_rows": 0, "degraded": 0,
                      "snapshot_refreshes": 0}
        self._warmed = False
        if plane is not None:
            plane.on("forward", self._on_forward)
            if self._owns_plane and not plane.chief:
                plane.start_follower()

    @property
    def chief(self) -> bool:
        """Whether this rank dispatches (always, at one replica)."""
        return self._plane is None or self._plane.chief

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
                "replicas — padded bucket batches must split evenly "
                "over the mesh" % (bad, replicas))
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

    @property
    def _degraded_bound(self) -> int:
        if self.config.degraded_batches is not None:
            return self.config.degraded_batches
        store = self._dstep.ps_store
        staleness = store.max_staleness() if store is not None else 0
        return max(staleness, const.ENV.ADT_PS_MAX_LAG.val, 1)

    def _refresh_due(self) -> bool:
        """The chief's refresh decision: the host-PS snapshot is missing or
        ``snapshot_max_age_s`` old."""
        return self._dstep.ps_store is not None and (
            self._ps_vals is None or time.monotonic() - self._snap_t
            >= self.config.snapshot_max_age_s)

    def _snapshot(self, refresh: Optional[bool] = None):
        """The host-PS values feed of the next dispatch (``{}`` with no
        host-resident variable): the shared device snapshot, pulled again
        when ``refresh`` (the chief's decision; None decides here: once it
        is ``snapshot_max_age_s`` old). A failed refresh serves the last
        good snapshot within the degraded window, then sheds with
        :class:`ServingUnavailable`."""
        if self._dstep.ps_store is None:
            return {}
        if refresh is None:
            refresh = self._refresh_due()
        if not refresh and self._ps_vals is not None:
            return self._ps_vals
        try:
            vals = self._dstep.pull_ps()
        except (OSError, RuntimeError, TimeoutError) as e:
            # an unreachable service (CoordinationUnavailable is an
            # OSError), the store's used-up degraded window (RuntimeError)
            # or an owner that never published (TimeoutError)
            if (self._ps_vals is not None
                    and self._degraded_used < self._degraded_bound):
                self._degraded_used += 1
                self.stats["degraded"] += 1
                tel.counter_add("serve.degraded")
                tel.instant("serve.degraded_snapshot", "serve",
                            used=self._degraded_used,
                            bound=self._degraded_bound)
                logging.warning(
                    "serving: PS snapshot refresh failed (%s); serving "
                    "last snapshot (degraded batch %d/%d)", e,
                    self._degraded_used, self._degraded_bound)
                return self._ps_vals
            raise ServingUnavailable(
                "PS snapshot refresh failed and the degraded window "
                "(%d batches) is exhausted: %s"
                % (self._degraded_bound, e)) from e
        self._ps_vals = vals
        self._snap_t = time.monotonic()
        self._degraded_used = 0
        self.stats["snapshot_refreshes"] += 1
        return vals

    def warmup(self):
        """Run every bucket once on repeats of the example request (first
        kernel builds and allocator growth happen here, not on the first
        request). On a follower, nothing: the chief's warmup runs there
        through the loop."""
        if not self.chief:
            return self
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

    def _dispatch(self, host, refresh: Optional[bool], n: int, bucket: int,
                  to_host: bool):
        """The part of a dispatch every rank runs: this rank's rows of the
        padded bucket ``host`` (``n`` real requests in ``bucket`` rows)
        through the program; the fetches (whole per-example leaves) on the
        host, or on the device with ``to_host=False``."""
        with self._lock:
            if bucket > n:
                self.stats["padded_rows"] += bucket - n
                tel.counter_add("serve.padded_rows", bucket - n)
            t0 = time.perf_counter()
            with tel.span("serve.dispatch", "serve", n=n, bucket=bucket):
                try:
                    state = self._runner.state
                    if state is None:
                        raise RuntimeError(
                            "InferenceEngine over an uninitialized Runner "
                            "— call runner.init() first")
                    ps_vals = self._snapshot(refresh)
                    placed = self._runner.remapper.remap_feed(host)
                    out, error = self._program.local(state, ps_vals,
                                                     placed), None
                except Exception as e:  # noqa: BLE001 — agreed by the
                    # ranks in collect(), which raises it
                    out, error = None, e
                device_out = self._program.collect(out, error)
            t1 = time.perf_counter()
            with tel.span("serve.readback", "serve", n=n, bucket=bucket):
                fetched = (self._runner.remapper.remap_fetch(device_out)
                           if to_host else device_out)
            tel.hist_observe("serve.dispatch_ms", (t1 - t0) * 1e3)
            tel.hist_observe("serve.readback_ms",
                             (time.perf_counter() - t1) * 1e3)
            self.stats["batches"] += 1
        tel.counter_add("serve.batches")
        return fetched

    def _on_forward(self, payload):
        """A follower's part of the chief's :meth:`run_batch`."""
        self._dispatch(payload["host"], payload["refresh"], payload["n"],
                       payload["bucket"], to_host=False)

    def run_batch(self, requests, to_host: bool = True) -> Tuple[dict, int]:
        """Execute one request group: pad to the nearest bucket, run the
        program, mask the padded rows. Returns ``(fetches, n)`` with every
        per-example leaf sliced to the ``n`` real requests — as numpy on
        the host, or with ``to_host=False`` as tensors left on the device
        (the decode engine keeps prefilled caches there). At N > 1 only
        the chief calls it: it broadcasts the bucket, and every rank runs
        its rows."""
        if not self.chief:
            raise ValueError(
                "run_batch on a follower (rank %d): at N > 1 the chief "
                "dispatches and each follower's loop runs what it sends"
                % self._plane.rank)
        n = len(requests)
        bucket = self.bucket_for(n)
        host = stack_batches(list(requests), pad_to=bucket)
        if self._plane is None:
            fetched = self._dispatch(host, None, n, bucket, to_host)
        else:
            with self._plane.lock:
                fetched = self._plane.dispatch(
                    "forward", {"host": host, "n": n, "bucket": bucket,
                                "refresh": self._refresh_due()},
                    lambda p: self._dispatch(p["host"], p["refresh"], n,
                                             bucket, to_host))
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

    def follow(self, timeout: Optional[float] = None) -> bool:
        """On a follower: wait until the chief stops this engine's loop
        (True) or ``timeout`` passes (False). Elsewhere: True."""
        if self.chief:
            return True
        return self._plane.follow(timeout)

    def close(self, timeout: Optional[float] = 30.0):
        """At N > 1: the chief stops its followers' loops (idempotent; a
        later :meth:`run_batch` sheds); a follower waits up to ``timeout``
        for that. Nothing at one replica."""
        if self._owns_plane:
            self._plane.stop(timeout)
