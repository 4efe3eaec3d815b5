"""Runner — owns a DistributedStep and its state, and executes programs.

PyTorch counterpart of ``autodist_tpu/runtime/runner.py``, one runner a
replica (a process of the ``torch.distributed`` group, or the process
alone): :meth:`Runner.init` places the parameters and the optimizer state
on the device, equal in every replica; :meth:`Runner.run` takes one
training step on the host-global batch, of which each replica trains on
its own rows, and returns the metrics averaged over the replicas, the
same on every rank;
:meth:`Runner.fit` and :meth:`Runner.evaluate` loop over batches;
:meth:`Runner.step_stats` reports step wall times; :meth:`Runner.predict`
runs a forward fetch program, and the serving engines (``serving/``)
drive the runner's ``distributed_step`` and ``remapper``. Checkpoints
(``checkpoint/``) are written by ``fit(save_every=...)`` and restored by
``init`` under ``ADT_AUTO_RESUME``. :meth:`Runner.run_superstep` and
``fit(fuse_steps=k, metrics_every=n)`` run fused supersteps of k
microsteps, one dispatch each (on ``cuda``, one replay of a CUDA graph:
``kernel/superstep.py``), with the metrics read back every n supersteps.
:class:`WrappedSession` is the session facade
``AutoDist.create_distributed_session`` returns. The JAX runner's
sentinel, elastic and preemption planes belong to later slices of the
port.
"""
import itertools
import statistics
import time
from typing import Any, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from autodist_tpu_torch import const
from autodist_tpu_torch.remapper import Remapper
from autodist_tpu_torch.telemetry import spans as tel
from autodist_tpu_torch.train_state import TrainState
from autodist_tpu_torch.utils import logging


class MetricsHandle:
    """Device-resident step metrics from ``Runner.run(sync=False)`` or
    ``Runner.run_superstep``: the step returned as soon as its work was
    queued, and the device-to-host copy waits until :meth:`result` (or
    any mapping access, such as ``handle["loss"]``), so a loop of steps
    need not wait on the device between them, and one readback at a
    ``metrics_every`` boundary materializes many steps' metrics."""

    __slots__ = ("_device", "_remapper", "_host", "microsteps", "_owner")

    def __init__(self, device_metrics, remapper, microsteps: int = 1,
                 owner=None):
        self._device = device_metrics
        self._remapper = remapper
        self._host = None
        self.microsteps = microsteps
        # the Runner whose ``readbacks`` count this handle's readback
        self._owner = owner

    @property
    def materialized(self) -> bool:
        return self._host is not None

    def result(self):
        """Host metrics (forces the device-to-host copy on first call).
        Superstep handles return stacked ``[k, ...]`` leaves."""
        if self._host is None:
            with tel.span("runner.readback", "runner",
                          microsteps=self.microsteps):
                self._host = self._remapper.remap_fetch(self._device)
            self._device = None
            if self._owner is not None:
                self._owner.readbacks += 1
            tel.counter_add("runner.readbacks")
            tel.counter_add("runner.d2h_bytes", sum(
                getattr(leaf, "nbytes", 0)
                for leaf in pytree.tree_leaves(self._host)))
        return self._host

    @staticmethod
    def concat(handles: list) -> "MetricsHandle":
        """One handle over consecutive unread handles of one runner: their
        device metrics concatenated along the microstep dim, on the
        device, so that reading them back is one device-to-host copy.
        Handles whose metrics cannot be concatenated so (a host value
        among them, another structure) come back as they are, in a
        list."""
        if len(handles) == 1:
            return handles[0]
        trees, spec = [], None
        for h in handles:
            leaves, sp = pytree.tree_flatten(h._device)
            if h.materialized or (spec is not None and sp != spec) or \
                    not all(isinstance(t, torch.Tensor) for t in leaves):
                return handles
            spec = sp
            trees.append(leaves if h.microsteps > 1
                         else [t[None] for t in leaves])
        cat = [torch.cat(parts) for parts in zip(*trees)]
        return MetricsHandle(pytree.tree_unflatten(cat, spec),
                             handles[0]._remapper,
                             sum(h.microsteps for h in handles),
                             handles[0]._owner)

    def unstack(self) -> list:
        """Per-microstep host metrics: ``microsteps`` dicts of unstacked
        leaves (a length-1 list for a plain step's handle)."""
        host = self.result()
        if self.microsteps == 1:
            return [host]
        return [pytree.tree_map(lambda a, i=i: np.asarray(a)[i], host)
                for i in range(self.microsteps)]

    def __getitem__(self, key):
        return self.result()[key]

    def __iter__(self):
        return iter(self.result())

    def keys(self):
        return self.result().keys()

    def items(self):
        return self.result().items()

    def __repr__(self):
        return "MetricsHandle(microsteps=%d, %s)" % (
            self.microsteps,
            "materialized" if self.materialized else "device-resident")


class Runner:
    """Owns a DistributedStep + TrainState and runs its programs."""

    # recent per-step wall times kept for the steady_* percentiles
    _RECENT_WINDOW = 1024

    def __init__(self, distributed_step):
        self._dstep = distributed_step
        self._remapper = Remapper(distributed_step.device,
                                  distributed_step.replica_info)
        self.state: Optional[TrainState] = None
        # _step_count counts optimizer applies (microsteps), the
        # superstep count dispatches: a run() is one of each, a fused
        # superstep k microsteps in one dispatch
        self._step_count = 0
        self._superstep_count = 0
        # device-to-host metric readbacks of this runner's steps
        self.readbacks = 0
        self._total_step_s = 0.0
        self._first_step_s: Optional[float] = None
        self._recent_step_s: list = []

    @property
    def distributed_step(self):
        return self._dstep

    @property
    def remapper(self):
        return self._remapper

    @property
    def device(self):
        return self._dstep.device

    def init(self, params, opt_state=None) -> TrainState:
        """Initialize the state on the device from ``params``
        (``{name: tensor or numpy}``). With more than one replica every
        rank calls it, and every replica starts from rank 0's values.

        Under ``ADT_AUTO_RESUME`` the newest valid checkpoint in
        ``ADT_CKPT_DIR`` (one either package wrote) is restored instead:
        torn and damaged steps are skipped (``latest_checkpoint``), and the
        restore falls back further if damage only shows while reading.
        With no valid checkpoint one replica warns and starts fresh; more
        than one raise, since peers restoring different steps would
        diverge."""
        if const.ENV.ADT_AUTO_RESUME.val:
            from autodist_tpu_torch.checkpoint import latest_checkpoint
            directory = const.ENV.ADT_CKPT_DIR.val
            _, saver = latest_checkpoint(directory)
            problem = "no valid checkpoint in %s" % directory
            if saver is not None:
                try:
                    _, step = saver.restore(self)
                except FileNotFoundError as e:
                    # every candidate was skipped as torn/corrupt
                    problem = str(e)
                else:
                    logging.warning("ADT_AUTO_RESUME: restored step %d "
                                    "from %s", step, directory)
                    return self.state
            if self._dstep.num_replicas > 1:
                raise RuntimeError(
                    "ADT_AUTO_RESUME: %s on this process — peers restoring "
                    "different steps would diverge, refusing to start "
                    "fresh (`python -m autodist_tpu_torch.checkpoint ls "
                    "--dir %s` inspects it)" % (problem, directory))
            logging.warning("ADT_AUTO_RESUME: %s; starting fresh", problem)
        self.state = self._dstep.init_state(params, opt_state)
        return self.state

    def gather_params(self) -> dict:
        """The full params in their original names: this replica's, which
        equal every other replica's."""
        if self.state is None:
            raise RuntimeError("Runner.gather_params before init()")
        return self._dstep.gather_params(self.state)

    def predict(self, batch, serve_fn, ps_vals=None) -> dict:
        """One-shot forward-only inference on a host batch: run
        ``serve_fn(params, batch)`` through the fetch program and return
        its outputs on the host as numpy. Sustained traffic wants the
        serving engines (``autodist_tpu_torch/serving/``)."""
        if self.state is None:
            raise RuntimeError("Runner.predict before init()")
        program = self._dstep.predict_program(serve_fn, donate_batch=False,
                                              example_batch=batch)
        if ps_vals is None:
            ps_vals = self._dstep.pull_ps()
        placed = self._remapper.remap_feed(batch)
        return self._remapper.remap_fetch(program(self.state, ps_vals,
                                                  placed))

    def run(self, batch, state: Optional[TrainState] = None,
            sync: bool = True) -> Any:
        """One training step on a host batch, the global one: with N
        replicas each rank trains on its N-th of the rows and every rank
        gets the same metrics. ``sync=True`` (default)
        returns host metrics, paying one device-to-host copy a step.
        ``sync=False`` returns a :class:`MetricsHandle` that copies them
        when read; the step's wall time then measures its dispatch, not
        its execution. With ``state`` given, that state is stepped without
        being modified and ``(new_state, metrics)`` is returned."""
        t_begin = time.perf_counter()
        st = state if state is not None else self.state
        if st is None:
            raise RuntimeError("Runner.run before init()")
        with tel.span("runner.dispatch", "runner", microsteps=1, sync=sync,
                      step=self._step_count):
            with tel.span("runner.feed", "runner"):
                placed = self._remapper.remap_feed(batch)
            new_state, metrics = self._dstep(st, placed,
                                             donate=state is None)
            if state is None:
                self.state = new_state
            self._step_count += 1
            self._superstep_count += 1
            tel.counter_add("runner.steps")
            tel.counter_add("runner.supersteps")
            self._maybe_check_mirrors()
            handle = MetricsHandle(metrics, self._remapper, owner=self)
            out = handle.result() if sync else handle
            self._record_step_time(t_begin)
            return (new_state, out) if state is not None else out

    def run_superstep(self, stacked_batch, sync: bool = False):
        """One FUSED superstep: k microsteps (k = the stacked feed's
        leading dim) in a single dispatch (``DistributedStep.run_multi``;
        on ``cuda`` one replay of a CUDA graph), the optimizer applied k
        times on the device; the metrics come back stacked ``[k, ...]`` in
        a lazily materialized :class:`MetricsHandle` (``sync=True`` reads
        them back before returning)."""
        t_begin = time.perf_counter()
        if self.state is None:
            raise RuntimeError("Runner.run_superstep before init()")
        with tel.span("runner.feed", "runner", stacked=True):
            placed = self._remapper.remap_feed_stack(stacked_batch)
        leaves = pytree.tree_leaves(placed)
        k = int(np.shape(leaves[0])[0]) if leaves else 1
        with tel.span("runner.dispatch", "runner", microsteps=k, sync=sync,
                      step=self._step_count):
            self.state, metrics = self._dstep.run_multi(self.state, placed)
            self._step_count += k
            self._superstep_count += 1
            tel.counter_add("runner.steps", k)
            tel.counter_add("runner.supersteps")
            handle = MetricsHandle(metrics, self._remapper, microsteps=k,
                                   owner=self)
            out = handle.result() if sync else handle
            self._record_step_time(t_begin)
            return out

    def _maybe_check_mirrors(self):
        """Sync host PS keeps every rank's mirror of the store bit-equal
        by determinism; every ``ADT_PS_MIRROR_CHECK_EVERY`` steps (0 =
        off) the ranks compare an md5 of their mirrors (after the
        in-flight push lands) and fail fast on a divergence. The JAX
        runner compares them through the coordination service; the port
        all-gathers them on the default group (16 bytes a rank, on the
        runner's device), a collective every rank reaches at the same
        step."""
        every = const.ENV.ADT_PS_MIRROR_CHECK_EVERY.val
        store = self._dstep.ps_store
        n = self._dstep.num_replicas
        if (every <= 0 or store is None or n < 2
                or self._step_count % every != 0):
            return
        import torch.distributed as dist
        self._dstep.flush_ps()
        mine = torch.tensor(list(bytes.fromhex(store.mirror_digest())),
                            dtype=torch.uint8, device=self.device)
        parts = [torch.empty_like(mine) for _ in range(n)]
        dist.all_gather(parts, mine)
        digests = [bytes(p.cpu().tolist()).hex() for p in parts]
        tel.counter_add("ps.mirror_checks")
        if len(set(digests)) != 1:
            raise RuntimeError(
                "PS mirror divergence at step %d: the ranks' digests are %s"
                % (self._step_count, digests))

    def _record_step_time(self, t_begin: float):
        elapsed = time.perf_counter() - t_begin
        self._total_step_s += elapsed
        if self._first_step_s is None:
            self._first_step_s = elapsed   # includes the kernels' builds
        else:
            self._recent_step_s.append(elapsed)
            if len(self._recent_step_s) > self._RECENT_WINDOW:
                del self._recent_step_s[:len(self._recent_step_s) // 2]

    def step_stats(self) -> dict:
        """Wall-time statistics over this runner's steps (each rank times
        its own), with the JAX runner's keys: ``steps`` and
        ``microsteps`` (optimizer applies), ``supersteps`` (dispatches: a
        fused superstep of k microsteps is one), ``first_step_s``
        (first-use kernel builds and a first capture included), the
        ``steady_*`` percentiles over recent dispatches, ``goodput`` (the
        share of total stepping time the dispatches would have needed at
        the steady median) and ``telemetry`` counters. The shape is
        stable: ``steady_*``/``goodput`` are None before a second
        dispatch."""
        micro, sup = self._step_count, self._superstep_count
        out = {"steps": micro, "supersteps": sup, "microsteps": micro,
               "total_s": round(self._total_step_s, 6),
               "first_step_s": (round(self._first_step_s, 6)
                                if self._first_step_s is not None else None),
               "steady_median_s": None, "steady_p10_s": None,
               "steady_p90_s": None, "goodput": None}
        recent = self._recent_step_s
        if recent:
            qs = (statistics.quantiles(recent, n=10, method="inclusive")
                  if len(recent) >= 2 else [recent[0]] * 9)
            med = statistics.median(recent)
            out.update(steady_median_s=round(med, 6),
                       steady_p10_s=round(qs[0], 6),
                       steady_p90_s=round(qs[-1], 6),
                       goodput=round(min(1.0, med * sup
                                         / self._total_step_s), 4))
        c = tel.counters()
        out["telemetry"] = {
            "dispatches": c.get("dstep.dispatches", 0.0),
            "readbacks": c.get("runner.readbacks", 0.0),
            "d2h_bytes": c.get("runner.d2h_bytes", 0.0),
            "ps_bytes_pulled": c.get("ps.bytes_pulled", 0.0),
            "ps_bytes_pushed": c.get("ps.bytes_pushed", 0.0),
        }
        # the host-PS wire and apply, from the spans (recorded while
        # tracing is on, ADT_TRACE): count and total seconds of each
        spans = tel.get_recorder().summary() if tel.tracing_enabled() \
            else {}
        out["ps_spans"] = {
            name: {"count": int(spans.get(name, {}).get("count", 0)),
                   "total_s": round(spans.get(name, {}).get("total_s", 0.0),
                                    6)}
            for name in ("ps.pull", "ps.push", "ps.apply")}
        return out

    def fit(self, batches, steps: Optional[int] = None,
            callbacks: Optional[list] = None, save_every: int = 0,
            saver=None, fuse_steps: int = 1, metrics_every: int = 1) -> list:
        """Train over an iterable of host batches, one :meth:`run` each;
        ``steps`` bounds an endless iterable without consuming a batch past
        the bound, ``callbacks`` are called as ``cb(step_index, metrics)``.
        ``save_every=N`` checkpoints every N steps, and once at the end
        when the last window was partial, through ``saver`` — by default
        an async :class:`~autodist_tpu_torch.checkpoint.saver.Saver` on
        ``ADT_CKPT_DIR``, which ``ADT_AUTO_RESUME`` resumes from. A pending
        write is joined before ``fit`` returns or raises, and a failed one
        raises. Returns the per-step host metrics.

        ``fuse_steps=k > 1`` runs fused supersteps: k consecutive batches
        stacked into one ``[k, ...]`` feed (or taken pre-stacked from a
        ``DevicePrefetcher(..., stack=k)``) and run as one dispatch
        (:meth:`run_superstep`). ``metrics_every=n`` reads the metrics
        back every n supersteps only, with no device-to-host copy between
        those boundaries. The history stays one entry a microstep;
        callbacks fire a microstep at a time, at the readback boundaries
        only (their values exact, their timing deferred). ``save_every``
        rounds up to the next superstep boundary (a save cannot split a
        superstep). When ``fit`` does the stacking, a trailing group
        smaller than k runs per step, so every batch trains; a
        pre-stacked source cannot be split, and a ``steps`` bound that is
        not a multiple of k stops at the last whole superstep."""
        with tel.span("runner.fit", "runner", fuse_steps=fuse_steps,
                      metrics_every=metrics_every, save_every=save_every):
            return self._fit(batches, steps, callbacks, save_every, saver,
                             fuse_steps, metrics_every)

    def _fit(self, batches, steps, callbacks, save_every, saver,
             fuse_steps, metrics_every) -> list:
        src_k = getattr(batches, "stack_k", 1)
        if src_k != 1 and src_k != max(1, fuse_steps):
            # a stacked source feeding another k would split the [k] dim
            # over the replicas, or stack a stacked feed again
            raise ValueError(
                "fit(fuse_steps=%d) fed a source pre-stacked with stack=%d"
                " — the stacks must match (DevicePrefetcher(stack=k) pairs"
                " with fit(fuse_steps=k))" % (fuse_steps, src_k))
        if fuse_steps > 1:
            # the fused program's refusals (host-PS variables; N > 1 on
            # cuda), before any step runs
            self._dstep.multi_step(fuse_steps)
        if save_every > 0 and saver is None:
            from autodist_tpu_torch.checkpoint.saver import Saver
            saver = Saver(directory=const.ENV.ADT_CKPT_DIR.val,
                          async_save=True)
        if fuse_steps > 1 or metrics_every > 1:
            return self._fit_pipelined(batches, steps, callbacks, save_every,
                                       saver, max(1, fuse_steps),
                                       max(1, metrics_every))
        history = []
        bounded = batches if steps is None else itertools.islice(batches,
                                                                 steps)
        try:
            for i, batch in enumerate(bounded):
                metrics = self.run(batch)
                history.append(metrics)
                for cb in (callbacks or ()):
                    cb(i, metrics)
                if save_every > 0 and (i + 1) % save_every == 0:
                    saver.save(self)
            if save_every > 0 and history and \
                    len(history) % save_every != 0:
                saver.save(self)  # the final partial window
        finally:
            # a failed async write must surface, on every exit path
            if saver is not None:
                saver.wait()
        return history

    def _fit_pipelined(self, batches, steps, callbacks, save_every, saver,
                       k: int, metrics_every: int) -> list:
        """The fused / async driver behind ``fit(fuse_steps=k,
        metrics_every=n)``: supersteps dispatch with ``sync=False`` and
        their :class:`MetricsHandle`\\ s wait on the device; one readback
        every n supersteps (and one at the end), of their metrics
        concatenated on the device (:meth:`MetricsHandle.concat`),
        materializes them into the per-microstep history."""
        history: list = []
        pending: list = []   # handles not read back yet, in step order

        def materialize():
            # one readback for the whole window: the pending handles'
            # metrics concatenated on the device
            merged = MetricsHandle.concat(pending) if pending else []
            pending[:] = merged if isinstance(merged, list) else [merged]
            # pop each handle before its callbacks fire: a callback that
            # raises must not leave it queued to fire again
            while pending:
                handle = pending.pop(0)
                for m in handle.unstack():
                    idx = len(history)
                    history.append(m)
                    for cb in (callbacks or ()):
                        cb(idx, m)

        # a DevicePrefetcher in matching stack mode yields stacked,
        # placed [k, ...] feeds, consumed whole; any other source yields
        # plain batches, grouped and stacked here
        pre_stacked = k > 1 and getattr(batches, "stack_k", 1) == k
        it = iter(batches)
        micro_done, last_save, supersteps = 0, 0, 0
        try:
            while steps is None or micro_done < steps:
                if pre_stacked:
                    if steps is not None and micro_done + k > steps:
                        logging.warning(
                            "fit: steps=%d is not a multiple of "
                            "fuse_steps=%d on a pre-stacked source; "
                            "stopping at %d microsteps", steps, k, micro_done)
                        break
                    try:
                        stacked = next(it)
                    except StopIteration:
                        break
                    handles = [self.run_superstep(stacked, sync=False)]
                else:
                    group = []
                    while len(group) < k and (steps is None or micro_done
                                              + len(group) < steps):
                        try:
                            group.append(next(it))
                        except StopIteration:
                            break
                    if not group:
                        break
                    if len(group) == k and k > 1:
                        from autodist_tpu_torch.data.prefetch import \
                            stack_batches
                        handles = [self.run_superstep(stack_batches(group),
                                                      sync=False)]
                    else:
                        # a trailing partial group: per step, still async
                        handles = [self.run(b, sync=False) for b in group]
                pending.extend(handles)
                micro_done += sum(h.microsteps for h in handles)
                supersteps += 1
                if supersteps % metrics_every == 0:
                    materialize()
                if save_every > 0 and micro_done - last_save >= save_every:
                    # rounded up to the superstep boundary: the save holds
                    # every microstep dispatched so far
                    saver.save(self)
                    last_save = micro_done
            materialize()
            if save_every > 0 and micro_done > last_save:
                saver.save(self)  # the final partial window
        finally:
            # no materialize here: on an exception path the history goes
            # with the raise, and callbacks must not fire after one of
            # them (or the step) failed; pending handles drop their
            # device buffers
            del pending[:]
            if saver is not None:
                saver.wait()
        return history

    def evaluate(self, batches, steps: Optional[int] = None) -> dict:
        """Example-weighted mean of the scalar metrics over an iterable of
        host batches, without updating parameters: the forward-only
        program, no grads, no optimizer. Each batch weighs its example
        count (the leading dim of its first array leaf, 1 if none).
        Non-scalar metrics are skipped (warned once)."""
        if self.state is None:
            raise RuntimeError("Runner.evaluate before init()")
        totals, weight, skipped = {}, 0.0, set()
        # one host-PS pull for the whole loop: no push happens between
        # eval batches, so the values cannot change
        ps_vals = self._dstep.pull_ps()
        bounded = batches if steps is None else itertools.islice(batches,
                                                                 steps)
        for batch in bounded:
            n = self._batch_examples(batch)
            placed = self._remapper.remap_feed(batch)
            host = self._remapper.remap_fetch(
                self._dstep.evaluate(self.state, placed, ps_vals=ps_vals))
            for k, v in host.items():
                if np.ndim(v) == 0:
                    totals[k] = totals.get(k, 0.0) + float(v) * n
                elif k not in skipped:
                    skipped.add(k)
                    logging.warning("evaluate: skipping non-scalar metric "
                                    "%r (shape %s)", k, np.shape(v))
            weight += n
        if weight == 0.0:
            return {}
        return {k: v / weight for k, v in totals.items()}

    @staticmethod
    def _batch_examples(batch) -> int:
        for leaf in pytree.tree_leaves(batch):
            shape = np.shape(leaf)
            if len(shape) >= 1:
                return int(shape[0])
        return 1

    def close(self):
        """Drop the device state and the captured supersteps, and land the
        in-flight PS push and stop the store's threads (idempotent)."""
        self.state = None
        self._dstep.close()


class WrappedSession:
    """Thin session facade over a :class:`Runner` for reference-style
    ``session.run(feed)`` loops (``AutoDist.create_distributed_session``)."""

    def __init__(self, runner: Runner):
        self._runner = runner

    def run(self, feed_dict=None, **kwargs):
        batch = feed_dict if feed_dict is not None else kwargs
        return self._runner.run(batch)

    def fit(self, batches, steps=None, callbacks=None, save_every=0,
            saver=None, fuse_steps=1, metrics_every=1):
        return self._runner.fit(batches, steps=steps, callbacks=callbacks,
                                save_every=save_every, saver=saver,
                                fuse_steps=fuse_steps,
                                metrics_every=metrics_every)

    def evaluate(self, batches, steps=None):
        return self._runner.evaluate(batches, steps=steps)

    def predict(self, feed_dict, serve_fn, ps_vals=None):
        """Forward-only fetches for one fed batch (``Runner.predict``)."""
        return self._runner.predict(feed_dict, serve_fn, ps_vals=ps_vals)

    @property
    def state(self):
        return self._runner.state

    def gather_params(self):
        return self._runner.gather_params()
