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
``init`` under ``ADT_AUTO_RESUME``. The JAX runner's fused supersteps,
sentinel, elastic and preemption planes belong to later slices of the
port.
"""
import itertools
import statistics
import time
from typing import Any, Optional

import numpy as np
from torch.utils import _pytree as pytree

from autodist_tpu_torch import const
from autodist_tpu_torch.remapper import Remapper
from autodist_tpu_torch.telemetry import spans as tel
from autodist_tpu_torch.train_state import TrainState
from autodist_tpu_torch.utils import logging


class MetricsHandle:
    """Device-resident step metrics from ``Runner.run(sync=False)``: the
    step returned as soon as its work was queued, and the device-to-host
    copy waits until :meth:`result` (or any mapping access, such as
    ``handle["loss"]``), so a loop of steps need not wait on the device
    between them."""

    __slots__ = ("_device", "_remapper", "_host", "microsteps")

    def __init__(self, device_metrics, remapper, microsteps: int = 1):
        self._device = device_metrics
        self._remapper = remapper
        self._host = None
        self.microsteps = microsteps

    @property
    def materialized(self) -> bool:
        return self._host is not None

    def result(self):
        """Host metrics (forces the device-to-host copy on first call)."""
        if self._host is None:
            with tel.span("runner.readback", "runner",
                          microsteps=self.microsteps):
                self._host = self._remapper.remap_fetch(self._device)
            self._device = None
            tel.counter_add("runner.readbacks")
            tel.counter_add("runner.d2h_bytes", sum(
                getattr(leaf, "nbytes", 0)
                for leaf in pytree.tree_leaves(self._host)))
        return self._host

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
        # _step_count counts optimizer applies (microsteps); with no fused
        # supersteps in the port, each run() is one of each
        self._step_count = 0
        self._superstep_count = 0
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
            handle = MetricsHandle(metrics, self._remapper)
            out = handle.result() if sync else handle
            self._record_step_time(t_begin)
            return (new_state, out) if state is not None else out

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
        its own), with the JAX runner's keys: ``first_step_s`` (first-use
        kernel builds included), the ``steady_*`` percentiles over recent
        steps, ``goodput`` (the share of total stepping time the steps
        would have needed at the steady median) and ``telemetry``
        counters. The shape is stable: ``steady_*``/``goodput`` are None
        before a second step."""
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
        }
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
        raises. Returns the per-step host metrics. The fused engine
        (``fuse_steps``, ``metrics_every``) is ROADMAP A item 6."""
        if fuse_steps != 1 or metrics_every != 1:
            raise NotImplementedError(
                "fit(fuse_steps=%d, metrics_every=%d): fused supersteps are "
                "not ported yet (ROADMAP A item 6)"
                % (fuse_steps, metrics_every))
        if save_every > 0 and saver is None:
            from autodist_tpu_torch.checkpoint.saver import Saver
            saver = Saver(directory=const.ENV.ADT_CKPT_DIR.val,
                          async_save=True)
        history = []
        bounded = batches if steps is None else itertools.islice(batches,
                                                                 steps)
        with tel.span("runner.fit", "runner", save_every=save_every):
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

    def evaluate(self, batches, steps: Optional[int] = None) -> dict:
        """Example-weighted mean of the scalar metrics over an iterable of
        host batches, without updating parameters: the forward-only
        program, no grads, no optimizer. Each batch weighs its example
        count (the leading dim of its first array leaf, 1 if none).
        Non-scalar metrics are skipped (warned once)."""
        if self.state is None:
            raise RuntimeError("Runner.evaluate before init()")
        totals, weight, skipped = {}, 0.0, set()
        bounded = batches if steps is None else itertools.islice(batches,
                                                                 steps)
        for batch in bounded:
            n = self._batch_examples(batch)
            placed = self._remapper.remap_feed(batch)
            host = self._remapper.remap_fetch(
                self._dstep.evaluate(self.state, placed))
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
        """Drop the device state (idempotent)."""
        self.state = None
