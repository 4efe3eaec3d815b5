"""Runner — owns a DistributedStep and its state, and executes programs.

PyTorch counterpart of ``autodist_tpu/runtime/runner.py``. This slice of
the port carries the serving half: :meth:`Runner.init` places the
parameters on the device, :meth:`Runner.predict` runs a forward fetch
program, and the serving engines (``serving/``) drive the runner's
``distributed_step`` and ``remapper``. Training (``run``/``fit``/
``evaluate``) is the port's next slice.
"""
from typing import Optional

from autodist_tpu_torch.remapper import Remapper
from autodist_tpu_torch.train_state import TrainState

_TRAINING_SLICE = (
    "Runner.%s: the training step is not ported yet — it lands with the "
    "training slice of autodist_tpu_torch (ROADMAP.md queue A: the "
    "optimizer, the AllReduce step lowering and the backward kernels); "
    "this slice serves")


class Runner:
    """Owns a DistributedStep + TrainState and runs its programs."""

    def __init__(self, distributed_step):
        self._dstep = distributed_step
        self._remapper = Remapper(distributed_step.device)
        self.state: Optional[TrainState] = None

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
        (``{name: tensor or numpy}``)."""
        self.state = self._dstep.init_state(params, opt_state)
        return self.state

    def gather_params(self) -> dict:
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

    def run(self, batch, state: Optional[TrainState] = None, **kwargs):
        raise NotImplementedError(_TRAINING_SLICE % "run")

    def close(self):
        """Drop the device state (idempotent)."""
        self.state = None
