"""Distributed state (PyTorch counterpart of ``autodist_tpu/train_state.py``).

A plain dataclass: ``params`` maps each variable name to its float32
tensor on the runner's device; ``opt_state`` holds the optimizer's state
(``optim.OptimizerSpec.init``: a step count and per-variable moments on
the device; None when the runner was built without an optimizer);
``step`` counts optimizer applies (a checkpoint's step when restored);
``sync_state`` holds this rank's compressor states, ``{"bucket": {key:
tensor}, "var": {name: state}}`` with only the non-empty parts (the
error-feedback residuals of the int8 wire, for one), and is empty with
one replica, which syncs nothing.
"""
import dataclasses
from typing import Any


@dataclasses.dataclass
class TrainState:
    step: Any
    params: Any
    opt_state: Any
    sync_state: Any
