"""Distributed state (PyTorch counterpart of ``autodist_tpu/train_state.py``).

A plain dataclass: ``params`` maps each variable name to its float32
tensor on the runner's device; ``opt_state`` holds the optimizer's state
(``optim.OptimizerSpec.init``: a step count and per-variable moments on
the device; None when the runner was built without an optimizer);
``step`` counts optimizer applies; ``sync_state`` stays empty until the
port has synchronizers with state of their own.
"""
import dataclasses
from typing import Any


@dataclasses.dataclass
class TrainState:
    step: Any
    params: Any
    opt_state: Any
    sync_state: Any
