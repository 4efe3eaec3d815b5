"""Distributed state (PyTorch counterpart of ``autodist_tpu/train_state.py``).

A plain dataclass: ``params`` maps each variable name to its tensor on the
runner's device; ``opt_state`` and ``sync_state`` stay empty until the
training slice ports the optimizer and the synchronizers.
"""
import dataclasses
from typing import Any


@dataclasses.dataclass
class TrainState:
    step: Any
    params: Any
    opt_state: Any
    sync_state: Any
