"""Compile-time program snapshots (the port of
``autodist_tpu/utils/visualization_util.py``).

Analog of reference ``autodist/utils/visualization_util.py:24-36``, which
writes the graph to TensorBoard event files at each transformation stage
(``0-original`` … ``3-transformed``). The port's "graph" of the user's
loss is the aten op listing of ``ModelItem.prepare``'s one fake-tensor
run (``model_item.trace_forward``): ``log_program`` writes it as text
under ``const.DEFAULT_SNAPSHOT_DIR/<run>/<stage>.txt``, gated by the
``ADT_SNAPSHOT`` env var. The lowering writes stage
``0-original-loss``, and the Runner's first step stage
``3-transformed-program``: the step recorded as a program
(``DistributedStep.snapshot_lowered``, ``kernel/lowering.py``).
"""
import os
import time

from autodist_tpu_torch import const
from autodist_tpu_torch.utils import logging

_RUN_DIR = None


def _run_dir() -> str:
    global _RUN_DIR
    if _RUN_DIR is None:
        _RUN_DIR = os.path.join(const.DEFAULT_SNAPSHOT_DIR,
                                time.strftime("%Y%m%d-%H%M%S"))
        os.makedirs(_RUN_DIR, exist_ok=True)
    return _RUN_DIR


def enabled() -> bool:
    return os.environ.get("ADT_SNAPSHOT", "") not in ("", "0")


def log_program(stage: str, text: str, force: bool = False):
    """Write one stage's program text; returns its path (None when
    snapshots are off and ``force`` is not given)."""
    if not (force or enabled()):
        return None
    path = os.path.join(_run_dir(), "%s.txt" % stage)
    with open(path, "w") as f:
        f.write(text)
    logging.debug("snapshot %s -> %s", stage, path)
    return path
