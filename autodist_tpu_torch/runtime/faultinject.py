"""Deterministic fault injection for the checkpoint plane.

PyTorch counterpart of the checkpoint part of
``autodist_tpu/runtime/faultinject.py`` (that module imports nothing of
JAX; the port keeps its own copy of this part). The coordination-wire
proxy and the gradient faults come with the control plane (ROADMAP A
item 8).
"""
import json
import os
import random
import signal
import threading
from typing import List, Optional

from autodist_tpu_torch import const
from autodist_tpu_torch.utils import logging

# ===================================================== checkpoint lifecycle
#
# Deterministic SIGKILLs at save-lifecycle phase points and post-commit
# file damage (truncation / bit flips), driven by a declarative plan
# through ``ADT_CKPT_FAULT_PLAN`` (the JAX package's grammar)::
#
#     {
#       "kills":  [{"phase": "meta", "nth": 3}],
#       "damage": [{"op": "bitflip",  "phase": "committed",
#                   "file": "shard-p0.npz", "nth": 1, "offset": -4096},
#                  {"op": "truncate", "phase": "committed",
#                   "file": "params.npz",  "nth": 1, "bytes": 64}]
#     }
#
# Phase points the savers call ``checkpoint_fault(phase, ...)`` at:
#
# - ``collect``   — state gathered to host, nothing on disk yet
# - ``write``     — data fully written to ``.tmp`` files, none replaced
# - ``index``     — shard npz replaced into place, index not yet written
#   (the JAX package's sharded saver only)
# - ``meta``      — all data + index files final, meta (the commit point)
#   not yet written
# - ``committed`` — meta replaced: the checkpoint is durable
#
# A ``kill`` rule delivers a real ``SIGKILL`` to this process at its
# phase's nth firing — no atexit, no flushing, the crash the atomic-write
# protocol must survive. A ``damage`` rule mutates the bytes of a matching
# file at its phase — ``committed`` models post-commit bit rot a restore
# must detect and fall back from; earlier phases model a filesystem that
# tore a write the checksums must catch.
#
# Matching is deterministic (as the JAX wire rules are): per-rule nth
# counters under one lock, no randomness unless ``prob`` is given — a
# probabilistic rule rolls against the plan-level rng (``"seed"`` key,
# default 0) once armed, and stays armed on a failed roll.


def truncate_file(path: str, keep_bytes: int):
    """Truncate ``path`` to its first ``keep_bytes`` bytes — the classic
    torn write (also usable directly from tests)."""
    with open(path, "r+b") as f:
        f.truncate(max(0, int(keep_bytes)))


def flip_bit(path: str, offset: int = -1):
    """XOR one bit at byte ``offset`` (negative = from the end; default
    flips a bit near the middle of the file) — silent single-bit rot."""
    size = os.path.getsize(path)
    if size == 0:
        return
    if offset == -1:
        offset = size // 2
    if offset < 0:
        offset = max(0, size + offset)
    offset = min(offset, size - 1)
    with open(path, "r+b") as f:
        f.seek(offset)
        byte = f.read(1)
        f.seek(offset)
        f.write(bytes([byte[0] ^ 0x01]))


def _kill_self():  # separated so tests can intercept the kill
    os.kill(os.getpid(), signal.SIGKILL)


class CkptFaultRule:
    """One checkpoint-lifecycle fault (kill or damage)."""

    def __init__(self, spec: dict, op: Optional[str] = None):
        self.op = op or spec.get("op")
        if self.op not in ("kill", "truncate", "bitflip"):
            raise ValueError("unknown checkpoint fault op %r" % self.op)
        self.phase = spec.get("phase", "committed" if self.op != "kill"
                              else "write")
        self.file = spec.get("file", "")
        self.nth = int(spec.get("nth", 1))
        self.repeat = bool(spec.get("repeat", False))
        self.bytes = int(spec.get("bytes", 0))
        self.offset = int(spec.get("offset", -1))
        self.prob = float(spec.get("prob", 1.0))
        self._matched = 0
        self._spent = False

    def should_fire(self, phase: str, rng: random.Random) -> bool:
        if self._spent or phase != self.phase:
            return False
        self._matched += 1
        if self._matched < self.nth:
            return False
        if self.prob < 1.0 and rng.random() >= self.prob:
            # stayed armed at the threshold: the next matching phase
            # point re-rolls (seeded rng — deterministic per plan)
            self._matched -= 1
            return False
        if self.repeat:
            self._matched = 0
        else:
            self._spent = True
        return True


class CheckpointFaultPlan:
    """Parsed ``ADT_CKPT_FAULT_PLAN`` — see the section comment above."""

    def __init__(self, spec: Optional[dict] = None):
        spec = spec or {}
        self.rules: List[CkptFaultRule] = (
            [CkptFaultRule(r, op="kill") for r in spec.get("kills", ())] +
            [CkptFaultRule(r) for r in spec.get("damage", ())])
        self.rng = random.Random(int(spec.get("seed", 0)))
        self.lock = threading.Lock()
        self.injected: List[str] = []

    @classmethod
    def from_env(cls) -> "CheckpointFaultPlan":
        raw = const.ENV.ADT_CKPT_FAULT_PLAN.val
        if not raw:
            return cls()
        if raw.startswith("@"):
            with open(raw[1:]) as f:
                raw = f.read()
        elif os.path.exists(raw):
            with open(raw) as f:
                raw = f.read()
        return cls(json.loads(raw))

    def _targets(self, rule: CkptFaultRule, path: Optional[str]) -> List[str]:
        """Files a damage rule applies to at this phase point. ``path`` is
        either one concrete file or a checkpoint base (``.../ckpt-N``)
        whose sibling files are matched by the rule's ``file`` substring."""
        if path is None:
            return []
        if os.path.isfile(path):
            return [path] if rule.file in os.path.basename(path) else []
        directory, base = os.path.dirname(path), os.path.basename(path)
        try:
            names = os.listdir(directory)
        except OSError:
            return []
        return [os.path.join(directory, f) for f in sorted(names)
                if f.startswith(base + ".") and rule.file and rule.file in f]

    def fire(self, phase: str, path: Optional[str] = None,
             step: Optional[int] = None):
        with self.lock:
            fired = [r for r in self.rules if r.should_fire(phase, self.rng)]
        for rule in fired:
            if rule.op == "kill":
                logging.warning(
                    "faultinject: SIGKILL at checkpoint phase %r (step %s)",
                    phase, step)
                for h in logging.get_logger().handlers:
                    h.flush()  # SIGKILL gives no atexit: flush by hand
                self.injected.append("kill:%s" % phase)
                _kill_self()
                continue  # only reached when _kill_self is intercepted
            for target in self._targets(rule, path):
                logging.warning("faultinject: %s on %s at phase %r",
                                rule.op, target, phase)
                if rule.op == "truncate":
                    truncate_file(target, rule.bytes)
                else:
                    flip_bit(target, rule.offset)
                self.injected.append("%s:%s" % (rule.op,
                                                os.path.basename(target)))


_ckpt_plan_lock = threading.Lock()
_ckpt_plan: Optional[CheckpointFaultPlan] = None
_ckpt_plan_raw: Optional[str] = None


def checkpoint_fault(phase: str, path: Optional[str] = None,
                     step: Optional[int] = None):
    """Phase hook the checkpoint savers call at every lifecycle point.
    A no-op (one env read) unless ``ADT_CKPT_FAULT_PLAN`` is set; the
    plan is parsed once and re-parsed only when the env value changes
    (tests swap plans in-process)."""
    global _ckpt_plan, _ckpt_plan_raw
    raw = const.ENV.ADT_CKPT_FAULT_PLAN.val
    if not raw:
        return
    with _ckpt_plan_lock:
        if raw != _ckpt_plan_raw:
            _ckpt_plan = CheckpointFaultPlan.from_env()
            _ckpt_plan_raw = raw
        plan = _ckpt_plan
    plan.fire(phase, path=path, step=step)
