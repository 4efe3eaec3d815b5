"""Deterministic fault injection for the checkpoint plane and the
gradients.

PyTorch counterpart of the checkpoint and gradient parts of
``autodist_tpu/runtime/faultinject.py`` (that module's checkpoint part
imports nothing of JAX; the port keeps its own copy of it, and writes the
gradient faults over torch tensors). The coordination-wire proxy comes
with the control plane (ROADMAP A item 8.3b).
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
#   (the sharded savers only)
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


# ======================================================== gradient faults
#
# Silent-data-corruption chaos for the training health sentinel
# (``runtime/sentinel.py``): deterministic, step-keyed corruption of a
# named variable's LOCAL gradient, applied inside the step before the
# gradient sync, so NaN spreads through the all-reduce exactly as a real
# on-device fault would. The plan comes from ``ADT_GRAD_FAULT_PLAN``
# (inline JSON, ``@/path``, or a path)::
#
#     {"faults": [
#         {"var": "dense/kernel", "mode": "nan",     "step": 3},
#         {"var": "dense/bias",   "mode": "inf",     "step": 5,
#          "until": 40, "every": 2},
#         {"var": "embed",        "mode": "bitflip", "step": 7,
#          "bit": 30, "index": 0},
#         {"var": "dense/kernel", "mode": "scale",   "step": 9,
#          "factor": 1e6}
#     ]}
#
# The injection reads the step from a tensor on the device (the step
# keeps it, ``DistributedStep._step_t``), so it is the same at every
# step, inside a captured superstep (a CUDA graph) and on replay after a
# rollback, with no read back to the host.
#
# Rule fields: ``var`` (exact variable name, required), ``mode`` in
# ``nan | inf | bitflip | scale``, ``step`` (0-based TrainState step the
# fault arms at), ``until`` (inclusive last step; default = ``step``, so
# a bare rule is a one-step transient), ``every`` (within [step, until]
# fire only when (step - rule.step) % every == 0), ``factor`` (scale
# mode, default 1e6), ``bit``/``index`` (bitflip mode: XOR bit ``bit`` of
# the flat element at ``index``; bit 30 flips a float32 exponent MSB —
# the classic silent-data-corruption blowup).


class GradFaultRule:
    """One declarative gradient fault (see the section comment above).

    Unknown fields are REJECTED, not ignored: the wire/ckpt grammars'
    ``nth``/``repeat``/``prob`` knobs do not exist here (injection is
    keyed on the step counter, with no runtime roll), and a silently
    dropped field would make the chaos run test something other than
    what the plan declares."""

    _MODES = ("nan", "inf", "bitflip", "scale")
    _FIELDS = frozenset(("var", "mode", "step", "until", "every",
                         "factor", "bit", "index"))

    def __init__(self, spec: dict):
        unknown = sorted(set(spec) - self._FIELDS)
        if unknown:
            raise ValueError(
                "unknown gradient fault field(s) %s — the grad plan is "
                "step-keyed (fields: %s); nth/repeat/prob belong to the "
                "wire/checkpoint plans (docs/failure_model.md)"
                % (unknown, ", ".join(sorted(self._FIELDS))))
        self.var = spec["var"]
        self.mode = spec.get("mode", "nan")
        if self.mode not in self._MODES:
            raise ValueError("unknown gradient fault mode %r (one of %s)"
                             % (self.mode, ", ".join(self._MODES)))
        self.step = int(spec.get("step", 0))
        self.until = int(spec.get("until", self.step))
        if self.until < self.step:
            raise ValueError("gradient fault until=%d precedes step=%d"
                             % (self.until, self.step))
        self.every = max(1, int(spec.get("every", 1)))
        self.factor = float(spec.get("factor", 1e6))
        self.bit = int(spec.get("bit", 30))
        self.index = int(spec.get("index", 0))

    def describe(self) -> str:
        window = ("step %d" % self.step if self.until == self.step
                  else "steps %d..%d/%d" % (self.step, self.until,
                                            self.every))
        return "%s(%s @ %s)" % (self.mode, self.var, window)


class GradFaultPlan:
    """Parsed ``ADT_GRAD_FAULT_PLAN``, read by ``GraphTransformer`` when
    it builds the step. A top-level ``seed`` is tolerated for symmetry
    with the other grammars but means nothing: the injection is fully
    deterministic (step-keyed, no rng)."""

    def __init__(self, spec: Optional[dict] = None):
        spec = spec or {}
        self.rules: List[GradFaultRule] = [GradFaultRule(r)
                                           for r in spec.get("faults", ())]

    @classmethod
    def from_env(cls) -> "GradFaultPlan":
        raw = const.ENV.ADT_GRAD_FAULT_PLAN.val
        if not raw:
            return cls()
        if raw.startswith("@"):
            with open(raw[1:]) as f:
                raw = f.read()
        elif os.path.exists(raw):
            with open(raw) as f:
                raw = f.read()
        return cls(json.loads(raw))

    def describe(self) -> str:
        return ", ".join(r.describe() for r in self.rules)


def _uint_like(dtype):
    """The integer dtype of ``dtype``'s width, for a bitcast (bitflip
    mode). torch's unsigned 16/32/64-bit types lack ``^``, so the signed
    type of the same width carries the bits: the XOR is the same."""
    import torch
    return {2: torch.int16, 4: torch.int32, 8: torch.int64}[
        torch.empty((), dtype=dtype).element_size()]


def apply_grad_faults(plan: GradFaultPlan, step, grads: dict) -> dict:
    """The plan applied to a name->gradient dict, ``step`` being the
    TrainState step as a 0-d integer tensor on the gradients' device:
    every matching rule contributes a data-dependent select, so the step
    injects at exactly the planned steps with no read back to the host
    (a CUDA graph can hold it). Rules naming absent variables are
    skipped (the transformer warns about them once when it builds)."""
    import torch
    out = dict(grads)
    for rule in plan.rules:
        g = out.get(rule.var)
        if g is None or not g.is_floating_point():
            continue
        hit = (step >= rule.step) & (step <= rule.until)
        if rule.every > 1:
            hit = hit & ((step - rule.step) % rule.every == 0)
        if rule.mode in ("nan", "inf"):
            bad = float("nan") if rule.mode == "nan" else float("inf")
            out[rule.var] = g + torch.where(hit, g.new_full((), bad),
                                            g.new_zeros(()))
        elif rule.mode == "scale":
            out[rule.var] = g * torch.where(hit, g.new_full((), rule.factor),
                                            g.new_ones(()))
        else:  # bitflip: XOR one bit of one element — silent corruption
            flat = g.reshape(-1).clone()
            idx = rule.index % int(flat.shape[0])
            idt = _uint_like(g.dtype)
            width = 8 * torch.empty((), dtype=idt).element_size()
            bit = rule.bit % width
            mask = (1 << bit) if bit < width - 1 else -(1 << bit)
            elem = flat[idx:idx + 1]
            flipped = (elem.view(idt) ^ mask).view(g.dtype)
            flat[idx:idx + 1] = torch.where(hit, flipped, elem)
            out[rule.var] = flat.reshape(g.shape)
    return out
