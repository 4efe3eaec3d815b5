"""The elastic plane's knobs, mark hygiene and fence hooks (PyTorch
counterpart of part of ``autodist_tpu/runtime/elastic.py``).

The JAX module holds the elastic membership plane: a cluster epoch and
roster on the coordination service, and a fence that rejects any write a
superseded incarnation of a worker still tries. The write paths of the
control plane (``runtime/resilience.py``, ``runtime/ps_service.py``, the
PS store's push) call :func:`maybe_fence` before each mutation; it is one
global read while no membership is installed.

What is here is the half that supervised recovery (ROADMAP A item 8.3a:
the chief's heartbeat watchdog, per-worker relaunch of async-PS workers,
the whole-job restart of sync jobs, ``runtime/coordinator.py``) needs:
:class:`ElasticConfigError` and :func:`validate_elastic_knobs`, the loud
parse of ``ADT_ELASTIC``, ``ADT_ELASTIC_SYNC`` and ``ADT_ELASTIC_INRUN``;
:func:`gc_worker_marks`, which scrubs a dead incarnation's liveness
records; and the fence hooks :class:`FencedOut`, :func:`install`,
:func:`current`, :func:`clear` and :func:`maybe_fence`.

The other half is item 8.3b's, in-run shrink and grow
(``ADT_ELASTIC_INRUN``): the ``Membership`` plane that :func:`install`
takes, the epoch protocol (``read_epoch``, ``publish_epoch``), admission
(``announce_join``, ``admit_worker``) and the rejoin helpers. Until it
lands no membership is ever installed, every fence passes, and
:func:`validate_elastic_knobs` refuses ``ADT_ELASTIC_INRUN=1``.
"""
import os
from typing import Optional, Sequence, Tuple

from autodist_tpu_torch import const
from autodist_tpu_torch.telemetry import spans as tel

INRUN_REFUSAL = (
    "ADT_ELASTIC_INRUN=1: in-run shrink and grow (the epoch-fenced "
    "membership plane) is not ported to autodist_tpu_torch yet (ROADMAP A "
    "item 8.3b); unset it for the whole-job checkpoint restart "
    "(ADT_ELASTIC_SYNC=1)")


class ElasticConfigError(ValueError):
    """An elastic knob holds a value that cannot mean anything.

    Raised at bring-up instead of silently disabling elasticity: a typo'd
    ``ADT_ELASTIC=-1`` (or ``ADT_ELASTIC=yes``) that quietly parsed to
    "off" would surface months later as a job that fail-fasts when its
    operator believed it was elastic."""

    def __init__(self, knob: str, raw: str, why: str):
        self.knob = knob
        self.raw = raw
        super().__init__(
            "invalid %s=%r: %s (unset it, or set a valid value)"
            % (knob, raw, why))


class FencedOut(Exception):
    """A stale-epoch write was rejected by the membership fence.

    Deliberately not an ``OSError``/``RuntimeError``: the transport
    handlers (retry loops, best-effort writers) swallow those, and a
    fenced process must stop, since a newer incarnation owns its
    identity."""

    def __init__(self, op: str, mine: int, current: int,
                 worker: str = "", roster: Sequence[str] = ()):
        self.op = op
        self.my_epoch = mine
        self.current_epoch = current
        self.worker = worker
        self.roster = list(roster)
        super().__init__(
            "%s fenced out: this process carries cluster epoch %d but the "
            "membership plane is at epoch %d and its roster %s no longer "
            "includes %r — a newer incarnation owns this identity; refusing "
            "the write" % (op, mine, current, self.roster, worker))


_BOOL_RAW = ("", "0", "1", "False", "false", "True", "true")


def validate_elastic_knobs() -> Tuple[int, bool, bool]:
    """Parse the elastic bring-up knobs loudly; returns ``(budget,
    sync_elastic, inrun)``, with the JAX package's checks and messages.
    ``const.ENV``'s parsers are permissive (any unknown string is a
    truthy bool; ``int()`` raises a bare ``ValueError`` naming no knob),
    and elasticity is a safety feature. A valid ``ADT_ELASTIC_INRUN=1``
    then raises ``NotImplementedError`` naming ROADMAP A item 8.3b."""
    raw = os.environ.get(const.ENV.ADT_ELASTIC.name_str)
    if raw is None:
        budget = 0
    else:
        try:
            budget = int(raw)
        except ValueError:
            raise ElasticConfigError(
                const.ENV.ADT_ELASTIC.name_str, raw,
                "must be an integer restart budget (0 disables elasticity)"
            ) from None
        if budget < 0:
            raise ElasticConfigError(
                const.ENV.ADT_ELASTIC.name_str, raw,
                "a negative restart budget is meaningless")
    out = [budget]
    for env in (const.ENV.ADT_ELASTIC_SYNC, const.ENV.ADT_ELASTIC_INRUN):
        raw = os.environ.get(env.name_str)
        if raw is not None and raw not in _BOOL_RAW:
            raise ElasticConfigError(
                env.name_str, raw,
                "must be one of %s" % (_BOOL_RAW,))
        out.append(env.val)
    if out[2] and not out[1]:
        raise ElasticConfigError(
            const.ENV.ADT_ELASTIC_INRUN.name_str, "1",
            "in-run reconfiguration is the sync-elastic upgrade path and "
            "needs ADT_ELASTIC_SYNC=1 at bring-up")
    if out[2] and out[0] <= 0:
        raise ElasticConfigError(
            const.ENV.ADT_ELASTIC_INRUN.name_str, "1",
            "needs a positive ADT_ELASTIC budget (each in-run "
            "reconfiguration spends one restart)")
    if out[2]:
        raise NotImplementedError(INRUN_REFUSAL)
    return out[0], out[1], out[2]


def gc_worker_marks(client, worker: str):
    """Watchdog hygiene: scrub every liveness record a dead incarnation of
    ``worker`` may have left — its heartbeat (GOODBYE), its ``compiling``
    grace mark and its ``straggler`` slow-but-alive mark (tombstoned to
    "0", which the readers treat as cleared). Otherwise a dead
    incarnation's fresh-looking marks could satisfy — or poison — the
    watchdog's freshness checks against the next incarnation."""
    for op in (lambda: client.goodbye(worker),
               lambda: client.put("compiling/%s" % worker, "0"),
               lambda: client.put("straggler/%s" % worker, "0")):
        try:
            op()
        except (OSError, RuntimeError):
            pass  # hygiene is best-effort; marks also age out


_current = None


def install(membership):
    """Install the process-ambient membership (one a process): an object
    with ``epoch``, ``fence(op)`` and ``close()``."""
    global _current
    _current = membership
    tel.gauge_set("elastic.epoch", float(membership.epoch))
    return membership


def current() -> Optional[object]:
    return _current


def clear():
    global _current
    if _current is not None:
        _current.close()
    _BOOL_RAW = ("", "0", "1", "False", "false", "True", "true")


def validate_elastic_knobs() -> Tuple[int, bool, bool]:
    """Parse the elastic bring-up knobs loudly; returns ``(budget,
    sync_elastic, inrun)``, with the JAX package's checks and messages.
    ``const.ENV``'s parsers are permissive (any unknown string is a
    truthy bool; ``int()`` raises a bare ``ValueError`` naming no knob),
    and elasticity is a safety feature. A valid ``ADT_ELASTIC_INRUN=1``
    then raises ``NotImplementedError`` naming ROADMAP A item 8.3b."""
    raw = os.environ.get(const.ENV.ADT_ELASTIC.name_str)
    if raw is None:
        budget = 0
    else:
        try:
            budget = int(raw)
        except ValueError:
            raise ElasticConfigError(
                const.ENV.ADT_ELASTIC.name_str, raw,
                "must be an integer restart budget (0 disables elasticity)"
            ) from None
        if budget < 0:
            raise ElasticConfigError(
                const.ENV.ADT_ELASTIC.name_str, raw,
                "a negative restart budget is meaningless")
    out = [budget]
    for env in (const.ENV.ADT_ELASTIC_SYNC, const.ENV.ADT_ELASTIC_INRUN):
        raw = os.environ.get(env.name_str)
        if raw is not None and raw not in _BOOL_RAW:
            raise ElasticConfigError(
                env.name_str, raw,
                "must be one of %s" % (_BOOL_RAW,))
        out.append(env.val)
    if out[2] and not out[1]:
        raise ElasticConfigError(
            const.ENV.ADT_ELASTIC_INRUN.name_str, "1",
            "in-run reconfiguration is the sync-elastic upgrade path and "
            "needs ADT_ELASTIC_SYNC=1 at bring-up")
    if out[2] and out[0] <= 0:
        raise ElasticConfigError(
            const.ENV.ADT_ELASTIC_INRUN.name_str, "1",
            "needs a positive ADT_ELASTIC budget (each in-run "
            "reconfiguration spends one restart)")
    if out[2]:
        raise NotImplementedError(INRUN_REFUSAL)
    return out[0], out[1], out[2]


def gc_worker_marks(client, worker: str):
    """Watchdog hygiene: scrub every liveness record a dead incarnation of
    ``worker`` may have left — its heartbeat (GOODBYE), its ``compiling``
    grace mark and its ``straggler`` slow-but-alive mark (tombstoned to
    "0", which the readers treat as cleared). Otherwise a dead
    incarnation's fresh-looking marks could satisfy — or poison — the
    watchdog's freshness checks against the next incarnation."""
    for op in (lambda: client.goodbye(worker),
               lambda: client.put("compiling/%s" % worker, "0"),
               lambda: client.put("straggler/%s" % worker, "0")):
        try:
            op()
        except (OSError, RuntimeError):
            pass  # hygiene is best-effort; marks also age out


_current = None


def maybe_fence(op: str):
    """The fence hook of the write paths: a no-op (one global read) unless
    a membership is installed in this process."""
    m = _current
    if m is not None:
        m.fence(op)
