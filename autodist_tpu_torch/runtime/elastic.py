"""The membership plane's fence hooks (PyTorch counterpart of part of
``autodist_tpu/runtime/elastic.py``).

The JAX module holds the elastic membership plane: a cluster epoch and
roster on the coordination service, and a fence that rejects any write a
superseded incarnation of a worker still tries. The write paths of the
control plane (``runtime/resilience.py``, ``runtime/ps_service.py``, the
PS store's push) call :func:`maybe_fence` before each mutation; it is one
global read while no membership is installed.

Only the hooks are ported here: :class:`FencedOut` and :func:`install`,
:func:`current`, :func:`clear` and :func:`maybe_fence`. The
``Membership`` plane itself, which :func:`install` takes, and the rest of
the module (the knobs, the rejoin helpers) come with fault tolerance
(ROADMAP A item 8.3); until then no membership is ever installed and
every fence passes.
"""
from typing import Optional, Sequence

from autodist_tpu_torch.telemetry import spans as tel


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
    _current = None


def maybe_fence(op: str):
    """The fence hook of the write paths: a no-op (one global read) unless
    a membership is installed in this process."""
    m = _current
    if m is not None:
        m.fence(op)
