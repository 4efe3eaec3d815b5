"""Preemption plane: advance-notice departure.

PyTorch counterpart of ``autodist_tpu/runtime/preemption.py`` (that
module imports nothing of JAX; the port keeps its own copy). Its keys and
JSON are the JAX module's byte for byte, so a notice, a plan or a left
stamp written by either package is read by the other on one coordination
service.

The elastic plane (``runtime/elastic.py``) recovers from *unplanned*
death: a worker vanishes and the survivors shrink. But most departures in
a real fleet are ANNOUNCED — spot evictions, maintenance events, an
operator draining a host — and the leaver is still alive, its state still
on the wire, with a deadline-sized window to use both:

1. **Notice sources**, all normalized into one :class:`PreemptionNotice`
   published as a KV mark on the coordination service
   (``preempt/notice/<worker>``):

   - **SIGTERM with a deadline**: :func:`install_sigterm_notice` arms a
     handler that records the notice locally, publishes the mark from a
     helper thread, and chains the flight recorder's dump hook
     (``telemetry/blackbox.py``) so that both fire, the dump last.
   - **Maintenance-event file**: ``ADT_MAINTENANCE_FILE`` names a path
     whose existence signals a pending eviction of this host (its JSON
     body may carry ``{"deadline_s": ..., "reason": ...}``).
   - **Operator drain**: ``python -m autodist_tpu_torch.runtime.preemption
     drain <worker> [--deadline S]``.

2. **Cluster-agreed rescue point**: every Runner polls the marks at its
   step boundaries (one ``preempt/seq`` read in the steady state,
   throttled to ``ADT_PREEMPT_POLL_S``); a rescue *plan*
   (``preempt/plan/<worker>``) names the step every process saves at, and
   there each process joins the **deadline-budgeted rescue checkpoint**:
   when the remaining grace is below the measured ``ckpt.save_ms`` p99
   (x ``RESCUE_SAFETY_FACTOR``) the save is skipped
   (``preempt.rescue_skips``) and the worker goes straight to the handoff.

3. **Planned handoff**: the chief's watchdog sees the notice and publishes
   the survivors' roster at epoch + 1 while the leaver is alive; the
   survivors reconfigure from a snapshot staged in advance (the
   ``planned`` flag of the ``elastic.reconfigure`` span), with no
   checkpoint fallback; the leaver drains its decode engines (queued
   requests shed with a typed ``Retry-After``, ``ADT_DRAIN_RETRY_AFTER_S``),
   stamps ``preempt/left`` and exits through :class:`PlannedDeparture` (a
   ``SystemExit`` with code 0, which the chief's process watcher reads as
   the end of a departure).

Where the port differs: the lockstep rule. Under gloo a collective that a
peer never enters raises within milliseconds (where a JAX survivor would
wait), so with more than one process in the job's group the shrink must
land at ONE boundary on every member, and no member may dispatch a
collective another will not enter. With more than one process:

- the seq cursor is read at the start of every step (not throttled): a
  plan a member publishes before its dispatch of step s is then seen by
  every peer at the start of step s + 1, since the peer's step s needed
  the publisher's collectives (and a step run with ``sync=True`` reads its
  metrics back before the next starts);
- the plan names ``rescue_step`` = the publisher's step + 1; the first
  plan on the service wins (any member may publish; two that publish
  without seeing each other's are at the same boundary, so their steps
  agree);
- a reconfigure to an epoch that excludes the announced leaver is held
  until the plan's step; there every member takes the rescue checkpoint
  (the skip verdict agreed by an all-reduce, so no member is left alone in
  a save's gathers), then waits for the survivors' epoch, bounded by the
  notice's deadline; the survivors then reconfigure and the leaver
  departs, at the same boundary.

A single process (whatever its roster) keeps the JAX
package's timing: the plan names its current step and the reconfigure
runs whenever the epoch lands. The JAX module also drains its serving
micro-batchers (``serving/batcher.py``), which the port does not have
yet (ROADMAP A item 10); :func:`drain_serving` drains the decode engines.

Protocol keys (all on the native coordination service):

=====================================  ====================================
``preempt/seq``                         bumped on every publish (poll key)
``preempt/notice/<worker>``             the JSON notice (the mark)
``preempt/plan/<worker>``               the rescue plan for it
``preempt/left/<worker>``               leaver's "handoff complete" stamp
=====================================  ====================================

Knobs, validated loudly (``ElasticConfigError`` naming the knob):
``ADT_PREEMPT_DEADLINE_S`` (the grace when the source attached none),
``ADT_PREEMPT_POLL_S`` (the notice poll's period; 0 disables the KV poll —
local SIGTERM and maintenance notices still work) and
``ADT_DRAIN_RETRY_AFTER_S`` (the serving tier's typed Retry-After).
"""
import dataclasses
import json
import os
import threading
import time
from typing import Callable, List, Optional

from autodist_tpu_torch import const
from autodist_tpu_torch.runtime.elastic import ElasticConfigError
from autodist_tpu_torch.telemetry import spans as tel
from autodist_tpu_torch.utils import logging

SEQ_KEY = "preempt/seq"
NOTICE_PREFIX = "preempt/notice/"
PLAN_PREFIX = "preempt/plan/"
LEFT_PREFIX = "preempt/left/"

# skip the rescue save unless the remaining grace covers the measured
# save p99 with this much headroom (a commit is all-or-nothing: a save the
# SIGKILL tears wastes the whole window and leaves debris to collect)
RESCUE_SAFETY_FACTOR = 1.5

# a notice is stale this long past its deadline (the SIGKILL never came —
# a cancelled maintenance event; the mark must not poison the worker's
# next incarnation)
NOTICE_STALE_AFTER_S = 600.0


def _bump_seq(client):
    """Advance the one-key poll cursor (a KV value, not an INC counter —
    the service's counters live in a different namespace than GET):
    pollers re-scan the per-worker marks only when it changes."""
    client.put(SEQ_KEY, repr(time.time()))


class PlannedDeparture(SystemExit):
    """The graceful exit of a preempted worker: handoff complete, state
    flushed, serving drained. A ``SystemExit`` with code 0 by design — the
    chief's process watcher reads a planned leaver's zero exit as the end
    of its departure, never as a failure."""

    def __init__(self, worker: str, reason: str):
        self.worker = worker
        self.reason = reason
        super().__init__(0)

    def __str__(self):
        return ("planned departure of %s (%s): handoff complete"
                % (self.worker, self.reason))


# ------------------------------------------------------------ knob validation


def validate_preempt_knobs() -> tuple:
    """Parse the preemption knobs loudly; returns ``(deadline_s, poll_s,
    retry_after_s)``. A knob that does not parse, or is out of range,
    raises :class:`ElasticConfigError` naming it at bring-up: a grace
    window that silently parsed to garbage would surface as a torn rescue
    checkpoint much later."""
    out = []
    for env, lo, what in (
            (const.ENV.ADT_PREEMPT_DEADLINE_S, 1e-9,
             "must be a positive grace window in seconds"),
            (const.ENV.ADT_PREEMPT_POLL_S, 0.0,
             "must be a poll period in seconds (0 disables the KV poll)"),
            (const.ENV.ADT_DRAIN_RETRY_AFTER_S, 0.0,
             "must be a Retry-After in seconds (>= 0)")):
        raw = os.environ.get(env.name_str)
        if raw is None:
            out.append(env.value[2])  # the member's typed default
            continue
        try:
            val = float(raw)
        except ValueError:
            raise ElasticConfigError(env.name_str, raw, what) from None
        if val < lo:
            raise ElasticConfigError(env.name_str, raw, what)
        out.append(val)
    return tuple(out)


# --------------------------------------------------------------- the notice


@dataclasses.dataclass
class PreemptionNotice:
    """One normalized advance notice: ``worker`` is leaving by
    ``deadline`` (absolute wall clock — the moment the platform may
    SIGKILL), for a human ``reason`` (``sigterm``, ``maintenance``,
    ``drain``, ...)."""

    worker: str
    deadline: float
    reason: str = "unknown"
    announced: float = 0.0

    def remaining_s(self) -> float:
        return self.deadline - time.time()

    def fresh(self) -> bool:
        """Actionable until its deadline, and visible (for the watchdog's
        grace) a while past it; beyond that it is stale — the eviction was
        cancelled or already happened."""
        return time.time() < self.deadline + NOTICE_STALE_AFTER_S

    def to_json(self) -> str:
        return json.dumps({"worker": self.worker,
                           "deadline": round(self.deadline, 6),
                           "reason": self.reason,
                           "announced": round(self.announced, 6)})

    @classmethod
    def from_json(cls, raw: str) -> Optional["PreemptionNotice"]:
        try:
            d = json.loads(raw)
            return cls(worker=str(d["worker"]),
                       deadline=float(d["deadline"]),
                       reason=str(d.get("reason", "unknown")),
                       announced=float(d.get("announced", 0.0)))
        except (ValueError, KeyError, TypeError):
            return None


def publish_notice(client, worker: str, deadline_s: Optional[float] = None,
                   reason: str = "drain") -> PreemptionNotice:
    """Publish an advance notice for ``worker`` (epoch-fenced when a
    membership is installed in this process: a zombie must not announce
    departures for the epoch that evicted it)."""
    from autodist_tpu_torch.runtime import elastic
    from autodist_tpu_torch.telemetry import blackbox
    elastic.maybe_fence("preempt.notice")
    if deadline_s is None:
        deadline_s = validate_preempt_knobs()[0]
    now = time.time()
    notice = PreemptionNotice(worker=worker, deadline=now + float(deadline_s),
                              reason=reason, announced=now)
    client.put(NOTICE_PREFIX + worker, notice.to_json())
    _bump_seq(client)
    tel.counter_add("preempt.notices")
    tel.instant("preempt.notice", "preempt", worker=worker, reason=reason,
                deadline_s=round(float(deadline_s), 3))
    blackbox.record("preempt.notice", worker=worker, reason=reason,
                    deadline_s=round(float(deadline_s), 3))
    logging.warning("preemption: %s announced leaving in %.1fs (%s)",
                    worker, deadline_s, reason)
    return notice


def retire_worker(client, worker: str, deadline_s: Optional[float] = None,
                  reason: str = "autoscale") -> int:
    """Planned drain-then-shrink of one worker as one move: publish its
    advance notice, then the survivors' epoch without it. Returns the new
    epoch. Raises ``RuntimeError`` when no epoch is published or
    ``worker`` is not a member (retiring a non-member would burn an epoch
    for nothing)."""
    from autodist_tpu_torch.runtime import elastic
    from autodist_tpu_torch.telemetry import blackbox
    info = elastic.read_epoch(client)
    if info is None:
        raise RuntimeError(
            "retire_worker(%r): no membership epoch published" % worker)
    epoch, roster = info
    if worker not in roster:
        raise RuntimeError(
            "retire_worker(%r): not in the current roster %s"
            % (worker, roster))
    publish_notice(client, worker, deadline_s=deadline_s, reason=reason)
    survivors = [w for w in roster if w != worker]
    elastic.publish_epoch(client, epoch + 1, survivors)
    blackbox.record("preempt.retire", worker=worker, reason=reason,
                    epoch=epoch + 1, survivors=len(survivors))
    return epoch + 1


def read_notice(client, worker: str) -> Optional[PreemptionNotice]:
    raw = client.get(NOTICE_PREFIX + worker)
    if not raw or raw == "0":
        return None
    notice = PreemptionNotice.from_json(raw)
    if notice is None or not notice.fresh():
        return None
    return notice


def clear_notice(client, worker: str):
    """Tombstone a consumed or stale notice (and its plan and left
    stamps), so the worker's next incarnation starts clean."""
    for key in (NOTICE_PREFIX + worker, PLAN_PREFIX + worker,
                LEFT_PREFIX + worker):
        try:
            client.put(key, "0")
        except (OSError, RuntimeError):
            pass


def read_plan(client, worker: str) -> Optional[dict]:
    raw = client.get(PLAN_PREFIX + worker)
    if not raw or raw == "0":
        return None
    try:
        plan = json.loads(raw)
        int(plan["rescue_step"])
        return plan
    except (ValueError, KeyError, TypeError):
        return None


def publish_plan(client, worker: str, rescue_step: int,
                 notice: PreemptionNotice):
    """The cluster-agreed rescue point: every process saves at its
    boundary ``rescue_step`` (a sync job is collective-lockstep, so that
    is one step everywhere, and the save's gathers line up)."""
    client.put(PLAN_PREFIX + worker, json.dumps(
        {"rescue_step": int(rescue_step),
         "deadline": round(notice.deadline, 6), "reason": notice.reason}))
    _bump_seq(client)
    logging.warning("preemption: rescue plan for %s published — every "
                    "process checkpoints at step >= %d (%.1fs of grace "
                    "left)", worker, rescue_step, notice.remaining_s())


def mark_left(client, worker: str):
    client.put(LEFT_PREFIX + worker, repr(time.time()))
    _bump_seq(client)


def has_left(client, worker: str) -> bool:
    raw = client.get(LEFT_PREFIX + worker)
    if not raw or raw == "0":
        return False
    try:
        return float(raw) > 0
    except ValueError:
        return False


# ------------------------------------------------------------ SIGTERM source

# written only by the signal handler, read by the guards' polls — a plain
# attribute (atomic in CPython); a lock here could deadlock the handler
# against the very main thread it interrupts
_signal_notice: Optional[PreemptionNotice] = None
_sigterm_installed = False
_armed_guards: List["PreemptionGuard"] = []


def grace_active() -> bool:
    """True when a guard is armed AND the notice handler is installed in
    this process: a SIGTERM is then an advance notice the training loop
    consumes, not a kill (the flight recorder's hook asks before it
    re-raises the default disposition)."""
    return _sigterm_installed and bool(_armed_guards)


def signal_notice() -> Optional[PreemptionNotice]:
    """The notice a SIGTERM delivered to THIS process (None when none)."""
    return _signal_notice


def _publish_signal_notice(notice: PreemptionNotice):
    """Helper-thread half of the SIGTERM handler: the logging, the
    telemetry recorder and the KV mark's RPC take locks the interrupted
    main thread may hold, so they run here, never in the signal frame."""
    tel.counter_add("preempt.notices")
    logging.warning(
        "preemption: SIGTERM received — treating it as an advance notice "
        "with %.1fs of grace (rescue checkpoint + graceful handoff at the "
        "next step boundary)", max(notice.remaining_s(), 0.0))
    try:
        from autodist_tpu_torch.runtime.coordination import \
            CoordinationClient
        host = (const.ENV.ADT_COORDINATOR_ADDR.val.split(":")[0]
                or "127.0.0.1")
        c = CoordinationClient(host, const.ENV.ADT_COORDSVC_PORT.val,
                               timeout=5.0)
        try:
            c.put(NOTICE_PREFIX + notice.worker, notice.to_json())
            _bump_seq(c)
        finally:
            c.close()
    except (OSError, RuntimeError) as e:
        logging.warning("preemption: could not publish the SIGTERM notice "
                        "(%s); peers learn of the departure from the "
                        "watchdog instead", e)


def install_sigterm_notice() -> bool:
    """Install the SIGTERM-as-advance-notice handler (idempotent; main
    thread only — False when it cannot install). It chains whatever
    handler was there — the flight recorder's dump hook in particular —
    so that both fire, the dump last (see ``telemetry/blackbox.py`` for
    the other install order)."""
    global _sigterm_installed
    if _sigterm_installed:
        return True
    if threading.current_thread() is not threading.main_thread():
        return False
    import signal as _signal
    try:
        prev = _signal.getsignal(_signal.SIGTERM)

        def _on_sigterm(signum, frame):
            # the signal frame: the flag write, the flight recorder's
            # event (one short-held deque lock: the chained dump must
            # hold the notice) and the thread spawn; everything else runs
            # in _publish_signal_notice's helper thread
            global _signal_notice
            from autodist_tpu_torch.telemetry import blackbox
            deadline_s = validate_preempt_knobs()[0]
            now = time.time()
            worker = const.ENV.ADT_WORKER.val or "chief"
            notice = PreemptionNotice(
                worker=worker, deadline=now + deadline_s,
                reason="sigterm", announced=now)
            _signal_notice = notice
            blackbox.record("preempt.notice", worker=worker,
                            reason="sigterm",
                            deadline_s=round(deadline_s, 3))
            threading.Thread(target=_publish_signal_notice, args=(notice,),
                             name="adt-preempt-publish",
                             daemon=True).start()
            # chain the previous handler (the dump hook) so the dump runs
            # last; a notice handler is never re-entered
            if callable(prev) and not getattr(prev, "_adt_notice_handler",
                                              False):
                prev(signum, frame)
            # never re-raise: the grace window owns the process now — the
            # platform's deadline SIGKILL is the backstop

        _on_sigterm._adt_notice_handler = True
        _on_sigterm._adt_prev = prev  # what blackbox.restore_sigterm puts back
        _signal.signal(_signal.SIGTERM, _on_sigterm)
        _sigterm_installed = True
        return True
    except (ValueError, OSError):
        return False  # a restricted environment


# ----------------------------------------------------- maintenance-event poll


class MaintenancePoller:
    """The cloud maintenance-event hook: ``ADT_MAINTENANCE_FILE`` names a
    path whose EXISTENCE signals a pending eviction of this host (a
    sidecar that watches the cloud's metadata server writes it; tests
    touch the file). One ``os.path.exists`` a poll; the file's JSON body
    may carry ``deadline_s`` and ``reason``."""

    def __init__(self, path: Optional[str] = None):
        self._path = (const.ENV.ADT_MAINTENANCE_FILE.val
                      if path is None else path)
        self._consumed = False

    def check(self) -> Optional[PreemptionNotice]:
        if not self._path or self._consumed or not os.path.exists(self._path):
            return None
        try:
            with open(self._path) as f:
                body = json.load(f)
            if not isinstance(body, dict):
                body = {}
        except (OSError, ValueError):
            body = {}  # a bare touch file
        # the reason and the deadline parse independently: a body with
        # only a reason keeps it
        reason = str(body.get("reason", "maintenance"))
        try:
            deadline_s = float(body["deadline_s"])
        except (KeyError, TypeError, ValueError):
            deadline_s = validate_preempt_knobs()[0]
        self._consumed = True  # one notice per event file
        now = time.time()
        worker = const.ENV.ADT_WORKER.val or "chief"
        logging.warning("preemption: maintenance event detected at %s — "
                        "%.1fs of grace (%s)", self._path, deadline_s,
                        reason)
        return PreemptionNotice(worker=worker, deadline=now + deadline_s,
                                reason=reason, announced=now)


# ------------------------------------------------------------- runner guard


class PreemptionGuard:
    """One Runner's half of the protocol: poll the notice sources at step
    boundaries, drive the cluster-agreed, deadline-budgeted rescue
    checkpoint, and carry out the planned handoff (serving drain and a
    graceful :class:`PlannedDeparture`) when the leaver is this process.
    Every Runner makes one; it costs a flag check a boundary while no
    notice is live (and one seq read a step with more than one
    process)."""

    def __init__(self, runner, client_factory: Optional[Callable] = None):
        (self.deadline_s, self.poll_s,
         self.retry_after_s) = validate_preempt_knobs()
        self._runner = runner
        # the membership's identity when armed (the roster address, which
        # epochs and operator drains name), the heartbeat name otherwise;
        # both are "this worker" (the chief's differ: address and "chief")
        m = getattr(runner, "_membership", None)
        hb_name = const.ENV.ADT_WORKER.val or "chief"
        self.worker = m.worker if m is not None else hb_name
        self.aliases = frozenset({self.worker, hb_name})
        self._client_factory = client_factory
        self._maintenance = MaintenancePoller()
        self._poll_at = 0.0
        self._seen_seq = ""
        self._notice: Optional[PreemptionNotice] = None  # being acted on
        self._plan: Optional[dict] = None
        self._plan_shared = False  # the plan is on the service
        self._rescued = False      # rescue point passed (saved or skipped)
        self._published = False    # self-notice pushed to the service
        self._saver = None
        self.last_handoff_s: Optional[float] = None
        install_sigterm_notice()
        _armed_guards.append(self)

    def close(self):
        try:
            _armed_guards.remove(self)
        except ValueError:
            pass

    # -------------------------------------------------------------- plumbing

    def attach_saver(self, saver):
        """The saver the rescue checkpoint goes through (``fit`` wires its
        periodic saver; by default a new one on ``ADT_CKPT_DIR``)."""
        self._saver = saver

    def _rescue_saver(self):
        if self._saver is None:
            from autodist_tpu_torch.checkpoint.saver import Saver
            self._saver = Saver(directory=const.ENV.ADT_CKPT_DIR.val)
        return self._saver

    def _lockstep(self) -> bool:
        """More than one process meets in the step's collectives (data or
        model parallel): the planned shrink must land at one boundary on
        every member."""
        return self._runner.distributed_step.replica_info.num_processes > 1

    def _client(self):
        """A client the runner already opened (None in a run with none)."""
        r = self._runner
        for attr in ("_async_hb", "_coord"):
            c = getattr(r, attr, None)
            if c not in (None, False):
                return c
        return None

    def _with_any_client(self, fn):
        """``fn(client)`` against the runner's client, the wired factory's
        or the membership's; None when no service is reachable (a
        single-process run)."""
        c = self._client()
        if c is not None:
            try:
                return fn(c)
            except (OSError, RuntimeError):
                return None
        m = getattr(self._runner, "_membership", None)
        factory = self._client_factory
        if factory is None and m is not None:
            try:
                return m._with_client(fn)
            except (OSError, RuntimeError):
                return None
        if factory is None:
            return None
        try:
            c = factory()
        except (OSError, RuntimeError):
            return None
        try:
            return fn(c)
        except (OSError, RuntimeError):
            return None
        finally:
            try:
                c.close()
            except (OSError, RuntimeError):
                pass

    # ----------------------------------------------------------------- poll

    def poll(self, at_start: bool = False):
        """The boundary's notice intake: the local SIGTERM flag and the
        maintenance file always; the KV read after a dispatch, throttled
        to ``ADT_PREEMPT_POLL_S`` and one ``preempt/seq`` get until
        something is published. With more than one process the KV read runs
        at the start of every step instead (``at_start``, the lockstep
        rule: the step's metrics were read back by then, so every peer's
        earlier publish is visible)."""
        from autodist_tpu_torch.telemetry import blackbox
        if self._notice is None:
            sig = signal_notice()
            if sig is not None:
                self._adopt_notice(sig, local=True)
        if self._notice is None:
            maint = self._maintenance.check()
            if maint is not None:
                tel.counter_add("preempt.notices")
                blackbox.record("preempt.notice", worker=maint.worker,
                                reason=maint.reason)
                self._adopt_notice(maint, local=True)
        if self.poll_s <= 0 or at_start != self._lockstep():
            return
        now = time.monotonic()
        if now < self._poll_at and not at_start:
            return
        self._poll_at = now + self.poll_s

        def read(c):
            seq = c.get(SEQ_KEY) or ""
            if seq == self._seen_seq:
                return None
            members = list(self.aliases)
            m = getattr(self._runner, "_membership", None)
            if m is not None:
                members = list(dict.fromkeys(
                    list(self.aliases) + list(m.roster)))
            found = None
            for w in members:
                n = read_notice(c, w)
                if n is not None and not has_left(c, w):
                    found = n
                    break
            # the cursor is consumed only after a complete scan: an error
            # mid-scan leaves it, so the next poll scans again
            self._seen_seq = seq
            return found
        found = self._with_any_client(read)
        if found is not None and self._notice is None:
            self._adopt_notice(found, local=False)

    def _adopt_notice(self, notice: PreemptionNotice, local: bool):
        self._notice = notice
        self._plan = None
        self._plan_shared = False
        self._rescued = False
        self._published = not local or notice.reason == "sigterm"
        if notice.worker in self.aliases:
            # keep the epoch fence open for this announced leaver until
            # its deadline: the survivors' epoch may land before its last
            # boundary, and its rescue save, flush and left stamp must not
            # read as a zombie's writes
            m = getattr(self._runner, "_membership", None)
            if m is not None:
                m.expect_departure(notice.deadline)
        logging.warning(
            "preemption: notice live for %s (%s, %.1fs of grace) — "
            "rescue checkpoint at the agreed boundary, then %s",
            notice.worker, notice.reason, max(notice.remaining_s(), 0.0),
            "graceful handoff" if notice.worker in self.aliases
            else "planned shrink")

    # ------------------------------------------------------------------ act

    @property
    def pending(self) -> bool:
        return self._notice is not None

    def holds_reconfigure(self, roster) -> bool:
        """True while a reconfigure to ``roster`` must wait: at more than
        one process, an epoch without the announced leaver takes effect at
        the plan's step, where every member meets it (before it, the
        leaver still runs every collective of its peers)."""
        n, plan = self._notice, self._plan
        return (n is not None and plan is not None and self._plan_shared
                and self._lockstep() and n.worker not in roster
                and self._runner._step_count < int(plan["rescue_step"]))

    def defers_departure(self, roster) -> bool:
        """True when this leaver, excluded by ``roster`` before its notice
        poll adopted the mark, must still meet its peers at the plan's
        step (more than one process): the plan is agreed now, and the
        departure waits for that step."""
        if self._notice is None or not self._lockstep():
            return False
        if self._plan is None:
            self._plan = self._agree_plan(self._notice)
        return self._plan is not None and self.holds_reconfigure(roster)

    def maybe_act(self):
        """Drive the protocol at a SAFE point (no dispatch in flight):
        agree the rescue plan, take the deadline-budgeted rescue
        checkpoint at its step, and stage the handoff — the leaver
        departs in ``Runner._maybe_reconfigure`` when the survivors' epoch
        lands, or here when no membership plane is armed."""
        notice = self._notice
        if notice is None:
            return
        if not notice.fresh():
            logging.warning("preemption: notice for %s went stale "
                            "(cancelled eviction?) — disarming",
                            notice.worker)
            self._notice = None
            return
        runner = self._runner
        m = getattr(runner, "_membership", None)
        if (notice.worker not in self.aliases and m is not None
                and notice.worker not in m.roster):
            # the announced leaver is out of our (reconfigured) roster:
            # the planned shrink is complete
            self._notice = None
            return
        if not self._published and notice.worker in self.aliases:
            # a maintenance-file notice reaches the peers through the mark
            self._published = True
            self._with_any_client(
                lambda c: c.put(NOTICE_PREFIX + self.worker,
                                notice.to_json()) or _bump_seq(c))
        if self._plan is None:
            self._plan = self._agree_plan(notice)
            if self._plan is None:
                return  # a peer waiting for the plan
        step = runner._step_count
        if self._lockstep() and not self._rescued and \
                step > int(self._plan["rescue_step"]):
            # past the plan's step already (a member that polls no
            # service): the members cannot meet, so no shared save
            self._plan_shared = False
        if not self._rescued and step >= int(self._plan["rescue_step"]):
            self._rescue(notice)
        if self._lockstep():
            if self._rescued:
                self._meet_at_plan(notice)
            return
        if self._rescued and notice.worker in self.aliases:
            solo = m is None or len(m.roster) <= 1
            if solo:
                # no survivors to hand off to: the rescue checkpoint is
                # the legacy; drain serving and leave (ADT_AUTO_RESUME
                # picks the job up elsewhere)
                self.depart(epoch=None, roster=())
            if notice.remaining_s() <= 0:
                # the survivors' epoch never came inside the grace: leave
                # without the live handoff (the rescue checkpoint
                # committed; the unplanned machinery recovers the peers)
                logging.warning(
                    "preemption: grace expired with no shrink epoch — "
                    "departing without a live handoff (%s)", notice.reason)
                self.depart(epoch=None, roster=())
            # else the chief's watchdog publishes the survivors' epoch and
            # Runner._maybe_reconfigure routes this leaver to depart()
        elif self._rescued and notice.worker not in self.aliases:
            # stage the snapshot only at the boundary the reconfigure runs
            # at (the epoch poll parked it; _maybe_reconfigure is next)
            if getattr(runner, "_reconfig_pending", None) is not None:
                runner._prestage_snapshot()

    def _agree_plan(self, notice: PreemptionNotice) -> Optional[dict]:
        """The cluster-agreed rescue step. One process: the chief (or the
        leaver) publishes its current step, as the JAX package does, and
        the other processes adopt it. More than one (the lockstep rule):
        the plan already on the service, else this member's step + 1,
        published. With no service the plan is local."""
        runner = self._runner
        my_step = runner._step_count
        if self._lockstep():
            found = self._with_any_client(
                lambda c: (read_plan(c, notice.worker),))
            if found is None:
                # no service: the peers cannot learn the plan
                self._plan_shared = False
                return {"rescue_step": int(my_step),
                        "deadline": notice.deadline, "reason": notice.reason}
            plan = found[0]
            if plan is not None and abs(float(plan.get("deadline", 0.0))
                                        - notice.deadline) < 1e-3:
                self._plan_shared = True
                return plan
            rescue = my_step + 1
            self._plan_shared = bool(self._with_any_client(
                lambda c: publish_plan(c, notice.worker, rescue, notice)
                or True))
            return {"rescue_step": int(rescue),
                    "deadline": notice.deadline, "reason": notice.reason}
        if const.is_chief() or notice.worker in self.aliases:
            plan = {"rescue_step": int(my_step),
                    "deadline": notice.deadline, "reason": notice.reason}
            self._plan_shared = bool(self._with_any_client(
                lambda c: publish_plan(c, notice.worker, my_step, notice)
                or True))
            return plan
        plan = self._with_any_client(lambda c: read_plan(c, notice.worker))
        self._plan_shared = plan is not None
        return plan

    def _agree(self, flag: bool) -> bool:
        """True on every member when it is true on any: a one-element
        all-reduce (MAX) on the default group, which every member reaches
        at the plan's step."""
        import torch
        import torch.distributed as dist
        t = torch.tensor([1 if flag else 0], dtype=torch.int32,
                         device=self._runner.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(int(t.item()))

    def _rescue(self, notice: PreemptionNotice):
        """The deadline-budgeted rescue checkpoint: saved synchronously (a
        rescue that does not COMMIT before the SIGKILL is worthless)
        unless the measured save p99 no longer fits the remaining grace.
        With more than one process the verdict is agreed, and a plan the
        peers cannot know (no service) skips the save: a peer left out of
        a save's gathers would hang."""
        from autodist_tpu_torch.telemetry import blackbox
        self._rescued = True
        remaining = notice.remaining_s()
        p99_ms = tel.hist_quantile("ckpt.save_ms", 0.99)
        # an expired grace skips unconditionally; otherwise skip when the
        # measured p99 no longer fits with headroom
        skip = remaining <= 0 or (
            p99_ms is not None
            and remaining * 1e3 < p99_ms * RESCUE_SAFETY_FACTOR)
        why = "grace"
        if self._lockstep():
            if not self._plan_shared:
                skip, why = True, "unshared"
            else:
                skip = self._agree(skip)
        if skip:
            tel.counter_add("preempt.rescue_skips")
            tel.instant("preempt.rescue_skip", "preempt",
                        remaining_s=round(remaining, 3),
                        save_p99_ms=round(p99_ms or 0.0, 1))
            if why == "unshared":
                logging.warning(
                    "preemption: SKIPPING the rescue checkpoint — the plan "
                    "is not on the coordination service, so the peers "
                    "cannot join the save")
            else:
                logging.warning(
                    "preemption: SKIPPING the rescue checkpoint — %.2fs of "
                    "grace left vs saves measuring %sms at p99 (x%.1f "
                    "safety); going straight to the handoff", remaining,
                    ("%.0f" % p99_ms) if p99_ms is not None
                    else "unmeasured", RESCUE_SAFETY_FACTOR)
            return
        t0 = time.monotonic()
        with tel.span("preempt.rescue_save", "preempt",
                      step=self._runner._step_count,
                      remaining_s=round(remaining, 3)):
            saver = self._rescue_saver()
            saver.save(self._runner)
            saver.wait()  # the commit must land inside the grace window
        save_ms = (time.monotonic() - t0) * 1e3
        tel.counter_add("preempt.rescue_saves")
        tel.hist_observe("preempt.rescue_save_ms", save_ms)
        blackbox.record("preempt.rescue_save", worker=notice.worker,
                        step=self._runner._step_count,
                        save_ms=round(save_ms, 1))
        logging.warning("preemption: rescue checkpoint committed at step "
                        "%d in %.0fms (%.2fs of grace left)",
                        self._runner._step_count, save_ms,
                        notice.remaining_s())

    def _meet_at_plan(self, notice: PreemptionNotice):
        """The lockstep handoff, at the plan's step: every member waits
        here for the survivors' epoch (the chief's watchdog publishes it
        when it reads the notice), bounded by the notice's deadline, and
        parks it, so that the reconfigure (survivors) and the departure
        (the leaver) run at this boundary on every member. A survivor
        stages its snapshot first (outside the reconfigure span)."""
        runner = self._runner
        m = getattr(runner, "_membership", None)
        leaver = notice.worker in self.aliases
        if m is None or not self._plan_shared:
            # no membership plane (or no service): no epoch will come; the
            # peers learn of the departure from their failed collective
            if leaver:
                self.depart(epoch=None, roster=())
            self._notice = None
            return
        pending = runner._reconfig_pending
        info = pending if (pending is not None
                           and notice.worker not in pending[1]) else None
        while info is None and notice.remaining_s() > 0:
            got = m.peek(fresh=True)
            if got is not None and got[0] > m.epoch and \
                    notice.worker not in got[1]:
                info = got
            else:
                time.sleep(0.02)
        if info is None:
            if leaver:
                logging.warning(
                    "preemption: grace expired with no shrink epoch — "
                    "departing without a live handoff (%s)", notice.reason)
                self.depart(epoch=None, roster=())
            logging.warning(
                "preemption: no shrink epoch for %s inside its grace — "
                "going on; the unplanned path recovers", notice.worker)
            self._notice = None
            return
        runner._reconfig_pending = info
        if not leaver:
            runner._prestage_snapshot()

    # -------------------------------------------------------------- handoff

    def departing(self) -> bool:
        """True when THIS worker holds a live notice (the Runner's
        reconfigure path asks before treating an epoch that excludes it as
        a zombie fence-out)."""
        n = self._notice
        return n is not None and n.worker in self.aliases and n.fresh()

    def check_departure_now(self) -> bool:
        """Unthrottled departure check for the reconfigure path: the epoch
        poll can see the exclusion before the notice poll adopted the mark,
        and concluding "zombie" there would crash an announced leaver with
        ``FencedOut`` mid-handoff. A departure adopted HERE skips the
        rescue checkpoint by design: its peers are already heading into the
        reconfigure, not into a collective save."""
        if self.departing():
            return True

        def read(c):
            for w in self.aliases:
                n = read_notice(c, w)
                if n is not None:
                    return n
            return None
        found = self._with_any_client(read)
        if found is not None:
            self._adopt_notice(found, local=False)
        return self.departing()

    def depart(self, epoch: Optional[int], roster) -> "PlannedDeparture":
        """The graceful exit: drain serving (typed Retry-After sheds),
        flush training state, stamp ``preempt/left`` so peers and the
        watchdog know the handoff completed, and raise
        :class:`PlannedDeparture`. Never returns."""
        from autodist_tpu_torch.telemetry import blackbox
        notice = self._notice
        reason = notice.reason if notice is not None else "drain"
        t0 = time.perf_counter()
        with tel.span("preempt.handoff", "preempt",
                      worker=self.worker, reason=reason,
                      epoch=epoch if epoch is not None else -1,
                      step=self._runner._step_count):
            drained = drain_serving(self.retry_after_s)
            try:
                self._runner.distributed_step.flush_ps()
            except Exception as e:  # noqa: BLE001 — a dead PS pipeline (or
                # the fence on a write after the shrink) must not block the
                # departure; the rescue checkpoint covers it
                logging.warning("preemption: flush on departure failed "
                                "(%s)", e)
            try:
                self._with_any_client(lambda c: mark_left(c, self.worker))
            except Exception as e:  # noqa: BLE001 — incl. FencedOut
                logging.warning("preemption: left stamp not published "
                                "(%s); the watchdog ages the notice out "
                                "instead", e)
        self.last_handoff_s = time.perf_counter() - t0
        tel.counter_add("preempt.handoffs")
        blackbox.record("preempt.handoff", worker=self.worker,
                        reason=reason, drained=drained,
                        downtime_s=round(self.last_handoff_s, 6))
        logging.warning(
            "preemption: %s handed off alive (%s; %d serving request(s) "
            "shed with Retry-After %.1fs) — departing with exit code 0",
            self.worker, reason, drained, self.retry_after_s)
        # the runner is not closed here: PlannedDeparture unwinds through
        # fit()'s finally (saver.wait) first, and the exit hooks close it
        raise PlannedDeparture(self.worker, reason)

    def stats(self) -> dict:
        c = tel.counters()
        n = self._notice
        return {
            "notice": (None if n is None else
                       {"worker": n.worker, "reason": n.reason,
                        "remaining_s": round(n.remaining_s(), 3)}),
            "notices": c.get("preempt.notices", 0.0),
            "rescue_saves": c.get("preempt.rescue_saves", 0.0),
            "rescue_skips": c.get("preempt.rescue_skips", 0.0),
            "handoffs": c.get("preempt.handoffs", 0.0),
            "last_handoff_s": (round(self.last_handoff_s, 6)
                               if self.last_handoff_s is not None else None),
        }


def drain_serving(retry_after_s: Optional[float] = None) -> int:
    """Drain every live decode engine of this process: the sequences in
    flight complete, queued requests shed with the typed Retry-After.
    Returns the number of shed requests."""
    from autodist_tpu_torch.serving import decode as decode_lib
    shed = 0
    for de in decode_lib.active_decoders():
        try:
            shed += de.drain(retry_after_s=retry_after_s)
        except Exception as e:  # noqa: BLE001 — a wedged engine must not
            # block the departure of the whole process
            logging.warning("preemption: decode drain failed (%s)", e)
    return shed


def reset():
    """Test isolation: forget the signal notice and the armed guards, and
    put back the SIGTERM handler the notice handler replaced (main thread
    only), so a later SIGTERM in this process is not eaten."""
    global _signal_notice
    from autodist_tpu_torch.telemetry import blackbox
    _signal_notice = None
    del _armed_guards[:]
    blackbox.restore_sigterm()


# --------------------------------------------------------------- drain CLI


def main(argv: Optional[List[str]] = None) -> int:
    """Operator verbs over the coordination service::

        python -m autodist_tpu_torch.runtime.preemption drain <worker> \\
            [--deadline S] [--reason R] [--host H] [--port P]
        python -m autodist_tpu_torch.runtime.preemption status <worker> [...]

    ``drain`` publishes an advance notice: the worker takes its rescue
    checkpoint, hands off into a planned shrink and exits cleanly.
    ``status`` prints the notice, plan and left marks of a worker."""
    import argparse
    p = argparse.ArgumentParser(prog="python -m "
                                "autodist_tpu_torch.runtime.preemption")
    sub = p.add_subparsers(dest="verb", required=True)
    for verb in ("drain", "status"):
        sp = sub.add_parser(verb)
        sp.add_argument("worker")
        sp.add_argument("--host", default=None)
        sp.add_argument("--port", type=int, default=None)
        if verb == "drain":
            sp.add_argument("--deadline", type=float, default=None,
                            help="grace seconds before the platform may "
                                 "SIGKILL (default ADT_PREEMPT_DEADLINE_S)")
            sp.add_argument("--reason", default="drain")
    args = p.parse_args(argv)
    host = args.host or (const.ENV.ADT_COORDINATOR_ADDR.val.split(":")[0]
                         or "127.0.0.1")
    port = args.port or const.ENV.ADT_COORDSVC_PORT.val
    from autodist_tpu_torch.runtime.coordination import CoordinationClient
    try:
        client = CoordinationClient(host, port, timeout=10.0)
    except OSError as e:
        print("coordination service unreachable at %s:%d: %s"
              % (host, port, e))
        return 1
    try:
        if args.verb == "drain":
            notice = publish_notice(client, args.worker,
                                    deadline_s=args.deadline,
                                    reason=args.reason)
            print("drain published: %s leaves by %s (%s)"
                  % (args.worker,
                     time.strftime("%H:%M:%S",
                                   time.localtime(notice.deadline)),
                     notice.reason))
            return 0
        notice = read_notice(client, args.worker)
        plan = read_plan(client, args.worker)
        left = has_left(client, args.worker)
        print(json.dumps({
            "worker": args.worker,
            "notice": (None if notice is None else
                       json.loads(notice.to_json())),
            "plan": plan, "left": left}, indent=2, sort_keys=True))
        return 0
    finally:
        client.close()


if __name__ == "__main__":
    raise SystemExit(main())
