"""FleetAutoscaler — the closed loop from serving telemetry to the
elastic actuators (PyTorch counterpart of
``autodist_tpu/serving/autoscale.py``).

The robustness arc built every actuator a production serving fleet
needs — grow-on-join admission, planned drain-then-shrink (the
preemption plane's zero-``ckpt.fallback`` departure path) — and the
observability plane measures everything a controller would want: queue
depth, latency percentiles, batch fill, per-worker scrape ages. This
module closes the loop:

- :class:`AutoscalePolicy` — the pure decision function. Hysteresis
  bands (``queue_high``/``queue_low`` — between them NOTHING happens,
  so a signal oscillating across one band edge cannot flap the fleet),
  a sustain window (the signal must sit outside the band for
  ``sustain_s`` before any move), per-direction cooldowns, and hard
  ``min_replicas``/``max_replicas`` clamps. Deterministic and
  clock-injectable, so the unit matrix drives it without threads.
- :class:`FleetAutoscaler` — the actuating controller. Reads the live
  signals (the ``serve.queue_depth`` gauge, ``serve.latency_ms`` p99,
  batch fill from the live micro-batchers; the per-worker
  ``scrape_age_s`` of ``export.scrape_cluster`` is ROADMAP A item 11, and
  ``scrape_workers`` raises until then), asks the policy, and drives the
  existing actuators: **grow** publishes a grown-roster epoch
  (:func:`~autodist_tpu_torch.runtime.elastic.admit_worker` — the same
  grow-on-join admission a relaunched worker gets), **shrink**
  publishes an advance preemption notice followed by the survivor
  epoch (:func:`~autodist_tpu_torch.runtime.preemption.retire_worker` — the
  planned-departure path, so the leaver drains serving with a typed
  Retry-After and zero checkpoint fallback). Every decision is
  **epoch-fenced**: the actuation re-reads the membership epoch and a
  controller whose decision was computed against a stale epoch gets the
  typed :class:`~autodist_tpu_torch.runtime.elastic.FencedOut` — dropped, so
  two racing controllers can never double-scale. A grow candidate with
  a pending ``preempt/notice`` mark is refused (counted in
  ``autoscale.refusals``): the platform is about to take that host.

Every decision — grow, shrink, hold, refusal, fenced drop — lands in
the pre-registered ``autoscale.*`` counters, an ``autoscale.decision``
span carrying the full signal snapshot as args, and a blackbox
flight-recorder event, so a post-incident dump shows exactly why the
fleet moved (docs/serving.md#autoscaling).
"""
import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from autodist_tpu_torch import const
from autodist_tpu_torch.telemetry import spans as tel
from autodist_tpu_torch.utils import logging


@dataclasses.dataclass
class AutoscaleSignals:
    """One sampled snapshot of the signals the policy consumes.
    ``queue_depth`` is the ``serve.queue_depth`` gauge; ``p99_ms`` the
    ``serve.latency_ms`` p99 (None before any request); ``batch_fill``
    the realized fan-out per dispatched batch; ``tokens_per_s`` /
    ``slot_occupancy`` the decode tier's smoothed throughput and
    live-slot fraction (``serving/decode.py``; None with no decode
    engine running); ``scrape_ages`` the per-worker telemetry publish
    age (empty when the fleet scrape is not wired)."""

    queue_depth: float = 0.0
    p99_ms: Optional[float] = None
    batch_fill: Optional[float] = None
    tokens_per_s: Optional[float] = None
    slot_occupancy: Optional[float] = None
    scrape_ages: Dict[str, float] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"queue_depth": round(float(self.queue_depth), 2),
                "p99_ms": (round(float(self.p99_ms), 3)
                           if self.p99_ms is not None else None),
                "batch_fill": (round(float(self.batch_fill), 2)
                               if self.batch_fill is not None else None),
                "tokens_per_s": (round(float(self.tokens_per_s), 2)
                                 if self.tokens_per_s is not None else None),
                "slot_occupancy": (round(float(self.slot_occupancy), 3)
                                   if self.slot_occupancy is not None
                                   else None),
                "max_scrape_age_s": (round(max(self.scrape_ages.values()), 2)
                                     if self.scrape_ages else None)}


@dataclasses.dataclass
class Decision:
    """One policy verdict: ``direction`` in {"grow", "shrink", "hold"},
    the replica ``target`` it implies, and the human ``reason`` the
    blackbox/telemetry record."""

    direction: str
    target: int
    reason: str
    signals: Optional[AutoscaleSignals] = None

    def to_dict(self) -> dict:
        out = {"direction": self.direction, "target": int(self.target),
               "reason": self.reason}
        if self.signals is not None:
            out["signals"] = self.signals.to_dict()
        return out


class AutoscalePolicy:
    """Hysteresis-banded, cooldown-guarded scaling policy.

    The band: ``queue_depth > queue_high`` (or ``p99_ms > p99_high_ms``
    when set) is OVERLOAD; ``queue_depth <= queue_low`` (and ``p99``
    below ``p99_high_ms``, and batch fill below ``fill_low`` when set)
    is IDLE; anything between is IN-BAND and resets both sustain
    timers — the gap between ``queue_low`` and ``queue_high`` is what
    keeps a signal oscillating across one edge from flapping the fleet.
    A move additionally requires the condition to have been sustained
    ``sustain_s``, the per-direction cooldown to have lapsed, and the
    replica clamp to allow it. Signals staler than ``stale_signal_s``
    (any worker's ``scrape_age_s``) force a hold — a controller must
    not scale a fleet it cannot currently see.

    ``decide`` never mutates the cooldown stamps itself: the actuator
    confirms a move with :meth:`note_scaled` AFTER it actually landed,
    so a refused or fenced decision does not burn a cooldown."""

    def __init__(self, min_replicas: int = 1, max_replicas: int = 8,
                 queue_high: float = 64.0, queue_low: float = 4.0,
                 p99_high_ms: Optional[float] = None,
                 fill_low: Optional[float] = None,
                 sustain_s: float = 5.0,
                 grow_cooldown_s: float = 30.0,
                 shrink_cooldown_s: float = 120.0,
                 stale_signal_s: Optional[float] = None):
        if min_replicas < 1:
            raise ValueError("min_replicas must be >= 1, got %d"
                             % min_replicas)
        if max_replicas < min_replicas:
            raise ValueError(
                "max_replicas %d < min_replicas %d — the clamp is empty"
                % (max_replicas, min_replicas))
        if queue_low >= queue_high:
            raise ValueError(
                "hysteresis band is empty: queue_low %.1f >= queue_high "
                "%.1f — a signal on the edge would flap grow/shrink"
                % (queue_low, queue_high))
        if sustain_s < 0 or grow_cooldown_s < 0 or shrink_cooldown_s < 0:
            raise ValueError("sustain/cooldown windows must be >= 0")
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.queue_high = float(queue_high)
        self.queue_low = float(queue_low)
        self.p99_high_ms = p99_high_ms
        self.fill_low = fill_low
        self.sustain_s = float(sustain_s)
        self.grow_cooldown_s = float(grow_cooldown_s)
        self.shrink_cooldown_s = float(shrink_cooldown_s)
        self.stale_signal_s = stale_signal_s
        # sustain state: when the signal FIRST left the band in each
        # direction (None = currently in-band in that direction)
        self._above_since: Optional[float] = None
        self._below_since: Optional[float] = None
        self._last_grow = float("-inf")
        self._last_shrink = float("-inf")

    # ------------------------------------------------------------- verdict

    def decide(self, signals: AutoscaleSignals, replicas: int,
               now: Optional[float] = None) -> Decision:
        now = time.monotonic() if now is None else now
        if self.stale_signal_s is not None and signals.scrape_ages:
            worst = max(signals.scrape_ages.values())
            if worst > self.stale_signal_s:
                # blind controller: reset sustain (the window must be
                # measured, not assumed) and refuse to move
                self._above_since = self._below_since = None
                return Decision("hold", replicas,
                                "telemetry stale (%.1fs > %.1fs) — "
                                "refusing to scale blind"
                                % (worst, self.stale_signal_s), signals)
        overloaded = signals.queue_depth > self.queue_high or (
            self.p99_high_ms is not None and signals.p99_ms is not None
            and signals.p99_ms > self.p99_high_ms)
        idle = (not overloaded
                and signals.queue_depth <= self.queue_low
                and (self.fill_low is None or signals.batch_fill is None
                     or signals.batch_fill <= self.fill_low))
        if overloaded:
            self._below_since = None
            if self._above_since is None:
                self._above_since = now
            if now - self._above_since < self.sustain_s:
                return Decision("hold", replicas,
                                "overload not yet sustained "
                                "(%.2fs/%.2fs)"
                                % (now - self._above_since,
                                   self.sustain_s), signals)
            if replicas >= self.max_replicas:
                return Decision("hold", replicas,
                                "overloaded but at max_replicas %d"
                                % self.max_replicas, signals)
            if now - self._last_grow < self.grow_cooldown_s:
                return Decision("hold", replicas,
                                "grow cooldown (%.2fs/%.2fs)"
                                % (now - self._last_grow,
                                   self.grow_cooldown_s), signals)
            return Decision("grow", replicas + 1,
                            "queue/p99 above band for >= %.2fs"
                            % self.sustain_s, signals)
        if idle:
            self._above_since = None
            if self._below_since is None:
                self._below_since = now
            if now - self._below_since < self.sustain_s:
                return Decision("hold", replicas,
                                "idle not yet sustained (%.2fs/%.2fs)"
                                % (now - self._below_since,
                                   self.sustain_s), signals)
            if replicas <= self.min_replicas:
                return Decision("hold", replicas,
                                "idle but at min_replicas %d"
                                % self.min_replicas, signals)
            if now - self._last_shrink < self.shrink_cooldown_s:
                return Decision("hold", replicas,
                                "shrink cooldown (%.2fs/%.2fs)"
                                % (now - self._last_shrink,
                                   self.shrink_cooldown_s), signals)
            return Decision("shrink", replicas - 1,
                            "idle below band for >= %.2fs"
                            % self.sustain_s, signals)
        # IN-BAND: the hysteresis gap. Reset both sustain timers — a
        # brief excursion must re-earn its full sustain window.
        self._above_since = self._below_since = None
        return Decision("hold", replicas, "in-band", signals)

    def note_scaled(self, direction: str, now: Optional[float] = None):
        """Stamp the cooldown for a move that actually LANDED (called by
        the actuator, never by :meth:`decide`) and reset the sustain
        timers — the post-scale signal must re-earn its window."""
        now = time.monotonic() if now is None else now
        if direction == "grow":
            self._last_grow = now
        elif direction == "shrink":
            self._last_shrink = now
        self._above_since = self._below_since = None


def lint_policy(policy: AutoscalePolicy, strategy=None,
                max_queue: Optional[int] = None, raise_on_error: bool = True):
    """Static soundness check of a policy against the strategy it will
    scale (``analysis/rules.verify_autoscale`` — ADT440/ADT441): a
    ``min_replicas`` below the fail-fast family's floor would drive the
    shrink path into checkpoint-fallback territory the planned-departure
    contract forbids. Returns the diagnostics; raises the first
    error-severity one as :class:`DiagnosticError` by default."""
    from autodist_tpu_torch.analysis import rules
    from autodist_tpu_torch.analysis.diagnostics import (DiagnosticError,
                                                         Severity, has_errors)
    diags = rules.verify_autoscale(policy, strategy=strategy,
                                   max_queue=max_queue)
    if raise_on_error and has_errors(diags):
        raise DiagnosticError(next(d for d in diags
                                   if d.severity >= Severity.ERROR))
    return diags


class FleetAutoscaler:
    """The actuating half: signals -> :class:`AutoscalePolicy` ->
    elastic actuators, epoch-fenced.

    ``client`` is a coordination client on the service holding the
    membership epoch; ``worker`` is this controller's identity (the
    chief — never chosen as a shrink victim); ``pool`` the spare worker
    addresses eligible for grow-on-join. ``scrape_workers`` arms the
    per-worker ``scrape_age_s`` signal via ``export.scrape_cluster`` in
    the JAX package; the port has no ``telemetry/export.py`` yet (ROADMAP A
    item 11), so giving it raises ``NotImplementedError``.
    ``signals_fn`` overrides signal collection entirely (tests, remote
    controllers)."""

    def __init__(self, client, policy: AutoscalePolicy, worker: str,
                 pool: Sequence[str] = (),
                 scrape_workers: Optional[Sequence[str]] = None,
                 signals_fn: Optional[Callable[[], AutoscaleSignals]] = None,
                 notice_deadline_s: Optional[float] = None,
                 strategy=None, max_queue: Optional[int] = None):
        if scrape_workers:
            raise NotImplementedError(
                "FleetAutoscaler(scrape_workers=...): the fleet scrape "
                "(telemetry/export.scrape_cluster) is not ported yet "
                "(ROADMAP A item 11)")
        self._client = client
        self.policy = policy
        self.worker = worker
        self.pool = list(pool)
        self._signals_fn = signals_fn or self._default_signals
        self._notice_deadline_s = notice_deadline_s
        self._stop: Optional[threading.Event] = None
        self._thread: Optional[threading.Thread] = None
        self._stats = {"decisions": 0, "grows": 0, "shrinks": 0,
                       "holds": 0, "refusals": 0, "fenced": 0,
                       "epoch": None, "replicas": None, "last": None}
        self._stats_lock = threading.Lock()
        # unsound bounds fail at CONSTRUCTION, not at the 3 a.m. shrink
        lint_policy(policy, strategy=strategy, max_queue=max_queue)

    # ------------------------------------------------------------- signals

    @staticmethod
    def _default_signals() -> AutoscaleSignals:
        from autodist_tpu_torch.serving import batcher as batcher_lib
        depth = 0.0
        fill_n = fill_b = 0
        for mb in batcher_lib.active_batchers():
            local = mb.stats_local
            depth += mb.queue_depth()
            fill_n += local.get("fan_out", 0)
            fill_b += local.get("batches", 0)
        if not batcher_lib.active_batchers():
            depth = tel.gauges().get("serve.queue_depth", 0.0)
        # decode-tier signals (continuous batching, serving/decode.py):
        # queued prompts join the shared backlog; throughput/occupancy
        # aggregate over live engines, falling back to the gauges a
        # remote scrape would have merged
        from autodist_tpu_torch.serving import decode as decode_lib
        decoders = decode_lib.active_decoders()
        tokens_per_s = None
        occupancy = None
        if decoders:
            rates = [d.tokens_per_s() for d in decoders]
            rates = [r for r in rates if r is not None]
            tokens_per_s = sum(rates) if rates else None
            occupancy = (sum(d.scheduler.occupancy() for d in decoders)
                         / len(decoders))
            depth += sum(d.queue_depth() for d in decoders)
        else:
            g = tel.gauges()
            tokens_per_s = g.get("serve.tokens_per_s")
            occupancy = g.get("serve.slot_occupancy")
        return AutoscaleSignals(
            queue_depth=depth,
            p99_ms=tel.hist_quantile("serve.latency_ms", 0.99),
            batch_fill=(fill_n / fill_b) if fill_b else None,
            tokens_per_s=tokens_per_s,
            slot_occupancy=occupancy)

    def signals(self) -> AutoscaleSignals:
        return self._signals_fn()

    # -------------------------------------------------------------- loop

    def step(self, now: Optional[float] = None) -> Decision:
        """One control iteration: sample -> decide -> (fenced) actuate.
        A :class:`FencedOut` from the actuation is DROPPED here — the
        epoch moved under the decision, so the decision is void and the
        next iteration re-reads the world; it never half-applies."""
        from autodist_tpu_torch.runtime.elastic import FencedOut, read_epoch
        now = time.monotonic() if now is None else now
        info = read_epoch(self._client)
        if info is None:
            raise RuntimeError(
                "autoscale: no membership epoch published — the fleet "
                "has no roster to scale (publish_epoch first)")
        epoch, roster = info
        sig = self.signals()
        decision = self.policy.decide(sig, replicas=len(roster), now=now)
        with tel.span("autoscale.decision", "autoscale",
                      direction=decision.direction, epoch=epoch,
                      replicas=len(roster), reason=decision.reason,
                      **(sig.to_dict())):
            try:
                decision = self._actuate(decision, epoch, roster, now)
            except FencedOut as e:
                from autodist_tpu_torch.telemetry import blackbox
                tel.instant("autoscale.fenced", "autoscale", op=e.op,
                            mine=e.my_epoch, current=e.current_epoch)
                blackbox.record("autoscale.fenced", op=e.op,
                                mine=e.my_epoch, current=e.current_epoch)
                logging.warning("autoscale: decision dropped — %s", e)
                with self._stats_lock:
                    self._stats["fenced"] += 1
                decision = Decision("hold", len(roster),
                                    "fenced out: %s" % e, sig)
        with self._stats_lock:
            self._stats["decisions"] += 1
            self._stats["epoch"] = epoch
            self._stats["replicas"] = len(roster)
            self._stats["last"] = decision.to_dict()
        return decision

    def _fence(self, op: str, observed_epoch: int, roster: Sequence[str]):
        """The decision was computed against ``observed_epoch``; refuse
        to actuate against any other — a racing controller (or the
        chief's own watchdog) moved the fleet first, and applying a
        stale verdict on top would double-scale. Also honors the
        process-ambient membership fence (a fenced zombie process must
        not scale anything)."""
        from autodist_tpu_torch.runtime import elastic
        elastic.maybe_fence(op)
        current = elastic.read_epoch(self._client)
        if current is not None and current[0] != observed_epoch:
            raise elastic.FencedOut(op, observed_epoch, current[0],
                                    worker=self.worker, roster=roster)

    def _actuate(self, decision: Decision, epoch: int,
                 roster: Sequence[str], now: float) -> Decision:
        from autodist_tpu_torch.telemetry import blackbox
        if decision.direction == "grow":
            candidate = self._grow_candidate(list(roster))
            if candidate is None:
                tel.counter_add("autoscale.holds")
                return Decision("hold", len(roster),
                                "no admissible grow candidate "
                                "(pool exhausted or pending notices)",
                                decision.signals)
            self._fence("autoscale.grow", epoch, roster)
            from autodist_tpu_torch.runtime import elastic
            new_epoch = elastic.admit_worker(self._client, candidate)
            self.policy.note_scaled("grow", now)
            tel.counter_add("autoscale.grows")
            with self._stats_lock:
                self._stats["grows"] += 1
            blackbox.record("autoscale.grow", worker=candidate,
                            epoch=new_epoch, replicas=len(roster) + 1,
                            reason=decision.reason)
            logging.warning("autoscale: grew fleet to %d replicas "
                            "(admitted %s at epoch %d): %s",
                            len(roster) + 1, candidate, new_epoch,
                            decision.reason)
            return decision
        if decision.direction == "shrink":
            leaver = self._shrink_victim(list(roster))
            if leaver is None:
                tel.counter_add("autoscale.holds")
                return Decision("hold", len(roster),
                                "no shrinkable replica (controller is "
                                "the only member)", decision.signals)
            self._fence("autoscale.shrink", epoch, roster)
            from autodist_tpu_torch.runtime import preemption
            preemption.retire_worker(self._client, leaver,
                                     deadline_s=self._notice_deadline_s,
                                     reason="autoscale-idle")
            self.policy.note_scaled("shrink", now)
            tel.counter_add("autoscale.shrinks")
            with self._stats_lock:
                self._stats["shrinks"] += 1
            blackbox.record("autoscale.shrink", worker=leaver,
                            replicas=len(roster) - 1,
                            reason=decision.reason)
            logging.warning("autoscale: shrinking fleet to %d replicas "
                            "(retiring %s via planned departure): %s",
                            len(roster) - 1, leaver, decision.reason)
            return decision
        tel.counter_add("autoscale.holds")
        with self._stats_lock:
            self._stats["holds"] += 1
        return decision

    def _grow_candidate(self, roster: List[str]) -> Optional[str]:
        """First pool worker not already in the roster and NOT under a
        pending preemption notice — growing onto a host the platform is
        about to take would be a scale event that immediately unwinds
        (refusals counted, so the blocked state is visible)."""
        from autodist_tpu_torch.runtime import elastic, preemption
        from autodist_tpu_torch.telemetry import blackbox
        candidates = [w for w in self.pool if w not in roster]
        # a worker that ASKED for admission (announce_join) goes first —
        # it is provisioned and waiting, not a cold spare
        candidates.sort(key=lambda w: not elastic.pending_join(
            self._client, w))
        for cand in candidates:
            if preemption.read_notice(self._client, cand) is not None:
                tel.counter_add("autoscale.refusals")
                tel.instant("autoscale.refusal", "autoscale", worker=cand)
                blackbox.record("autoscale.refusal", worker=cand,
                                why="pending preemption notice")
                with self._stats_lock:
                    self._stats["refusals"] += 1
                logging.warning("autoscale: refusing to grow onto %s — "
                                "pending preemption notice", cand)
                continue
            return cand
        return None

    def _shrink_victim(self, roster: List[str]) -> Optional[str]:
        """Last non-controller roster member — LIFO, so the longest-
        standing members (the launch roster, the chief) outlive the
        surge capacity that joined them."""
        for w in reversed(roster):
            if w != self.worker:
                return w
        return None

    # ------------------------------------------------------------- thread

    def start(self, poll_s: Optional[float] = None) -> "FleetAutoscaler":
        """Run :meth:`step` on a daemon thread every ``poll_s``
        (default ``ADT_AUTOSCALE_POLL_S``). Errors are logged and the
        loop keeps polling — a controller blip must not freeze the
        fleet at its current size forever silently."""
        period = (const.ENV.ADT_AUTOSCALE_POLL_S.val
                  if poll_s is None else float(poll_s))
        self._stop = threading.Event()

        def run():
            while not self._stop.is_set():
                try:
                    self.step()
                except Exception as e:  # noqa: BLE001 — keep polling
                    logging.warning("autoscale: step failed (%s)", e)
                self._stop.wait(period)

        self._thread = threading.Thread(target=run, name="adt-autoscale",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if self._stop is not None:
            self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    # -------------------------------------------------------------- stats

    def stats(self) -> dict:
        """Stable-key controller accounting (the ``autoscale`` sub-dict
        shape ``MicroBatcher.stats()`` mirrors from the counters)."""
        with self._stats_lock:
            return dict(self._stats)


def stats_snapshot() -> dict:
    """Process-wide autoscale accounting from the pre-registered
    counters — stable keys whether or not a controller runs in this
    process (``MicroBatcher.stats()["autoscale"]``)."""
    c = tel.counters()
    return {"grows": c.get("autoscale.grows", 0.0),
            "shrinks": c.get("autoscale.shrinks", 0.0),
            "holds": c.get("autoscale.holds", 0.0),
            "refusals": c.get("autoscale.refusals", 0.0)}
