"""Training health sentinel: the guards inside the step and the recovery
policy (PyTorch counterpart of ``autodist_tpu/runtime/sentinel.py``).

It guards the *update*: the NaN/Inf blowups, loss spikes and silent
gradient corruption that spoil a run while every collective and every
checkpoint write succeeds. Two halves, split by where the work happens:

- **Guards inside the step** (``kernel/graph_transformer.py``, armed
  when a policy is active): the step computes a verdict — the global
  gradient L2 norm, the NaN/Inf counts over the synced gradients and
  the updated parameters, the loss's finiteness — and on a bad verdict
  discards the update on the device (params, optimizer and compressor
  state keep their values through a ``torch.where``; the host-PS push is
  suppressed by the verdict riding the push's own copy). The verdict is
  four scalars in the metrics the runner already reads back: no extra
  dispatch and no extra device-to-host copy, and every input to it is
  all-reduced, so every rank of a multi-process run takes the same
  branch. A fused superstep stacks one verdict a microstep.

- **The host-side policy** (:class:`Sentinel`, driven by the Runner at
  its readback boundaries): it counts skips against a sliding-window
  budget, tracks an EWMA z-score of the loss for sustained spikes the
  finiteness guards cannot see, and escalates —

  1. **skip**: done inside the step already; the sentinel counts it.
  2. **rollback**: past the skip budget, or on a sustained loss spike,
     restore the newest checkpoint stamped healthy, rewind the step
     counters and widen the skip budget for the replayed window (a
     deterministic fault fires again on replay; the wider budget lets
     the run skip through a bounded bad region).
  3. **escalate**: a second rollback to the same checkpoint step halves
     the effective learning rate (the optimizer's updates scaled on the
     device and in the host store, without a rebuild); after
     ``max_rollbacks_per_step`` rollbacks at one step the run fails with
     :class:`TrainingDiverged`.

  While the verdict is bad the sentinel **quarantines** checkpoint saves
  (the savers consult ``Runner.sentinel_save_veto``), and every
  committed checkpoint carries a ``healthy`` stamp, so auto-resume and
  rollback never restore a poisoned state.

Every bad verdict, pending rollback, rollback and divergence is recorded
in the flight recorder (``telemetry/blackbox.py``), and a completed
rollback and the divergence dump it, so a run that dies leaves the
trail on disk.
``ADT_GRAD_FAULT_PLAN`` (``runtime/faultinject.py``) injects the faults
that drive the ladder end to end.
"""
import collections
import dataclasses
import json
import math
from typing import Optional

from autodist_tpu_torch import const
from autodist_tpu_torch.telemetry import blackbox
from autodist_tpu_torch.telemetry import spans as tel
from autodist_tpu_torch.utils import logging


class TrainingDiverged(RuntimeError):
    """Training is unrecoverable under the active :class:`SentinelPolicy`:
    the escalation ladder (skip -> rollback -> halve LR) is exhausted, or a
    rollback was required and no healthy checkpoint exists. Typed so a
    driver can tell a health failure from an infrastructure error."""


@dataclasses.dataclass
class SentinelPolicy:
    """Declarative health policy. The guards inside the step read only
    ``grad_norm_limit`` (fixed at build); everything else drives the
    host-side :class:`Sentinel`."""

    # -- skip budget: bad steps discarded in the step, counted on the host
    max_skips_per_window: int = 3
    window_steps: int = 100          # sliding window, in microsteps
    # -- guards: skip also when the global grad norm exceeds this (None:
    #    only NaN/Inf gate the select)
    grad_norm_limit: Optional[float] = None
    # -- sustained loss-spike detection (EWMA z-score over healthy losses)
    spike_zscore: float = 8.0
    ewma_alpha: float = 0.05
    spike_patience: int = 3          # consecutive spiking steps -> rollback
    min_history: int = 20            # EWMA warm-up before z-scores count
    # -- escalation ladder
    max_rollbacks_per_step: int = 3  # at ONE checkpoint step; then diverge
    # -- quarantine: veto checkpoint saves while the verdict is bad
    quarantine: bool = True
    enabled: bool = True

    def __post_init__(self):
        for name in ("max_skips_per_window", "window_steps",
                     "spike_patience", "min_history",
                     "max_rollbacks_per_step"):
            if int(getattr(self, name)) < 1:
                raise ValueError("SentinelPolicy.%s must be >= 1, got %r"
                                 % (name, getattr(self, name)))
        if not (0.0 < self.ewma_alpha <= 1.0):
            raise ValueError("SentinelPolicy.ewma_alpha must be in (0, 1], "
                             "got %r" % (self.ewma_alpha,))

    @classmethod
    def from_env(cls) -> Optional["SentinelPolicy"]:
        """Policy from ``ADT_SENTINEL``: unset/"0" -> None (off), "1" ->
        defaults, a JSON object -> keyword overrides."""
        raw = const.ENV.ADT_SENTINEL.val.strip()
        if raw in ("", "0", "off", "false", "False"):
            return None
        if raw.startswith("{"):
            return cls(**json.loads(raw))
        return cls()


def resolve_policy(sentinel) -> Optional[SentinelPolicy]:
    """One resolution rule shared by AutoDist and the Runner: ``None``
    defers to the environment (``ADT_SENTINEL``), ``False`` forces off,
    ``True`` is the default policy, a :class:`SentinelPolicy` is used as
    it is (its own ``enabled`` flag respected)."""
    if sentinel is None:
        policy = SentinelPolicy.from_env()
    elif sentinel is False:
        return None
    elif sentinel is True:
        policy = SentinelPolicy()
    elif isinstance(sentinel, SentinelPolicy):
        policy = sentinel
    else:
        raise TypeError("sentinel must be None, a bool, or a "
                        "SentinelPolicy; got %r" % (sentinel,))
    if policy is not None and not policy.enabled:
        return None
    return policy


class Sentinel:
    """Host-side policy engine. The Runner feeds it one metrics dict a
    MICROSTEP (at readback boundaries, in step order) through
    :meth:`observe`, and calls :meth:`maybe_act` at safe points (before a
    dispatch, after a readback): ``observe`` only updates state, so a
    rollback never fires from inside a metrics readback."""

    def __init__(self, policy: SentinelPolicy, runner):
        self.policy = policy
        self._runner = runner
        self._micro = 0                 # microsteps observed
        self._skip_steps = collections.deque()  # micro indexes of skips
        self.skips = 0
        self.rollbacks = 0
        self.lr_halvings = 0
        self.last_grad_norm: Optional[float] = None
        self._verdict_bad = False       # the last observed verdict
        self._pending_rollback: Optional[str] = None
        self._rollbacks_at = {}         # restored step -> rollback count
        self._budget_mult = 1           # widened after each rollback
        self.lr_scale = 1.0
        # EWMA of the loss over HEALTHY observations only (a bad step's
        # loss, possibly NaN, must not poison the baseline)
        self._ewma_mean: Optional[float] = None
        self._ewma_var = 0.0
        self._ewma_n = 0
        self._spike_streak = 0
        self._saver = None              # fit() attaches its saver
        # the wall time of the last rollback's restore, ms
        self.last_rollback_ms: Optional[float] = None

    # ------------------------------------------------------------ observe

    def observe(self, metrics) -> None:
        """Take in one microstep's host metrics (a readback boundary)."""
        self._micro += 1
        verdict = metrics.get("sentinel") if hasattr(metrics, "get") else None
        loss = metrics.get("loss") if hasattr(metrics, "get") else None
        loss = float(loss) if loss is not None else None
        if verdict is not None:
            self._observe_guarded(verdict, loss)
        elif loss is not None:
            # no guards in the step (step_fn mode, ADT420): loss-only
            # monitoring — a nonfinite loss cannot be skipped in the
            # step, so it goes straight to the rollback ladder
            if not math.isfinite(loss):
                tel.counter_add("sentinel.nan_steps")
                self._verdict_bad = True
                self._pend("nonfinite loss (unguarded program)")
            else:
                self._verdict_bad = False
                self._observe_loss(loss)

    def _observe_guarded(self, verdict, loss) -> None:
        ok = bool(int(verdict["ok"]))
        self.last_grad_norm = float(verdict["grad_norm"])
        if math.isfinite(self.last_grad_norm):
            tel.gauge_set("sentinel.grad_norm", self.last_grad_norm)
        if ok:
            self._verdict_bad = False
            if loss is not None and math.isfinite(loss):
                self._observe_loss(loss)
            return
        self._verdict_bad = True
        self.skips += 1
        tel.counter_add("sentinel.skips")
        if float(verdict.get("bad_grads", 0)) > 0 \
                or float(verdict.get("bad_params", 0)) > 0:
            tel.counter_add("sentinel.nan_steps")
        tel.instant("sentinel.skip", "sentinel", micro=self._micro,
                    grad_norm=self.last_grad_norm)
        # the black box keeps every BAD verdict (bounded): a postmortem
        # reads the health trajectory into the fatal verdict even when
        # tracing was off
        blackbox.record("sentinel.verdict", ok=False, micro=self._micro,
                        grad_norm=self.last_grad_norm,
                        bad_grads=float(verdict.get("bad_grads", 0)),
                        bad_params=float(verdict.get("bad_params", 0)))
        self._skip_steps.append(self._micro)
        horizon = self._micro - self.policy.window_steps
        while self._skip_steps and self._skip_steps[0] <= horizon:
            self._skip_steps.popleft()
        budget = self.policy.max_skips_per_window * self._budget_mult
        logging.warning(
            "sentinel: unhealthy step discarded in the step (grad_norm=%.3g,"
            " bad_grads=%s, bad_params=%s) — %d/%d skips in window",
            self.last_grad_norm, verdict.get("bad_grads"),
            verdict.get("bad_params"), len(self._skip_steps), budget)
        if len(self._skip_steps) > budget:
            self._pend("skip budget exhausted (%d skips in the last %d "
                       "microsteps, budget %d)"
                       % (len(self._skip_steps), self.policy.window_steps,
                          budget))

    def _observe_loss(self, loss: float) -> None:
        p = self.policy
        if self._ewma_mean is None:
            self._ewma_mean, self._ewma_n = loss, 1
            return
        std = math.sqrt(max(self._ewma_var, 0.0))
        z = abs(loss - self._ewma_mean) / (std + 1e-12)
        if self._ewma_n >= p.min_history and z > p.spike_zscore:
            self._spike_streak += 1
            logging.warning("sentinel: loss %.6g is %.1f sigma from the "
                            "EWMA baseline %.6g (streak %d/%d)", loss, z,
                            self._ewma_mean, self._spike_streak,
                            p.spike_patience)
            if self._spike_streak >= p.spike_patience:
                self._verdict_bad = True  # quarantine saves too
                self._pend("sustained loss spike (%d steps > %.1f sigma)"
                           % (self._spike_streak, p.spike_zscore))
            return  # a spiking loss must not drag the baseline up
        self._spike_streak = 0
        delta = loss - self._ewma_mean
        self._ewma_mean += p.ewma_alpha * delta
        self._ewma_var = ((1.0 - p.ewma_alpha)
                          * (self._ewma_var + p.ewma_alpha * delta * delta))
        self._ewma_n += 1

    def _pend(self, reason: str) -> None:
        if self._pending_rollback is None:
            self._pending_rollback = reason
            tel.instant("sentinel.rollback_pending", "sentinel",
                        reason=reason, micro=self._micro)
            blackbox.record("sentinel.rollback_pending", reason=reason,
                            micro=self._micro)

    # ---------------------------------------------------------------- act

    @property
    def quarantined(self) -> bool:
        """True while checkpoint saves must be vetoed: the last verdict
        was bad, or a rollback is pending."""
        return self.policy.quarantine and (
            self._verdict_bad or self._pending_rollback is not None)

    def healthy(self) -> bool:
        """The stamp a checkpoint committed NOW would carry."""
        return not (self._verdict_bad or self._pending_rollback is not None)

    def attach_saver(self, saver) -> None:
        if saver is not None:
            self._saver = saver

    def maybe_act(self) -> None:
        """Perform a pending rollback (or raise :class:`TrainingDiverged`
        when the ladder is exhausted). The Runner calls it at safe points
        only, never from inside a metrics readback."""
        if self._pending_rollback is None:
            return
        reason, self._pending_rollback = self._pending_rollback, None
        self._rollback(reason)

    def _ckpt_dir(self) -> str:
        if self._saver is not None:
            return self._saver.directory
        return const.ENV.ADT_CKPT_DIR.val

    def _rollback(self, reason: str) -> None:
        import time

        from autodist_tpu_torch.checkpoint import latest_checkpoint
        directory = self._ckpt_dir()
        with tel.span("sentinel.rollback", "sentinel", reason=reason):
            if self._saver is not None:
                # land any async write in flight, so the newest committed
                # (healthy) checkpoint is visible to the scan
                self._saver.wait()
            step, saver = latest_checkpoint(directory)
            if saver is None:
                self._diverge("sentinel rollback required (%s) but no "
                              "healthy committed checkpoint exists in %s "
                              "— enable periodic saves "
                              "(fit(save_every=...)) to make rollback "
                              "possible" % (reason, directory))
            count = self._rollbacks_at.get(step, 0) + 1
            self._rollbacks_at[step] = count
            if count > self.policy.max_rollbacks_per_step:
                self._diverge("sentinel rolled back to step %d %d times "
                              "(%s) — the escalation ladder (skip -> "
                              "rollback -> halve LR) is exhausted"
                              % (step, count - 1, reason))
            logging.warning("sentinel: ROLLBACK #%d to checkpoint step %d "
                            "(%s)", count, step, reason)
            blackbox.record("sentinel.rollback", step=int(step),
                            count=count, reason=reason)
            t0 = time.perf_counter()
            _, restored_step = saver.restore(self._runner)
            self.last_rollback_ms = (time.perf_counter() - t0) * 1e3
            # rewind the step counters to the restored step and widen the
            # skip budget: a deterministic fault fires again on replay,
            # and the wider window lets the run skip through a bounded bad
            # region instead of rolling back again and again
            self._runner._step_count = int(restored_step)
            self._budget_mult = 2 ** count
            self._skip_steps.clear()
            self._spike_streak = 0
            self._verdict_bad = False
            if count >= 2:
                self._halve_lr()
            self.rollbacks += 1
            tel.counter_add("sentinel.rollbacks")
        # a completed rollback is a black-box trigger: a run that later
        # dies (or quietly mistrains) leaves the what, when and why on disk
        blackbox.dump("sentinel rollback #%d" % self.rollbacks)

    def _diverge(self, message: str):
        """Record the fatal verdict, dump the black box (the postmortem
        artifact: its events carry the rollback and verdict trail, its
        span tail the last ``sentinel.rollback`` span when tracing was
        on), and raise the typed failure."""
        tel.instant("sentinel.diverged", "sentinel", reason=message)
        blackbox.record("sentinel.diverged", reason=message)
        blackbox.dump("training_diverged")
        raise TrainingDiverged(message)

    def _halve_lr(self) -> None:
        """Escalation: halve the EFFECTIVE learning rate by scaling the
        optimizer's updates — exact LR semantics for an update linear in
        lr (sgd, adam, ...), without a rebuild: the scale is the state's
        ``sync_state["sentinel"]["lr_scale"]`` (read on the device by the
        step, written here in place) and ``PSStore.update_scale`` (the
        host applies)."""
        self.lr_scale *= 0.5
        self.lr_halvings += 1
        tel.counter_add("sentinel.lr_halvings")
        logging.warning("sentinel: repeated rollback at the same step — "
                        "halving effective LR to %.4gx", self.lr_scale)
        runner = self._runner
        dstep = runner.distributed_step
        store = getattr(dstep, "ps_store", None)
        if store is not None:
            store.update_scale = self.lr_scale
        sync = getattr(runner.state, "sync_state", None)
        if not isinstance(sync, dict) or "sentinel" not in sync:
            if store is None:
                logging.warning(
                    "sentinel: the step carries no lr_scale (guards not "
                    "built?) — LR escalation is a no-op")
            return
        sync["sentinel"]["lr_scale"].fill_(self.lr_scale)

    # ------------------------------------------------------------- stats

    def stats(self) -> dict:
        """The stable ``step_stats()['sentinel']`` sub-dict."""
        return {"skips": self.skips, "rollbacks": self.rollbacks,
                "last_grad_norm": self.last_grad_norm,
                "quarantined": self.quarantined}
