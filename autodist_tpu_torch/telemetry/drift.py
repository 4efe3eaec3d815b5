"""Cost-model drift: measured runtime vs analytic prediction (PyTorch
counterpart of ``autodist_tpu/telemetry/drift.py``).

The simulator predicts (``CostModel.estimate``), a static profile of the
lowered program measures what the LOWERING emits
(``StaticCollectiveProfile``), and the telemetry recorder measures what
the RUNTIME does (span durations, wire-byte counters). This module joins
the three into a :class:`DriftReport`:

- **per-collective rows**: heuristic wire bytes (the traced pricing the
  cost model falls back to) vs the lowering's measured per-class wire
  bytes — the drift `attach_static_profile` corrects;
- **per-term rows**: predicted seconds per step (compute / collective /
  host-PS / launch) vs measured seconds from the recorder's spans
  (dispatch wall time, PS pull/push time) and the PS store's byte
  counters;
- **a calibration feed**: :func:`fit_calibration` hands the
  (breakdown, measured step seconds) pairs to
  ``simulator/calibration.fit_auto_span`` so ``Simulator.rank`` and
  ``AutoStrategy(calibration=...)`` re-rank with measured coefficients —
  the measure→calibrate loop closed.

Reports serialize to JSON (``save``/``load``) and pretty-print as a
table (``format_table``; also ``python -m autodist_tpu_torch.telemetry drift
report.json``).

:func:`report_for_runner` takes the static profile from the runner's own
program (``Runner.static_profile``, the step recorded op by op) when
given a ``batch``, and builds the report from the timing terms alone
without one, as the JAX function does.
"""
import dataclasses
import json
import statistics
from typing import Dict, List, Optional

from autodist_tpu_torch.telemetry import spans as spans_lib
from autodist_tpu_torch.utils import logging

# the span whose duration is "one dispatch" — Runner.run / run_superstep
DISPATCH_SPAN = "runner.dispatch"
PS_SPANS = ("ps.pull", "ps.push")


@dataclasses.dataclass
class CollectiveDrift:
    """One collective class: heuristic (predicted) vs lowering-measured
    wire bytes per step."""
    kind: str
    predicted_wire_bytes: float
    measured_wire_bytes: float

    @property
    def ratio(self) -> float:
        if self.predicted_wire_bytes > 0:
            return self.measured_wire_bytes / self.predicted_wire_bytes
        return float("inf") if self.measured_wire_bytes > 0 else 1.0

    def to_dict(self) -> dict:
        return dict(kind=self.kind,
                    predicted_wire_bytes=round(self.predicted_wire_bytes),
                    measured_wire_bytes=round(self.measured_wire_bytes),
                    ratio=(round(self.ratio, 4)
                           if self.ratio != float("inf") else None))


@dataclasses.dataclass
class TermDrift:
    """One cost-model term: predicted vs runtime-measured seconds per
    step (``measured_s`` None when the recorder saw no samples)."""
    term: str
    predicted_s: float
    measured_s: Optional[float]

    @property
    def ratio(self) -> Optional[float]:
        if self.measured_s is None:
            return None
        if self.predicted_s > 0:
            return self.measured_s / self.predicted_s
        return float("inf") if self.measured_s > 0 else 1.0

    def to_dict(self) -> dict:
        r = self.ratio
        return dict(term=self.term, predicted_s=round(self.predicted_s, 9),
                    measured_s=(round(self.measured_s, 9)
                                if self.measured_s is not None else None),
                    ratio=(round(r, 4)
                           if r not in (None, float("inf")) else None))


@dataclasses.dataclass
class DriftReport:
    strategy_id: str
    num_steps: int
    predicted_step_s: float
    measured_step_s: Optional[float]
    terms: List[TermDrift]
    collectives: List[CollectiveDrift]
    breakdown: dict                      # CostBreakdown fields, serialized
    counters: Dict[str, float]
    # attributed wall-time buckets (telemetry/goodput.py) the term rows
    # were joined against — None when the recorder had no decomposable
    # spans (tracing off / sampled)
    goodput: Optional[dict] = None
    # quantized-wire accounting (wire.* counters): quantized payload
    # bytes, bytes saved vs full width, the resulting reduction factor,
    # and the per-step quantized payload — None when no quantized wire
    # crossed during the window
    wire: Optional[dict] = None
    # per-link-level bytes (topology-aware): plan-level predicted bytes
    # per level (analysis/topology.plan_level_bytes) joined against the
    # static profile's measured per-level rows — None when the spec
    # declares no multi-level topology. Each row: {level, predicted_bytes,
    # measured_bytes, ratio}
    levels: Optional[List[dict]] = None

    @property
    def step_ratio(self) -> Optional[float]:
        if self.measured_step_s is None or self.predicted_step_s <= 0:
            return None
        return self.measured_step_s / self.predicted_step_s

    def to_dict(self) -> dict:
        return {
            "strategy_id": self.strategy_id,
            "num_steps": self.num_steps,
            "predicted_step_s": round(self.predicted_step_s, 9),
            "measured_step_s": (round(self.measured_step_s, 9)
                                if self.measured_step_s is not None
                                else None),
            "step_ratio": (round(self.step_ratio, 4)
                           if self.step_ratio is not None else None),
            "terms": [t.to_dict() for t in self.terms],
            "collectives": [c.to_dict() for c in self.collectives],
            "breakdown": self.breakdown,
            "counters": self.counters,
            "goodput": self.goodput,
            "wire": self.wire,
            "levels": self.levels,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "DriftReport":
        """Inverse of :meth:`to_dict` — the ONE deserialization point
        (the CLI's ``drift`` subcommand loads through this, so a schema
        change lives here, next to the serializer)."""
        return cls(
            strategy_id=d.get("strategy_id", "?"),
            num_steps=d.get("num_steps", 0),
            predicted_step_s=d.get("predicted_step_s", 0.0),
            measured_step_s=d.get("measured_step_s"),
            terms=[TermDrift(t["term"], t["predicted_s"], t["measured_s"])
                   for t in d.get("terms", [])],
            collectives=[CollectiveDrift(c["kind"],
                                         c["predicted_wire_bytes"],
                                         c["measured_wire_bytes"])
                         for c in d.get("collectives", [])],
            breakdown=d.get("breakdown", {}),
            counters=d.get("counters", {}),
            goodput=d.get("goodput"),
            wire=d.get("wire"),
            levels=d.get("levels"))

    def save(self, path: str) -> str:
        import os
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1, sort_keys=True)
        return path

    def format_table(self) -> str:
        d = self.to_dict()
        lines = ["drift report: strategy=%s steps=%d"
                 % (self.strategy_id, self.num_steps),
                 "  step time: predicted=%.6gs measured=%s ratio=%s"
                 % (self.predicted_step_s,
                    "%.6gs" % self.measured_step_s
                    if self.measured_step_s is not None else "-",
                    d["step_ratio"] if d["step_ratio"] is not None else "-"),
                 "  %-12s %14s %14s %8s" % ("term", "predicted_s",
                                            "measured_s", "ratio")]
        for t in d["terms"]:
            lines.append("  %-12s %14.6g %14s %8s"
                         % (t["term"], t["predicted_s"],
                            "%.6g" % t["measured_s"]
                            if t["measured_s"] is not None else "-",
                            t["ratio"] if t["ratio"] is not None else "-"))
        lines.append("  %-12s %14s %14s %8s"
                     % ("collective", "heuristic_B", "measured_B", "ratio"))
        for c in d["collectives"]:
            lines.append("  %-12s %14d %14d %8s"
                         % (c["kind"], c["predicted_wire_bytes"],
                            c["measured_wire_bytes"],
                            c["ratio"] if c["ratio"] is not None else "inf"))
        if self.wire:
            lines.append(
                "  quantized wire: %d B on the wire, %d B saved "
                "(%.2fx reduction, %.0f B/step)"
                % (self.wire.get("bytes_quantized", 0),
                   self.wire.get("bytes_saved", 0),
                   self.wire.get("reduction_x") or 1.0,
                   self.wire.get("per_step_quantized") or 0.0))
        if self.levels:
            lines.append("  %-12s %14s %14s %8s"
                         % ("level", "predicted_B", "measured_B", "ratio"))
            for row in self.levels:
                lines.append("  %-12s %14d %14s %8s"
                             % (row["level"], row["predicted_bytes"],
                                "%d" % row["measured_bytes"]
                                if row.get("measured_bytes") is not None
                                else "-",
                                row["ratio"] if row.get("ratio") is not None
                                else "-"))
        return "\n".join(lines)


def load_report(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


# ------------------------------------------------------------------ build


def _median(vals: List[float]) -> Optional[float]:
    return statistics.median(vals) if vals else None


def build_report(cost_model, strategy,
                 recorder: Optional[spans_lib.TraceRecorder] = None,
                 static_profile=None) -> DriftReport:
    """Join one strategy's cost-model prediction against what the
    recorder measured. ``static_profile`` (``Runner.static_profile`` /
    ``StaticCollectiveProfile``) supplies the measured per-collective
    wire bytes; without one the report still carries the timing terms."""
    rec = recorder if recorder is not None else spans_lib.get_recorder()
    breakdown = cost_model.estimate(strategy)
    counters = rec.counters()

    dispatch = rec.durations_s(DISPATCH_SPAN)
    num_steps = len(dispatch)
    measured_step = _median(dispatch)

    # host-PS seconds per step: total pull+push span time over dispatches
    ps_total = sum(sum(rec.durations_s(n)) for n in PS_SPANS)
    measured_ps = (ps_total / num_steps) if num_steps and ps_total else None

    # ATTRIBUTED time (telemetry/goodput.py): the self-time decomposition
    # splits each dispatch into compute vs nested wait/wire buckets, so
    # calibration consumes per-term measurements instead of fitting every
    # coefficient against one total — the compute term gets the dispatch
    # self time, the collective term the barrier/backoff wait
    from autodist_tpu_torch.telemetry import goodput as goodput_lib
    gp = goodput_lib.build_report(rec) if num_steps else None
    if gp is not None and (gp.wall_s <= 0 or gp.approximate):
        gp = None  # sampled/empty traces cannot be decomposed honestly
    measured_compute = (gp.buckets["compute"] / num_steps
                        if gp is not None else None)
    measured_wait = (gp.buckets["collective_wait"] / num_steps
                     if gp is not None and gp.buckets["collective_wait"] > 0
                     else None)

    terms = [
        TermDrift("step", breakdown.step_time_s, measured_step),
        TermDrift("compute", breakdown.compute_s, measured_compute),
        TermDrift("allreduce", breakdown.allreduce_s, measured_wait),
        TermDrift("ps", breakdown.ps_s, measured_ps),
        TermDrift("mp", breakdown.mp_s, None),
        TermDrift("latency", breakdown.latency_s, None),
    ]
    if breakdown.overlap:
        # under the overlap schedule the residual barrier wait IS the
        # exposed (un-hidden) collective tail — the predicted exposure
        # joins the same measurement the allreduce row consumes, so the
        # two rows together show how much wire the schedule actually hid
        terms.append(TermDrift("overlap", breakdown.overlap_exposed_s,
                               measured_wait))

    collectives: List[CollectiveDrift] = []
    if static_profile is not None:
        # reuse the cost model's own heuristic-by-class pricing so the
        # drift rows can never disagree with what estimate() replaced
        n = max(len(strategy.graph_config.replicas), 1)
        heur = _heuristic_wire(cost_model, strategy, n)
        measured = dict(static_profile.class_wire_bytes)
        for kind in sorted(set(heur) | set(measured)):
            collectives.append(CollectiveDrift(
                kind, heur.get(kind, 0.0), measured.get(kind, 0.0)))

    # quantized-wire rows (wire.* counters are credited by the lowering's
    # per-dispatch static accounting AND the PS store's boundary codec,
    # both via collectives.int8_wire_payload_bytes — the same formula the
    # cost model prices, so these rows expose measured-vs-priced drift)
    wq = counters.get("wire.bytes_quantized", 0.0)
    ws = counters.get("wire.bytes_saved", 0.0)
    wire = None
    if wq > 0:
        wire = {"bytes_quantized": round(wq),
                "bytes_saved": round(ws),
                "reduction_x": round((wq + ws) / wq, 4),
                "per_step_quantized": (round(wq / num_steps, 1)
                                       if num_steps else None)}

    # per-link-level rows (topology-aware): the plan-level prediction
    # (analysis/topology.plan_level_bytes, the same formulas the cost
    # model prices with) joined against the static profile's measured
    # per-level attribution — the drift row that shows whether the
    # hierarchical schedule actually moved its bytes off the slow level
    levels = None
    topo = (cost_model._spec.topology()
            if hasattr(cost_model._spec, "topology") else None)
    if topo is not None:
        from autodist_tpu_torch.analysis.topology import plan_level_bytes
        predicted = plan_level_bytes(strategy, cost_model._item, topo)
        measured_levels = (dict(getattr(static_profile, "level_wire_bytes",
                                        None) or {})
                           if static_profile is not None else {})
        levels = []
        for lv in topo.levels:
            p = predicted.get(lv.name, 0.0)
            m = measured_levels.get(lv.name)
            ratio = (round(m / p, 4) if m is not None and p > 0 else None)
            levels.append({"level": lv.name,
                           "predicted_bytes": round(p),
                           "measured_bytes": (round(m) if m is not None
                                              else None),
                           "ratio": ratio})

    report = DriftReport(
        strategy_id=getattr(strategy, "id", "?"),
        num_steps=num_steps,
        predicted_step_s=breakdown.step_time_s,
        measured_step_s=measured_step,
        terms=terms,
        collectives=collectives,
        breakdown={f.name: getattr(breakdown, f.name)
                   for f in dataclasses.fields(breakdown)},
        counters=counters,
        goodput=gp.to_dict() if gp is not None else None,
        wire=wire,
        levels=levels)
    logging.info("drift report [%s]: predicted=%.6gs measured=%s over %d "
                 "dispatches", report.strategy_id, report.predicted_step_s,
                 "%.6gs" % measured_step if measured_step is not None
                 else "n/a", num_steps)
    return report


def _heuristic_wire(cost_model, strategy, n) -> Dict[str, float]:
    """The cost model's per-class heuristic wire bytes (what a static
    profile replaces). The gradient all-reduce payload is re-derived by
    pricing the strategy with ``use_static_profile=False`` — the public
    heuristic-only estimate — then inverting the ring formula; the
    model-parallel classes come from the model's own traced profile."""
    # ar_bytes from the heuristic reduce seconds: the heuristic prices
    # reduce as 2(n-1)/n * ar_bytes / ici_bw
    bd = cost_model.estimate(strategy, use_static_profile=False)
    ici_bw = cost_model._spec.ici_bandwidth_gbps() * 1e9 / 8
    ar_bytes = (bd.allreduce_s * ici_bw / (2.0 * (n - 1) / n)
                if n > 1 and bd.allreduce_s > 0 else 0.0)
    return cost_model._heuristic_wire_by_class(strategy, n, ar_bytes)


def report_for_runner(runner, resource_spec=None, batch=None,
                      recorder: Optional[spans_lib.TraceRecorder] = None
                      ) -> DriftReport:
    """Convenience join for a live Runner: builds the CostModel from its
    model item + ``resource_spec`` (default: the local machine of the
    runner's device), takes the static profile from the runner's own
    program when ``batch`` is given (``Runner.static_profile``, with the
    spec's topology), and reads the global recorder."""
    from autodist_tpu_torch.resource_spec import ResourceSpec
    from autodist_tpu_torch.simulator.cost_model import CostModel
    dstep = runner.distributed_step
    spec = resource_spec or ResourceSpec.from_local(
        "cpu" if dstep.device.type == "cpu" else "cuda",
        replicas=dstep.num_replicas)
    cm = CostModel(dstep.model_item, spec)
    topo = spec.topology() if hasattr(spec, "topology") else None
    profile = (runner.static_profile(batch, topology=topo)
               if batch is not None else None)
    return build_report(cm, dstep.strategy, recorder=recorder,
                        static_profile=profile)


# ------------------------------------------------------------ calibration


def fit_calibration(reports: List[DriftReport]):
    """Feed measured step times into
    ``simulator/calibration.fit_auto_span``: one (CostBreakdown, measured
    seconds) pair per report that has a
    measurement. Returns the fitted ``Calibration`` — attach it via
    ``CostModel(calibration=...)`` / ``Simulator.calibrate`` so ranking
    runs on measured coefficients."""
    from autodist_tpu_torch.simulator import calibration as cal_lib
    from autodist_tpu_torch.simulator.cost_model import CostBreakdown
    breakdowns, measured = [], []
    for r in reports:
        if r.measured_step_s is None:
            continue
        breakdowns.append(CostBreakdown(**{
            k: v for k, v in r.breakdown.items()
            if k in {f.name for f in dataclasses.fields(CostBreakdown)}}))
        measured.append(r.measured_step_s)
    if not breakdowns:
        raise ValueError("no report carries a measured step time — run "
                         "steps with telemetry enabled first")
    return cal_lib.fit_auto_span(breakdowns, measured)
