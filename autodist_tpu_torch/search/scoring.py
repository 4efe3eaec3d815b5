"""Candidate scoring for the auto-strategy search.

The port's copy of ``autodist_tpu/search/scoring.py``.

Every candidate passes a three-stage pipeline — with **no trace, lower or
compile anywhere**:

1. ``analysis.verify`` (via :meth:`Simulator.verify`): error-severity
   diagnostics prune the candidate (pricing an un-compilable plan would
   hand the search a winner that explodes at lowering time);
2. ``CostModel.estimate`` through the shared :class:`Simulator` — so a
   fitted :class:`~autodist_tpu_torch.simulator.calibration.Calibration` and any
   attached :class:`~autodist_tpu_torch.simulator.cost_model.
   StaticCollectiveProfile` (measured wire bytes) price the candidate
   exactly as ``Simulator.rank`` would;
3. the plan-level ADT501 projected-OOM gate (``analysis/memory.py``
   ``budget_diagnostics`` over the estimate's HBM terms): a fast plan
   that OOMs is not a plan.

The returned score is the ranking key ``Simulator.rank`` sorts by —
estimated step seconds times the lossy-compression risk premium — so the
search and the zoo ranking can never disagree about which plan is better.
"""
import dataclasses
from typing import Optional

from autodist_tpu_torch.simulator.simulator import Simulator, _risk_premium
from autodist_tpu_torch.strategy.base import Strategy
from autodist_tpu_torch.telemetry import spans as tel


@dataclasses.dataclass
class ScoreRecord:
    """One scored (or pruned) candidate."""
    label: str
    score_s: float = float("inf")        # ranking key (premium-adjusted)
    step_time_s: float = float("inf")    # physical estimate
    pruned: Optional[str] = None         # "verify:ADT302" | "oom:ADT501"
    detail: str = ""                     # first diagnostic, for the trace
    breakdown: Optional[object] = None   # CostBreakdown when priced

    @property
    def ok(self) -> bool:
        return self.pruned is None


def zoo_best(model_item, resource_spec, sim: Simulator):
    """``(label, premium-adjusted score seconds, SimulationResult)`` of
    the best zoo candidate under ``sim`` — the comparison baseline the
    search CLI, the bench legs, and the tests all quote, in one place so
    the ranking key can never diverge between them. ``(None, None,
    None)`` when no zoo candidate builds or survives the OOM skip."""
    from autodist_tpu_torch.strategy.auto_strategy import default_candidates
    built = []
    for label, builder in default_candidates():
        try:
            built.append((label, builder.build(model_item, resource_spec)))
        except Exception:  # noqa: BLE001 — inapplicable builders drop out
            continue
    ranking = sim.rank(built, skip_projected_oom=True)
    if not ranking:
        return None, None, None
    best = ranking[0]
    return best.label, best.step_time_s * _risk_premium(best.strategy), best


class PlanScorer:
    """Shared scoring state: one :class:`Simulator` (its cost model
    caches the loss trace), plus candidate/prune counters surfaced to
    telemetry and the search trace."""

    def __init__(self, model_item, resource_spec, simulator: Optional[Simulator] = None,
                 **cost_model_kwargs):
        self.sim = simulator or Simulator(model_item, resource_spec,
                                          **cost_model_kwargs)
        self._item = model_item
        self._spec = resource_spec
        self.scored = 0
        self.pruned = 0

    def score(self, label: str, strategy: Strategy) -> ScoreRecord:
        from autodist_tpu_torch.analysis.diagnostics import Severity
        from autodist_tpu_torch.analysis.memory import budget_diagnostics
        with tel.span("search.score", cat="search", label=label):
            self.scored += 1
            tel.counter_add("search.candidates")
            errs = [d for d in self.sim.verify(strategy)
                    if d.severity >= Severity.ERROR]
            if errs:
                self.pruned += 1
                tel.counter_add("search.pruned")
                return ScoreRecord(label=label,
                                   pruned="verify:%s" % errs[0].code,
                                   detail=errs[0].format())
            res = self.sim.simulate(strategy, label)
            oom = [d for d in budget_diagnostics(
                res.breakdown.hbm_bytes, res.breakdown.hbm_capacity,
                source="plan-level") if d.code == "ADT501"]
            if oom:
                self.pruned += 1
                tel.counter_add("search.pruned")
                return ScoreRecord(label=label, pruned="oom:ADT501",
                                   detail=oom[0].format(),
                                   step_time_s=res.step_time_s,
                                   breakdown=res.breakdown)
            return ScoreRecord(
                label=label,
                score_s=res.step_time_s * _risk_premium(strategy),
                step_time_s=res.step_time_s,
                breakdown=res.breakdown)
