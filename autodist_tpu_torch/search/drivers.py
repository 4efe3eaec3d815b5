"""Search drivers: beam search and simulated annealing over plan mutations.

The port's copy of ``autodist_tpu/search/drivers.py``.

Both drivers walk the :class:`~autodist_tpu_torch.search.space.PlanSpace` under
one caller-seeded ``random.Random`` — fixed seed ⇒ identical visit order,
identical chosen plan, identical dumped trace — and share one candidate
budget measured in **scored candidates** (every score is one verify + one
cost-model estimate; nothing is ever traced, lowered or compiled). Beam
is the default: breadth against the zoo-family seeds, `branch` mutations
per member per round, early stop after `patience` rounds without
improvement. Annealing is the escape hatch for spaces where single
mutations must pass through a worse plan to reach a better one; ``both``
runs beam first and anneals from its winner with the remaining budget.
"""
import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

from autodist_tpu_torch.search.scoring import PlanScorer, ScoreRecord
from autodist_tpu_torch.search.space import PlanSpace, PlanSpec
from autodist_tpu_torch.search.trace import SearchTrace
from autodist_tpu_torch.strategy.base import Strategy
from autodist_tpu_torch.telemetry import spans as tel
from autodist_tpu_torch.utils import logging

_ALGOS = ("beam", "anneal", "both")


@dataclasses.dataclass
class SearchConfig:
    """Knobs of one search run; serialized into the trace header so a
    dumped trace is sufficient to reproduce the run."""
    algo: str = "beam"
    budget: int = 128        # max scored candidates (seeds included)
    beam_width: int = 4
    branch: int = 6          # mutations per beam member per round
    patience: int = 3        # rounds without improvement before stopping
    seed: int = 0
    init_temp: float = 0.3   # annealing temperature, relative to score
    cooling: float = 0.92

    def __post_init__(self):
        if self.algo not in _ALGOS:
            raise ValueError("algo must be one of %s, got %r"
                             % (_ALGOS, self.algo))
        for knob in ("budget", "beam_width", "branch", "patience"):
            if getattr(self, knob) < 1:
                raise ValueError("%s must be >= 1" % knob)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "SearchConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclasses.dataclass
class SearchResult:
    """Outcome of :func:`run_search`. ``plan``/``strategy`` are ``None``
    only when every candidate was pruned (caller falls back to the zoo)."""
    plan: Optional[PlanSpec]
    strategy: Optional[Strategy]
    record: Optional[ScoreRecord]
    trace: SearchTrace
    wall_s: float = 0.0
    candidates: int = 0
    pruned: int = 0

    @property
    def ok(self) -> bool:
        return self.strategy is not None


class _Search:
    """Shared driver state: dedup table, label counter, budget."""

    def __init__(self, space: PlanSpace, scorer: PlanScorer,
                 trace: SearchTrace, rng, budget: int):
        self.space = space
        self.scorer = scorer
        self.trace = trace
        self.rng = rng
        self.budget = budget
        self.evaluated: Dict[PlanSpec, ScoreRecord] = {}

    def budget_left(self) -> int:
        return self.budget - self.scorer.scored

    def evaluate(self, plan: PlanSpec, algo: str, op: Optional[str] = None,
                 parent: Optional[str] = None
                 ) -> Optional[Tuple[ScoreRecord, bool]]:
        """Score one plan: ``(record, was_duplicate)``, or ``None`` when
        the budget is exhausted (the driver's stop signal)."""
        cached = self.evaluated.get(plan)
        if cached is not None:
            self.trace.record("dup", label=cached.label, algo=algo, op=op,
                              parent=parent)
            return cached, True
        if self.budget_left() <= 0:
            return None
        label = "c%03d" % self.scorer.scored
        record = self.scorer.score(label, self.space.build(plan))
        self.evaluated[plan] = record
        self.trace.record_score(label, record, algo=algo, op=op,
                                parent=parent)
        return record, False


def _beam_phase(S: _Search, cfg: SearchConfig,
                seeds: List[Tuple[PlanSpec, ScoreRecord]]
                ) -> Optional[Tuple[PlanSpec, ScoreRecord]]:
    beam = sorted((pr for pr in seeds if pr[1].ok),
                  key=lambda pr: pr[1].score_s)[:cfg.beam_width]
    if not beam:
        return None
    best = beam[0]
    stale = 0
    while S.budget_left() > 0:
        children: List[Tuple[PlanSpec, ScoreRecord]] = []
        for plan, rec in list(beam):
            for _ in range(cfg.branch):
                if S.budget_left() <= 0:
                    break
                mut = S.space.mutate(plan, S.rng)
                if mut is None:
                    continue
                child, op = mut
                out = S.evaluate(child, algo="beam", op=op,
                                 parent=rec.label)
                if out is None:
                    break
                rec2, dup = out
                if not dup and rec2.ok:
                    children.append((child, rec2))
        if not children:
            break  # budget gone, space exhausted, or all pruned
        pool = sorted(beam + children, key=lambda pr: pr[1].score_s)
        seen, beam = set(), []
        for p, r in pool:
            if p in seen:
                continue
            seen.add(p)
            beam.append((p, r))
            if len(beam) >= cfg.beam_width:
                break
        if beam[0][1].score_s < best[1].score_s - 1e-12:
            best = beam[0]
            stale = 0
        else:
            stale += 1
            if stale >= cfg.patience:
                break
    return best


def _anneal_phase(S: _Search, cfg: SearchConfig,
                  start: Tuple[PlanSpec, ScoreRecord]
                  ) -> Tuple[PlanSpec, ScoreRecord]:
    cur = best = start
    temp = cfg.init_temp
    attempts, max_attempts = 0, max(cfg.budget * 4, 64)
    while S.budget_left() > 0 and attempts < max_attempts:
        attempts += 1
        mut = S.space.mutate(cur[0], S.rng)
        if mut is None:
            break
        child, op = mut
        out = S.evaluate(child, algo="anneal", op=op, parent=cur[1].label)
        if out is None:
            break
        rec, _dup = out
        if rec.ok:
            worse_by = rec.score_s - cur[1].score_s
            accept = (worse_by <= 0
                      or S.rng.random() < math.exp(
                          -worse_by / max(cur[1].score_s * temp, 1e-12)))
            if accept:
                cur = (child, rec)
                S.trace.record("accept", label=rec.label, algo="anneal",
                               score_ms=round(rec.score_s * 1e3, 6))
                if rec.score_s < best[1].score_s:
                    best = cur
        temp *= cfg.cooling
    return best


def run_search(model_item, resource_spec,
               config: Optional[SearchConfig] = None,
               simulator=None,
               extra_seeds: Sequence[Tuple[str, Strategy]] = (),
               trace_path: Optional[str] = None,
               **cost_model_kwargs) -> SearchResult:
    """Synthesize a per-variable strategy for ``model_item`` on
    ``resource_spec``.

    ``simulator`` shares a caller's :class:`Simulator` (and therefore its
    calibration, static profiles, and cached loss trace) — this is how
    ``AutoStrategy`` guarantees the search and the zoo ranking price
    candidates identically. ``extra_seeds`` takes built ``(label,
    Strategy)`` pairs (the zoo candidates); those expressible in the
    per-variable space join the seed pool. ``trace_path`` dumps the
    deterministic search trace as JSON.
    """
    cfg = config or SearchConfig()
    import random
    t0 = time.perf_counter()
    space = PlanSpace(model_item, resource_spec)
    scorer = PlanScorer(model_item, resource_spec, simulator=simulator,
                        **cost_model_kwargs)
    trace = SearchTrace(header={
        "config": cfg.to_dict(),
        "vars": len(space.var_names),
        "devices": space.n_replicas,
    })
    rng = random.Random(cfg.seed)
    S = _Search(space, scorer, trace, rng, cfg.budget)

    with tel.span("search.run", cat="search", algo=cfg.algo,
                  budget=cfg.budget):
        seed_pool = list(space.seeds())
        for label, strategy in extra_seeds:
            plan = space.from_strategy(strategy)
            if plan is not None:
                seed_pool.append(("seed:zoo:%s" % label, plan))
        seeds: List[Tuple[PlanSpec, ScoreRecord]] = []
        for slabel, plan in seed_pool:
            out = S.evaluate(plan, algo="seed", op=slabel)
            if out is None:
                break
            rec, dup = out
            if not dup:
                seeds.append((plan, rec))

        best: Optional[Tuple[PlanSpec, ScoreRecord]] = None
        if cfg.algo in ("beam", "both"):
            best = _beam_phase(S, cfg, seeds)
        if cfg.algo in ("anneal", "both"):
            start = best or min((pr for pr in seeds if pr[1].ok),
                                key=lambda pr: pr[1].score_s, default=None)
            if start is not None:
                annealed = _anneal_phase(S, cfg, start)
                if best is None or annealed[1].score_s < best[1].score_s:
                    best = annealed

    wall_s = time.perf_counter() - t0
    tel.gauge_set("search.candidates_per_s",
                  scorer.scored / max(wall_s, 1e-9))
    trace.result = {
        "candidates": scorer.scored,
        "pruned": scorer.pruned,
        "prune_reasons": trace.prune_reasons(),
    }
    if best is None:
        trace.result["chosen"] = None
        logging.warning(
            "auto-search: every one of %d candidate(s) was pruned "
            "(%s); no per-variable plan to offer",
            scorer.scored, trace.result["prune_reasons"] or "none scored")
        return SearchResult(plan=None, strategy=None, record=None,
                            trace=trace, wall_s=wall_s,
                            candidates=scorer.scored, pruned=scorer.pruned)
    plan, record = best
    trace.result.update(
        chosen=record.label, plan=plan.describe(),
        score_ms=round(record.score_s * 1e3, 6),
        step_time_ms=round(record.step_time_s * 1e3, 6))
    if trace_path:
        trace.dump(trace_path)
    logging.info(
        "auto-search(%s): %s -> %s est %.3f ms/step "
        "(%d candidates, %d pruned, %.2fs, %.0f cand/s)",
        cfg.algo, record.label, plan.describe(),
        record.step_time_s * 1e3, scorer.scored, scorer.pruned, wall_s,
        scorer.scored / max(wall_s, 1e-9))
    return SearchResult(plan=plan, strategy=space.build(plan),
                        record=record, trace=trace, wall_s=wall_s,
                        candidates=scorer.scored, pruned=scorer.pruned)
