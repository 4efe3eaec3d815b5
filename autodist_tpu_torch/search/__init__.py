"""Closed-loop auto-strategy search — per-variable plan synthesis.

The port's copy of ``autodist_tpu/search/__init__.py``.

The strategy-compiler half the source paper promised but the reference
never shipped: instead of ranking a fixed zoo of whole-graph templates,
this package *synthesizes* a strategy per variable — PS vs AllReduce
assignment, partition axis + shard count, gradient bucketing, compressor
choice — by searching plan mutations (beam or simulated annealing) scored
through the calibrated analytic :class:`~autodist_tpu_torch.simulator.cost_model.
CostModel` and pruned by ``analysis.verify`` + the ADT501 projected-OOM
gate **before any trace/lower/compile**.

Public surface:

- :func:`run_search` / :class:`SearchConfig` / :class:`SearchResult` —
  the drivers (``drivers.py``);
- :class:`PlanSpace` / :class:`PlanSpec` / :class:`VarChoice` — the typed
  candidate space and mutation operators (``space.py``);
- :class:`PlanScorer` / :class:`ScoreRecord` — verify → estimate →
  memory-gate scoring (``scoring.py``);
- :class:`SearchTrace` — the deterministic, dumpable run record
  (``trace.py``);
- ``python -m autodist_tpu.search`` — the JAX package's search CLI, whose
  counterpart here comes with the analysis CLI (ROADMAP A item 11).

``AutoStrategy(search=...)`` (``strategy/auto_strategy.py``) wires this in
as the default builder for unseen models: zoo candidates seed the search,
and the searched plan competes in the same ``Simulator.rank`` call, so it
wins exactly when the shared cost model says it is at least as fast.

Exports resolve lazily (PEP 562) to keep ``import autodist_tpu_torch`` light.
"""

__all__ = ["run_search", "SearchConfig", "SearchResult", "PlanSpace",
           "PlanSpec", "VarChoice", "PlanScorer", "ScoreRecord",
           "zoo_best", "SearchTrace"]

_DRIVER_NAMES = {"run_search", "SearchConfig", "SearchResult"}
_SPACE_NAMES = {"PlanSpace", "PlanSpec", "VarChoice"}
_SCORING_NAMES = {"PlanScorer", "ScoreRecord", "zoo_best"}


def __getattr__(name):
    if name in _DRIVER_NAMES:
        from autodist_tpu_torch.search import drivers
        return getattr(drivers, name)
    if name in _SPACE_NAMES:
        from autodist_tpu_torch.search import space
        return getattr(space, name)
    if name in _SCORING_NAMES:
        from autodist_tpu_torch.search import scoring
        return getattr(scoring, name)
    if name == "SearchTrace":
        from autodist_tpu_torch.search.trace import SearchTrace
        return SearchTrace
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
