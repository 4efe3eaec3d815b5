"""Pre-compile strategy verifier — static analysis with typed diagnostics
(the port's copy of the JAX package's framework-free analysis modules).

Public surface:

- :func:`verify` — ``(Strategy, ModelItem, ResourceSpec) ->
  list[Diagnostic]``: the pure plan-level pass (``rules.py``), which
  ``AutoDist(validate=...)`` runs before every build;
- :func:`plan_memory_report` / :func:`budget_diagnostics` — the
  plan-level peak-HBM gate, ADT501/502 (``memory.py``);
- :func:`verify_topology` / :func:`lint_schedule` /
  :func:`schedule_level_bytes` / :func:`plan_level_bytes` /
  :func:`resolve_schedule` — the topology-aware communication analyzer,
  ADT520-525 (``topology.py``);
- :class:`Diagnostic` / :class:`Severity` / :class:`DiagnosticError` /
  :class:`StrategyVerificationError` — the typed diagnostics framework
  (``diagnostics.py``).

Exports resolve lazily (PEP 562): ``strategy/base.py`` imports the leaf
``analysis.partition`` module for partitioner parsing, and an eager
``from .rules import verify`` here would close an import cycle back
through ``strategy.base``.
"""

__all__ = ["verify", "Diagnostic", "Severity", "DiagnosticError",
           "StrategyVerificationError", "format_table", "sort_diagnostics",
           "has_errors", "CODES", "plan_memory_report",
           "budget_diagnostics", "verify_topology", "lint_schedule",
           "schedule_level_bytes", "plan_level_bytes", "resolve_schedule",
           "Topology", "TopologyConfigError"]

_DIAG_NAMES = {"Diagnostic", "Severity", "DiagnosticError",
               "StrategyVerificationError", "format_table",
               "sort_diagnostics", "has_errors", "CODES"}
_MEMORY_NAMES = {"plan_memory_report", "budget_diagnostics"}
_TOPOLOGY_NAMES = {"verify_topology", "lint_schedule",
                   "schedule_level_bytes", "plan_level_bytes",
                   "resolve_schedule", "Topology", "TopologyConfigError"}


def __getattr__(name):
    if name == "verify":
        from autodist_tpu_torch.analysis.rules import verify
        return verify
    if name in _MEMORY_NAMES:
        from autodist_tpu_torch.analysis import memory
        return getattr(memory, name)
    if name in _TOPOLOGY_NAMES:
        from autodist_tpu_torch.analysis import topology
        return getattr(topology, name)
    if name in _DIAG_NAMES:
        from autodist_tpu_torch.analysis import diagnostics
        return getattr(diagnostics, name)
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
