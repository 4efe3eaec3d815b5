"""Pre-compile strategy verifier — static analysis with typed diagnostics
(the port's copy of the JAX package's framework-free analysis modules).

Public surface:

- :func:`verify` — ``(Strategy, ModelItem, ResourceSpec) ->
  list[Diagnostic]``: the pure plan-level pass (``rules.py``), which
  ``AutoDist(validate=...)`` runs before every build;
- :func:`lint_lowered_text` / :func:`lint_runner` — the second pass over
  the step recorded as a program (``lowered.py``; the recording is
  ``kernel/lowering.py``, the counterpart of the JAX lowering);
- :func:`parse_program_text` / :func:`collective_schedule` /
  :func:`compare_schedules` — the structured program parser and the
  cross-program collective-schedule checks, ADT510/511 (``program.py``,
  the counterpart of the JAX ``hlo.py``, whose ``parse_hlo_text`` name is
  kept as an alias);
- :func:`estimate_from_text` / :func:`plan_memory_report` /
  :func:`budget_diagnostics` / :func:`donation_diagnostics` — the static
  peak-HBM analyzers, ADT501-503 (``memory.py``);
- :func:`verify_topology` / :func:`lint_schedule` /
  :func:`schedule_level_bytes` / :func:`plan_level_bytes` /
  :func:`resolve_schedule` — the topology-aware communication analyzer,
  ADT520-525 (``topology.py``);
- :class:`Diagnostic` / :class:`Severity` / :class:`DiagnosticError` /
  :class:`StrategyVerificationError` — the typed diagnostics framework
  (``diagnostics.py``);
- ``python -m autodist_tpu_torch.analysis`` — the plan linter CLI
  (``cli.py``).

Exports resolve lazily (PEP 562): ``strategy/base.py`` imports the leaf
``analysis.partition`` module for partitioner parsing, and an eager
``from .rules import verify`` here would close an import cycle back
through ``strategy.base``.
"""

__all__ = ["verify", "lint_lowered_text", "lint_runner", "Diagnostic",
           "Severity", "DiagnosticError", "StrategyVerificationError",
           "format_table", "sort_diagnostics", "has_errors", "CODES",
           "parse_hlo_text", "collective_schedule", "compare_schedules",
           "CollectiveSchedule", "estimate_from_text", "MemoryEstimate",
           "plan_memory_report", "budget_diagnostics",
           "donation_diagnostics", "verify_topology", "lint_schedule",
           "schedule_level_bytes", "plan_level_bytes", "resolve_schedule",
           "Topology", "TopologyConfigError", "parse_program_text"]

_DIAG_NAMES = {"Diagnostic", "Severity", "DiagnosticError",
               "StrategyVerificationError", "format_table",
               "sort_diagnostics", "has_errors", "CODES"}
_PROGRAM_NAMES = {"parse_program_text", "collective_schedule",
                  "compare_schedules", "CollectiveSchedule"}
_MEMORY_NAMES = {"estimate_from_text", "MemoryEstimate",
                 "plan_memory_report", "budget_diagnostics",
                 "donation_diagnostics"}
_TOPOLOGY_NAMES = {"verify_topology", "lint_schedule",
                   "schedule_level_bytes", "plan_level_bytes",
                   "resolve_schedule", "Topology", "TopologyConfigError"}


def __getattr__(name):
    if name == "verify":
        from autodist_tpu_torch.analysis.rules import verify
        return verify
    if name in ("lint_lowered_text", "lint_runner"):
        from autodist_tpu_torch.analysis import lowered
        return getattr(lowered, name)
    if name in _PROGRAM_NAMES:
        from autodist_tpu_torch.analysis import program
        return getattr(program, name)
    if name == "parse_hlo_text":
        from autodist_tpu_torch.analysis.program import parse_program_text
        return parse_program_text
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
