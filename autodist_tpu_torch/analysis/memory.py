"""Static per-device peak-HBM analysis (the ADT5xx memory pass), the
plan half: the port's copy of ``autodist_tpu/analysis/memory.py``'s
:func:`budget_diagnostics`, :func:`plan_peak_hbm` and
:func:`plan_memory_report`.

:func:`plan_memory_report` is the **plan-level** estimator: the cost
model's strategy-aware heuristic (params + optimizer state + gradient
buffer + activations under partitioning/host-PS/remat,
``simulator/cost_model.py::CostModel.hbm_bytes``), available before the
lowering — ``AutoDist(validate=...)`` runs it on every build, so a
projected OOM is a typed diagnostic, not an allocation failure at the
first step. It checks against a budget derived from
``ResourceSpec.chip_hbm_bytes()`` (per-card capacity by generation,
overridable per cluster with ``slice.hbm_gib``) and reports:

- ``ADT501`` (error): projected per-device peak exceeds the budget;
- ``ADT502`` (warning): peak within 10% of the budget — one allocator
  fragmentation event from an OOM.

The JAX module's other half reads lowered HLO text
(``estimate_from_text``, ``donation_diagnostics``, ADT503); its
counterpart waits for the port's analyzers of the lowered step.
"""
from typing import List, Optional

from autodist_tpu_torch.analysis.diagnostics import Diagnostic, error, warning

GIB = float(1 << 30)


# ---------------------------------------------------------------- budgets


def budget_diagnostics(peak_bytes: float, budget_bytes: float,
                       source: str = "lowered program",
                       headroom_warn: float = 0.9) -> List[Diagnostic]:
    """ADT501/ADT502 against a per-device HBM budget."""
    out: List[Diagnostic] = []
    if budget_bytes <= 0:
        return out
    if peak_bytes > budget_bytes:
        out.append(error(
            "ADT501",
            "projected OOM: per-device peak HBM %.3f GiB exceeds the "
            "%.3f GiB budget (%s estimate) — this plan crashes at the "
            "first step's allocation, not at lint time" % (
                peak_bytes / GIB, budget_bytes / GIB, source),
            fixit="partition storage (ZeRO/PartitionedPS), offload to "
                  "host-PS, enable remat, or shrink the per-device "
                  "batch"))
    elif peak_bytes > headroom_warn * budget_bytes:
        out.append(warning(
            "ADT502",
            "per-device peak HBM %.2f GiB is within %d%% of the %.2f GiB "
            "budget (%s estimate) — allocator fragmentation or a larger "
            "batch tips this into OOM" % (
                peak_bytes / GIB, round((1 - headroom_warn) * 100),
                budget_bytes / GIB, source),
            fixit="leave >=10% headroom: partition storage, remat, or "
                  "shrink the batch"))
    return out


# ------------------------------------------------------------- plan level


def plan_peak_hbm(strategy, model_item, resource_spec,
                  fuse_steps: int = 1, cost_model=None) -> float:
    """Strategy-aware per-device peak estimate with NO tracing of the
    lowered program — the cost model's heuristic (params + opt state +
    gradient buffer + activations under partitioning/host-PS/remat),
    plus the fused engine's device-resident PS carry (values stay
    counted as the pulled copy; the carry additionally pins each host-PS
    var's optimizer state on device for the superstep)."""
    from autodist_tpu_torch.simulator.cost_model import CostModel
    cm = cost_model or CostModel(model_item, resource_spec)
    peak = cm.hbm_bytes(strategy)
    if fuse_steps > 1:
        peak += _fused_carry_opt_bytes(strategy, model_item, cm)
    return peak


def _fused_carry_opt_bytes(strategy, model_item, cost_model) -> float:
    """Optimizer-state bytes the fused carry keeps device-resident for
    host-PS vars (per-step execution leaves them in host RAM)."""
    from autodist_tpu_torch.strategy.base import PSSynchronizer
    infos = model_item.var_infos
    params_total = float(model_item.total_bytes()) or 1.0
    opt_total = cost_model.opt_state_bytes()
    carry = 0.0
    for node in strategy.node_config:
        info = infos.get(node.var_name)
        if info is None:
            continue
        syncs = ([node.synchronizer] if node.synchronizer else
                 [p.synchronizer for p in node.part_configs])
        if any(isinstance(s, PSSynchronizer) and not s.local_replication
               for s in syncs):
            carry += opt_total * info.byte_size / params_total
    return carry


def plan_memory_report(strategy, model_item, resource_spec,
                       budget_bytes: Optional[float] = None,
                       fuse_steps: int = 1) -> dict:
    """The CLI/AutoDist-facing plan-level memory gate: heuristic peak,
    budget (explicit GiB or the spec's chip capacity), utilization and
    the ADT501/502 diagnostics."""
    peak = plan_peak_hbm(strategy, model_item, resource_spec,
                         fuse_steps=fuse_steps)
    budget = (budget_bytes if budget_bytes is not None
              else resource_spec.chip_hbm_bytes())
    diags = budget_diagnostics(peak, budget, source="plan-level")
    return {
        "peak_hbm_bytes": round(peak),
        "peak_hbm_gib": round(peak / GIB, 4),
        "budget_bytes": round(budget),
        "budget_gib": round(budget / GIB, 4),
        "utilization": round(peak / budget, 4) if budget else None,
        "fuse_steps": fuse_steps,
        "diagnostics": diags,
    }
