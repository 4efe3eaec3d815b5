"""Static per-device peak-HBM analysis (the ADT5xx memory pass), the
port of ``autodist_tpu/analysis/memory.py``. Two estimators share one
reporting shape, so an OOM surfaces at lint time instead of as an
allocation failure:

- :func:`estimate_from_text` — the **program** estimator: the entry
  buffers of the step recorded as a program (``kernel/lowering.py``,
  parsed by ``analysis/program.py``), donation-aware, plus a liveness
  sweep over the recorded allocations and frees for the temporaries.
  This is the number ``Runner.memory_report()`` reports.
- :func:`plan_memory_report` — the **plan-level** estimator: the cost
  model's strategy-aware heuristic (params + optimizer state + gradient
  buffer + activations under partitioning/host-PS/remat,
  ``simulator/cost_model.py::CostModel.hbm_bytes``), available before any
  recording — ``AutoDist(validate=...)`` runs it on every build.

Both check against a budget derived from ``ResourceSpec.chip_hbm_bytes()``
(per-card capacity by generation, overridable per cluster with
``slice.hbm_gib``) and report:

- ``ADT501`` (error): projected per-device peak exceeds the budget;
- ``ADT502`` (warning): peak within 10% of the budget — one allocator
  fragmentation event from an OOM;
- ``ADT503`` (warning): a fused superstep program whose carry is not
  donated — state lives twice for the whole superstep (on the card, the
  ``donate=False`` replay keeps the graph's copy of the state beside the
  caller's, ``kernel/superstep.py``).

The liveness sweep differs from the JAX one by what the program is. XLA
fuses elementwise chains and keeps a buffer to its last use, so the JAX
sweep charges only "anchor" ops from definition to last use. The port's
program is the eager step: every op that allocates holds a buffer, and
it holds it until the run drops its last Python reference to it (the
``free`` lines), which is what torch's caching allocator sees.
"""
import dataclasses
from typing import Dict, List, Optional

from autodist_tpu_torch.analysis.diagnostics import Diagnostic, error, warning
from autodist_tpu_torch.analysis.program import (Function, Program,
                                                 parse_program_text,
                                                 storage_sizes)

GIB = float(1 << 30)


@dataclasses.dataclass
class MemoryEstimate:
    """Per-device peak-HBM estimate of one recorded program (the JAX
    record's fields)."""

    num_partitions: int = 1
    args_bytes: float = 0.0           # entry arguments
    output_bytes: float = 0.0         # entry results
    aliased_bytes: float = 0.0        # donated args the results reuse
    peak_temp_bytes: float = 0.0      # liveness-sweep peak of temporaries
    # largest single collective payload — informational: the sweep holds
    # a collective's buffers live across it already
    collective_scratch_bytes: float = 0.0
    outputs_by_label: Dict[str, float] = dataclasses.field(
        default_factory=dict)

    @property
    def peak_hbm_bytes(self) -> float:
        return (self.args_bytes + self.output_bytes - self.aliased_bytes
                + self.peak_temp_bytes)

    def to_dict(self) -> dict:
        return {
            "num_partitions": self.num_partitions,
            "args_bytes": round(self.args_bytes),
            "output_bytes": round(self.output_bytes),
            "aliased_bytes": round(self.aliased_bytes),
            "peak_temp_bytes": round(self.peak_temp_bytes),
            "collective_scratch_bytes": round(self.collective_scratch_bytes),
            "peak_hbm_bytes": round(self.peak_hbm_bytes),
            "peak_hbm_gib": round(self.peak_hbm_bytes / GIB, 4),
            "outputs_by_label": {k: round(v) for k, v in
                                 sorted(self.outputs_by_label.items())},
        }


def _classify_result(info: str) -> str:
    """The result's group by its label's head: ``params``,
    ``opt_state``, ``sync_state``, ``ps`` (the fused carry),
    ``ps_grads`` or ``metrics``."""
    head = info.split("[", 1)[0]
    return head if head in ("params", "opt_state", "sync_state", "ps",
                            "ps_grads") else "metrics"


def _temp_peak(func: Function) -> float:
    """Liveness-sweep peak of the program's temporaries: each storage an
    op allocated that is neither an argument's nor a result's is live
    from that op to its ``free`` line (to the end without one)."""
    keep = {a.storage for a in func.args} | {r.storage for r in func.results}
    events = []
    for st in func.statements:
        for sto, nbytes in zip(st.storages, st.alloc_bytes):
            if nbytes and sto not in keep:
                events.append((st.lineno, nbytes))
    for f in func.frees:
        if f.storage not in keep:
            events.append((f.lineno, -f.nbytes))
    peak = live = 0.0
    for _, change in sorted(events):
        live += change
        peak = max(peak, live)
    return peak


def estimate_from_text(text_or_program) -> MemoryEstimate:
    """Per-device peak-HBM estimate of a recorded program.

    ``peak = args + outputs - donated aliases + temp peak``: each entry
    storage counted once (a view's base is its storage), the aliases the
    storages a donated argument and a result share (the in-place
    update), the temp peak from the liveness sweep."""
    program = (text_or_program if isinstance(text_or_program, Program)
               else parse_program_text(text_or_program))
    est = MemoryEstimate(num_partitions=program.num_partitions)
    if program.entry is None:
        return est
    entry = program.entry
    sizes = storage_sizes(entry)
    arg_storages = {a.storage for a in entry.args}
    donated = {a.storage for a in entry.args if a.donated}
    out_storages = {r.storage for r in entry.results if r.storage}
    est.args_bytes = float(sum(sizes.get(s, 0) for s in arg_storages))
    est.output_bytes = float(sum(sizes.get(s, 0) for s in out_storages))
    est.aliased_bytes = float(sum(sizes.get(s, 0)
                                  for s in out_storages & donated))
    seen = set()
    for r in entry.results:
        if r.storage in seen:
            continue
        seen.add(r.storage)
        label = _classify_result(r.result_info)
        est.outputs_by_label[label] = (est.outputs_by_label.get(label, 0.0)
                                       + r.storage_bytes)
    est.peak_temp_bytes = _temp_peak(entry)
    est.collective_scratch_bytes = float(max(
        (c.payload_bytes for c in program.collectives()), default=0))
    return est


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


def donation_diagnostics(text_or_program,
                         fuse_steps: int = 1) -> List[Diagnostic]:
    """ADT503: a fused superstep program whose entry state is not
    donated keeps two copies of params and optimizer state resident for
    the whole superstep — on the card, the ``donate=False`` replay keeps
    the CUDA graph's copy of the state beside the caller's.

    Fires only when the caller declares the program fused (``fuse_steps
    > 1``; ``Runner.memory_report`` and the CLI's ``--fuse-steps`` both
    know), as in the JAX package."""
    if fuse_steps <= 1:
        return []
    program = (text_or_program if isinstance(text_or_program, Program)
               else parse_program_text(text_or_program))
    if program.entry is None:
        return []
    if any(a.donated for a in program.entry.args):
        return []
    carry = sum(a.per_device_bytes for a in program.entry.args)
    return [warning(
        "ADT503",
        "fused superstep carry is not donated: none of the %d entry "
        "arguments alias an output, so ~%.2f GiB of state is resident "
        "twice for the whole superstep" % (
            len(program.entry.args), carry / GIB),
        fixit="dispatch through run_superstep/multi_step (donate=True) "
              "so the carry buffers are reused in place")]


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
