"""Topology-aware communication analyzer (ADT520-ADT525): the port's
copy of ``autodist_tpu/analysis/topology.py``.

The lowering emits collectives over *logical* mesh axes; this module maps
each collective's replica groups onto the *physical* multi-level topology
(``ResourceSpec.topology()``: hosts x chips with per-level link
bandwidth) and attributes every wire byte to the link level it actually
crosses. That turns "hierarchical is cheaper here" into a lint-checkable
fact on a dryrun pod — no hardware touched:

- :func:`schedule_level_bytes` — per-link-level byte profile of a lowered
  collective schedule (any iterable of ops carrying ``kind``,
  ``payload_bytes`` and replica groups; what extends
  ``StaticCollectiveProfile`` from one "wire bytes" number to per-level
  rows);
- :func:`lint_schedule` — the lowered-program lints: ADT520 (a flat
  collective spans the slow inter-host level when a synthesized
  hierarchical schedule provably crosses fewer inter-host bytes), ADT521
  (replica groups straddle hosts non-contiguously), ADT523 (a level's
  byte estimate exceeds its bandwidth-delay budget), ADT525 (groups the
  topology cannot price);
- :func:`verify_topology` — the plan-level pass: the same ADT520/523/525
  findings derived from the strategy's synchronizers (before any
  lowering exists), plus ADT522 for a schedule whose synthesized stage
  composition is not reduction-equivalent to the reduce it replaces;
- :func:`diagnostic_for_config_error` — ADT524: a malformed topology
  spec, reported as a diagnostic instead of a traceback.

The byte algebra (all "bytes" are totals crossing one level's links per
step): a flat ring over a group of ``n`` members carries
``2(n-1)/n * P`` per link; with ``B`` of the ring's ``n`` edges crossing
the inter-host level, inter bytes are ``B * 2(n-1)/n * P`` (``B = H``
for a contiguous group spanning ``H`` hosts). The hierarchical schedule
(intra reduce-scatter, leader all-reduce, intra all-gather; arXiv
2110.10548's two-level reduction) crosses ``2(H-1) * P/c`` inter-host
bytes for ``c`` members per host — strictly fewer than the flat ring's
whenever ``c > 1``, which is exactly the ADT520 premise (and why
leader-subgroup collectives, ``c == 1``, never fire it).
"""
from typing import Dict, Iterable, List, Optional, Tuple

from autodist_tpu_torch.analysis.diagnostics import (Diagnostic, error,
                                                     sort_diagnostics,
                                                     warning)
from autodist_tpu_torch.resource_spec import (Topology, TopologyConfigError,
                                              TopologyLevel)

__all__ = [
    "Topology", "TopologyLevel", "TopologyConfigError",
    "resolve_schedule", "group_geometry", "op_level_bytes",
    "schedule_level_bytes", "hier_inter_bytes", "flat_inter_bytes",
    "lint_schedule", "lint_stage_composition", "verify_topology",
    "plan_level_bytes", "diagnostic_for_config_error",
]


def resolve_schedule(choice: Optional[str], topology: Optional[Topology],
                     n: int) -> str:
    """Resolve a synchronizer's ``schedule`` knob to the algorithm the
    lowering/pricing actually uses. ``auto`` picks hierarchical exactly
    when the topology has a priceable inter-host level the sync spans;
    an explicit ``hier`` on a flat (single-level / single-host) mesh is
    REFUSED back to ring — there is nothing to hierarchize, and the
    acceptance contract is that the flat mesh keeps the ring silently."""
    c = (choice or "auto").lower()
    multi_host = (topology is not None and topology.hosts > 1
                  and topology.inter_level is not None
                  and n > topology.chips_per_host)
    if c == "auto":
        return "hier" if multi_host else "ring"
    if c == "hier" and not multi_host:
        return "ring"
    return c


def group_geometry(group: Tuple[int, ...], topology: Topology
                   ) -> Optional[Tuple[int, int, Dict[int, int]]]:
    """Map one replica group onto the topology: ``(hosts_spanned,
    boundary_edges, members_per_host)``. ``boundary_edges`` counts the
    ring edges (consecutive members in group order, wraparound included)
    whose endpoints sit on different hosts — for a contiguous group this
    equals ``hosts_spanned`` (or 0 when single-host); more means the
    device order straddles hosts avoidably (ADT521). ``None`` when a
    member is outside the topology (the ADT525 condition)."""
    n = len(group)
    if n == 0:
        return None
    per_host: Dict[int, int] = {}
    hosts = []
    for dev in group:
        if not 0 <= dev < topology.num_devices:
            return None
        h = dev // topology.chips_per_host
        per_host[h] = per_host.get(h, 0) + 1
        hosts.append(h)
    if n == 1:
        return (1, 0, per_host)
    boundary = sum(1 for i in range(n) if hosts[i] != hosts[(i + 1) % n])
    return (len(per_host), boundary, per_host)


def flat_inter_bytes(payload_bytes: float, n: int, boundary_edges: int
                     ) -> float:
    """Inter-host bytes of the flat ring: each of the group's ``n`` ring
    edges carries ``2(n-1)/n * P``; ``boundary_edges`` of them cross the
    inter-host level."""
    if n <= 1:
        return 0.0
    return boundary_edges * 2.0 * (n - 1) / n * payload_bytes


def hier_inter_bytes(payload_bytes: float, hosts: int, per_host: int
                     ) -> float:
    """Inter-host bytes of the hierarchical two-level schedule: the
    leader all-reduce moves ``P/c`` over a ring of ``H`` hosts — ``H``
    inter-host links at ``2(H-1)/H * P/c`` each."""
    if hosts <= 1:
        return 0.0
    return 2.0 * (hosts - 1) * payload_bytes / max(per_host, 1)


def op_level_bytes(kind: str, payload_bytes: float,
                   groups: Iterable[Tuple[int, ...]],
                   topology: Topology) -> Optional[Dict[str, float]]:
    """Per-level wire bytes of one lowered collective: ring-priced per
    group at its own size, each ring edge attributed to the level it
    crosses. ``None`` when any group member falls outside the topology
    (unpriceable — the caller's ADT525)."""
    from autodist_tpu_torch.simulator.cost_model import collective_wire_bytes
    intra = topology.intra_level.name
    inter = (topology.inter_level.name if topology.inter_level is not None
             else intra)
    out = {intra: 0.0}
    if inter != intra:
        out[inter] = 0.0
    for group in groups:
        geo = group_geometry(tuple(group), topology)
        if geo is None:
            return None
        _, boundary, _ = geo
        k = len(group)
        if k <= 1:
            continue
        per_link = collective_wire_bytes(kind, payload_bytes, k)
        out[intra] += (k - boundary) * per_link
        if boundary:
            out[inter] = out.get(inter, 0.0) + boundary * per_link
    return out


def schedule_level_bytes(schedule, topology: Topology,
                         default_group_size: int = 1) -> Dict[str, float]:
    """Per-link-level wire bytes of a lowered collective schedule —
    the per-level rows ``StaticCollectiveProfile.from_schedule`` attaches
    when built with a topology. Ops with no replica-group annotation are
    priced as one contiguous group of ``default_group_size`` devices;
    unpriceable groups are skipped here (``lint_schedule`` reports them
    as ADT525 — a profile must never raise mid-build)."""
    per_step = (schedule.per_step() if hasattr(schedule, "per_step")
                else schedule)
    total: Dict[str, float] = {lv.name: 0.0 for lv in topology.levels}
    for c in per_step:
        groups = c.replica_groups
        if not groups:
            k = max(int(default_group_size), 1)
            if k <= 1:
                continue
            groups = (tuple(range(min(k, topology.num_devices))),)
        rows = op_level_bytes(c.kind, c.payload_bytes, groups, topology)
        if rows is None:
            continue
        for name, b in rows.items():
            total[name] = total.get(name, 0.0) + b
    return total


# ------------------------------------------------------------------- lints


def _budget_diags(level_bytes: Dict[str, float], topology: Topology,
                  label: str = "") -> List[Diagnostic]:
    """ADT523: a level's per-step byte estimate exceeds its
    bandwidth-delay budget (``budget_ms`` on the level, when declared)."""
    out: List[Diagnostic] = []
    where = " in %s" % label if label else ""
    for lv in topology.levels:
        if lv.budget_ms is None:
            continue
        b = level_bytes.get(lv.name, 0.0)
        est_ms = b / lv.bandwidth_bytes_s * 1e3
        if est_ms > lv.budget_ms:
            out.append(warning(
                "ADT523",
                "level %r%s carries %.0f bytes/step ~ %.2f ms at %.3g "
                "Gbps, over its %.2f ms budget" % (
                    lv.name, where, b, est_ms, lv.bandwidth_gbps,
                    lv.budget_ms),
                fixit="shrink the payload crossing this level "
                      "(hierarchical schedule, int8 wire, ZeRO) or raise "
                      "topology.levels[].budget_ms"))
    return out


def lint_schedule(schedule, topology: Topology,
                  label: str = "") -> List[Diagnostic]:
    """The ADT52x pass over one LOWERED program's collective schedule:
    every replica group is mapped onto the topology, and

    - ADT520 (error): a flat reduce spans >= 2 hosts with >= 2 members
      per host — the synthesized hierarchical schedule provably crosses
      strictly fewer inter-host bytes (the proof is in the message);
      leader-subgroup reduces (one member per host) are exactly the
      hierarchical lowering's inter stage and stay silent;
    - ADT521 (warning): a group straddles hosts non-contiguously — the
      ring takes more inter-host hops than the span requires;
    - ADT523 (warning): a level's byte total exceeds its declared budget;
    - ADT525 (error): a group names a device the topology does not have.
    """
    per_step = (schedule.per_step() if hasattr(schedule, "per_step")
                else schedule)
    out: List[Diagnostic] = []
    where = " in %s" % label if label else ""
    for c in per_step:
        if not c.replica_groups:
            continue
        for group in c.replica_groups:
            geo = group_geometry(tuple(group), topology)
            if geo is None:
                out.append(error(
                    "ADT525",
                    "%s collective%s (line %d) names device(s) outside "
                    "the %d-host x %d-chip topology: groups=%s — the "
                    "per-level profile cannot price it" % (
                        c.kind, where, c.lineno, topology.hosts,
                        topology.chips_per_host,
                        [list(g) for g in c.replica_groups]),
                    fixit="lint with the topology the program was "
                          "lowered for (matching host x chip counts)"))
                break
            hosts_spanned, boundary, per_host = geo
            n = len(group)
            if hosts_spanned > 1 and boundary > hosts_spanned:
                out.append(warning(
                    "ADT521",
                    "%s collective%s (line %d) replica group straddles "
                    "%d hosts non-contiguously: %d of %d ring edges "
                    "cross the inter-host level (a contiguous layout "
                    "needs %d)" % (
                        c.kind, where, c.lineno, hosts_spanned, boundary,
                        n, hosts_spanned),
                    fixit="order replica groups host-major so "
                          "consecutive members share a host"))
            if (c.kind == "reduce" and hosts_spanned > 1
                    and min(per_host.values()) >= 2
                    and len(set(per_host.values())) == 1):
                cc = n // hosts_spanned
                flat = flat_inter_bytes(c.payload_bytes, n, boundary)
                hier = hier_inter_bytes(c.payload_bytes, hosts_spanned, cc)
                if hier < flat:
                    out.append(error(
                        "ADT520",
                        "flat %s%s (line %d, %dB) spans the inter-host "
                        "level over %d hosts x %d chips: it crosses "
                        "%.0f inter-host bytes where the hierarchical "
                        "two-level schedule crosses %.0f (%.1fx fewer)"
                        % (c.op or c.kind, where, c.lineno,
                           c.payload_bytes, hosts_spanned, cc, flat,
                           hier, flat / max(hier, 1.0)),
                        fixit="lower with schedule=hier (or auto) so the "
                              "inter-host links carry only the 1/%d "
                              "leader shard" % cc))
    out += _budget_diags(schedule_level_bytes(per_step, topology),
                         topology, label)
    return sort_diagnostics(out)


def lint_stage_composition(stages, target, var: str = "") -> List[Diagnostic]:
    """ADT522: a synthesized schedule whose stage composition is not
    reduction-equivalent to the reduce it replaces. ``stages`` is an
    iterable of :class:`~autodist_tpu_torch.parallel.collectives.CollectiveOp`;
    ``target`` the flat reduce being replaced."""
    from autodist_tpu_torch.parallel.collectives import reduction_equivalent
    if reduction_equivalent(stages, target):
        return []
    return [error(
        "ADT522",
        "synthesized schedule [%s] is not reduction-equivalent to "
        "reduce over %s — lowering it would change the reduced value, "
        "not just its route" % (
            ", ".join("%s(%s)" % (op.kind, ",".join(op.axes))
                      for op in stages),
            ",".join(target.axes)),
        var=var,
        fixit="every reduce_scatter must pair with an all_gather over "
              "the same axes and each target axis must be reduced "
              "exactly once")]


def diagnostic_for_config_error(e: TopologyConfigError) -> Diagnostic:
    """ADT524: a malformed/unpriceable topology spec, surfaced as a
    diagnostic (the CLI's ``--topology`` error path) instead of a
    traceback."""
    return error("ADT524", "malformed topology spec: %s" % e,
                 fixit="fix the named knob in the topology yaml")


# ----------------------------------------------------------- plan-level pass


def _ar_payload_by_schedule(strategy, model_item, topology: Topology
                            ) -> Tuple[Dict[str, float], List[Diagnostic]]:
    """Per-resolved-algorithm gradient-sync payload bytes of a plan, plus
    the ADT520/522/525 findings the resolution surfaces. Mirrors the cost
    model's classification: plain AllReduce syncs carry the schedule
    knob; ZeRO's rs+ag and partitioned paths price as rhd (they already
    are a scatter+gather composition)."""
    from autodist_tpu_torch.parallel.collectives import (
        SCHEDULE_ALGORITHMS, synthesize_collective_candidates)
    from autodist_tpu_torch.strategy.base import (AllReduceSynchronizer,
                                                  ZeroShardedSynchronizer)
    infos = (getattr(model_item, "var_infos", None)
             or (model_item if isinstance(model_item, dict) else {}))
    n = max(len(strategy.graph_config.replicas), 1)
    by_sched: Dict[str, float] = {}
    diags: List[Diagnostic] = []
    cph = topology.chips_per_host
    hosts_spanned = min(max(1, -(-n // cph)), topology.hosts)
    per_host = min(n, cph)
    checked_axes = set()
    for node in strategy.node_config:
        info = infos.get(node.var_name)
        if info is None:
            continue
        syncs = ([node.synchronizer] if node.synchronizer else
                 [p.synchronizer for p in node.part_configs])
        for sync in syncs:
            if isinstance(sync, ZeroShardedSynchronizer):
                by_sched["rhd"] = (by_sched.get("rhd", 0.0)
                                   + info.byte_size / max(len(syncs), 1))
                continue
            if not isinstance(sync, AllReduceSynchronizer):
                continue
            choice = getattr(sync, "schedule", "auto") or "auto"
            if choice not in ("auto",) + tuple(SCHEDULE_ALGORITHMS):
                diags.append(error(
                    "ADT525",
                    "unknown collective schedule %r — the topology "
                    "pricer cannot cost it and the lowering would fall "
                    "back to the flat psum" % choice,
                    var=node.var_name,
                    fixit="use one of auto, %s"
                          % ", ".join(SCHEDULE_ALGORITHMS)))
                continue
            resolved = resolve_schedule(choice, topology, n)
            by_sched[resolved] = (by_sched.get(resolved, 0.0)
                                  + info.byte_size / max(len(syncs), 1))
            if (resolved == "ring" and choice == "ring"
                    and hosts_spanned > 1 and per_host > 1):
                flat = flat_inter_bytes(info.byte_size, n, hosts_spanned)
                hier = hier_inter_bytes(info.byte_size, hosts_spanned,
                                        per_host)
                if hier < flat:
                    diags.append(error(
                        "ADT520",
                        "schedule pinned to the flat ring while the "
                        "replicas span %d hosts x %d chips: %.0f "
                        "inter-host bytes vs the hierarchical "
                        "schedule's %.0f (%.1fx fewer)" % (
                            hosts_spanned, per_host, flat, hier,
                            flat / max(hier, 1.0)),
                        var=node.var_name,
                        fixit="set schedule=hier (or auto) on this "
                              "synchronizer"))
            if resolved == "hier":
                # ADT522 self-check: the composition the lowering would
                # execute must be reduction-equivalent to the flat
                # reduce it replaces (checked once per axis layout)
                key = ("data",)
                if key not in checked_axes:
                    checked_axes.add(key)
                    cands = synthesize_collective_candidates(
                        "var:%s" % node.var_name, ("ici", "dcn"),
                        intra_axes=("ici",), inter_axes=("dcn",))
                    target = cands["ring"][0]
                    for name, stages in cands.items():
                        diags += lint_stage_composition(
                            stages, target, var=node.var_name)
    return by_sched, diags


def plan_level_bytes(strategy, model_item, topology: Topology
                     ) -> Dict[str, float]:
    """Predicted per-level wire bytes of a plan's gradient sync on this
    topology (contiguous replica layout) — the prediction the drift
    report's ``levels`` section joins against the lowered profile's
    measured per-level rows."""
    by_sched, _ = _ar_payload_by_schedule(strategy, model_item, topology)
    n = max(len(strategy.graph_config.replicas), 1)
    cph = topology.chips_per_host
    hosts = min(max(1, -(-n // cph)), topology.hosts)
    per_host = min(n, cph)
    intra = topology.intra_level.name
    inter = (topology.inter_level.name if topology.inter_level is not None
             else intra)
    out = {lv.name: 0.0 for lv in topology.levels}
    for sched, payload in by_sched.items():
        if n <= 1 or payload <= 0:
            continue
        if sched == "hier" and hosts > 1 and per_host > 1:
            out[intra] += 2.0 * (per_host - 1) * payload * hosts
            out[inter] += hier_inter_bytes(payload, hosts, per_host)
        else:
            per_link = 2.0 * (n - 1) / n * payload
            boundary = hosts if hosts > 1 else 0
            out[intra] += (n - boundary) * per_link
            out[inter] = out.get(inter, 0.0) + boundary * per_link
    return out


def verify_topology(strategy, model_item, resource_spec) -> List[Diagnostic]:
    """Plan-level ADT52x pass (rules.py style): silently empty when the
    spec declares no multi-level topology, so flat specs lint exactly as
    before. On a hierarchy: ADT520 for flat-pinned schedules that span
    the slow level, ADT522 for non-equivalent synthesized compositions,
    ADT523 for per-level budget overruns, ADT525 for unpriceable
    configurations (more replicas than the topology has devices, unknown
    schedule names)."""
    topology = None
    if resource_spec is not None and hasattr(resource_spec, "topology"):
        topology = resource_spec.topology()
    if topology is None:
        return []
    out: List[Diagnostic] = []
    n = max(len(strategy.graph_config.replicas), 1)
    if n > topology.num_devices:
        out.append(error(
            "ADT525",
            "plan has %d replicas but the topology only describes %d "
            "devices (%d hosts x %d chips) — per-level attribution is "
            "impossible" % (n, topology.num_devices, topology.hosts,
                            topology.chips_per_host),
            fixit="grow topology.hosts/chips_per_host or shrink the "
                  "replica set"))
        return sort_diagnostics(out)
    by_sched, diags = _ar_payload_by_schedule(strategy, model_item,
                                              topology)
    out += diags
    out += _budget_diags(plan_level_bytes(strategy, model_item, topology),
                         topology)
    return sort_diagnostics(out)


def describe_levels(level_bytes: Dict[str, float], topology: Topology
                    ) -> str:
    """One-line per-level profile for CLI output: bytes and estimated
    link-seconds per level."""
    bits = []
    for lv in topology.levels:
        b = level_bytes.get(lv.name, 0.0)
        bits.append("%s=%.0fB (%.3g ms @ %.3g Gbps)"
                    % (lv.name, b, b / lv.bandwidth_bytes_s * 1e3,
                       lv.bandwidth_gbps))
    return ", ".join(bits)

