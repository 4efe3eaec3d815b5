"""The plan rules the port runs: copies of
``autodist_tpu/analysis/rules.py::missing_trainable_configs`` (ADT101, the
compile path's hard failure), ``check_mp_axes_node`` (ADT205/206/207, the
partitioner's model-parallel layout check), ``verify_sentinel``
(ADT420/421, the health sentinel against the lowered step),
``verify_decode`` (ADT442, the decode engine's cache-vs-memory
projection), and ``fail_fast_model_axes`` with ``verify_elastic``
(ADT430/431, whether a topology can shrink in-run: the build-time lint
and the coordinator's shrink decision both read them), and
``verify_preemption`` (ADT432, a planned handoff armed on a topology that
cannot shrink), and ``verify_autoscale`` (ADT440/441, a serving
autoscaler's bounds against the strategy it scales)."""
from typing import Dict, List, Optional

from autodist_tpu_torch import const
from autodist_tpu_torch.analysis.diagnostics import Diagnostic, error, warning

GIB = float(1 << 30)


def missing_trainable_configs(strategy, trainable_names) -> List[str]:
    """Trainable variables the strategy has no node for (ADT101).

    The single implementation behind both the linter rule and
    ``StrategyCompiler.compile``'s hard failure."""
    have = {n.var_name for n in strategy.node_config}
    return sorted(set(trainable_names) - have)


def check_mp_axes_node(var_name: str, mp_axes: Dict[int, str], shape,
                       mesh_axis_sizes: Dict[str, int]) -> List[Diagnostic]:
    """ADT205/206/207 for one node's model-parallel ``mp_axes`` spec.

    The function ``kernel/partitioner.VariablePartitioner`` raises from,
    so the lint table and the compile error agree."""
    out: List[Diagnostic] = []
    seen_axes: Dict[str, int] = {}
    for dim, ax_name in sorted(mp_axes.items()):
        size = mesh_axis_sizes.get(ax_name)
        if size is None:
            out.append(error(
                "ADT205",
                "mp axis %r not in mesh %s" % (ax_name, mesh_axis_sizes),
                var=var_name,
                fixit="add the axis to graph_config.mesh_shape or shard "
                      "over an existing axis"))
            continue
        if ax_name in seen_axes:
            out.append(error(
                "ADT207",
                "mesh axis %r shards both dim %d and dim %d of the same "
                "variable" % (ax_name, seen_axes[ax_name], dim),
                var=var_name,
                fixit="shard each mesh axis over at most one tensor dim"))
        seen_axes[ax_name] = dim
        if shape is not None and (dim >= len(shape)
                                  or shape[dim] % size != 0):
            out.append(error(
                "ADT206",
                "dim %d (shape %s) not divisible by mesh axis %r size %d"
                % (dim, tuple(shape), ax_name, size), var=var_name,
                fixit="model-parallel storage needs exact divisibility "
                      "(no padding): adjust the mesh axis size or the "
                      "model dimension"))
    return out


def verify_decode(cache_bytes: float, param_bytes: float = 0.0,
                  slots: Optional[int] = None,
                  max_len: Optional[int] = None,
                  replicas: int = 1,
                  budget_bytes: Optional[float] = None,
                  resource_spec=None) -> List[Diagnostic]:
    """ADT442 — does a continuous-batching decode engine's armed KV
    cache (``max_len x slots``, both halves, ``serving/decode.py``) plus
    the full params the decode step holds fit the per-device memory
    budget? Run at engine construction, so an over-provisioned slot pool
    warns at deploy time instead of failing at the first full-occupancy
    step.

    ``cache_bytes`` is the GLOBAL cache allocation (k + v); the slot dim
    splits over ``replicas``, so the per-device share is
    ``cache_bytes / replicas``; params count whole. The budget comes from
    ``budget_bytes`` or ``resource_spec.chip_hbm_bytes()``; with neither
    there is nothing to project against and no diagnostic is emitted."""
    out: List[Diagnostic] = []
    budget = budget_bytes
    if budget is None and resource_spec is not None:
        budget = resource_spec.chip_hbm_bytes()
    if not budget or budget <= 0:
        return out
    per_device = cache_bytes / max(int(replicas), 1) + param_bytes
    if per_device > budget:
        geometry = ""
        if slots is not None and max_len is not None:
            geometry = " (%d slots x %d max_len)" % (slots, max_len)
        out.append(warning(
            "ADT442",
            "decode engine armed with %.2f GiB of KV cache%s + %.2f GiB "
            "params projects to %.2f GiB per device — past the %.2f GiB "
            "device memory budget: the first fully-occupied decode step "
            "runs out of memory, not the lint" % (
                cache_bytes / GIB, geometry, param_bytes / GIB,
                per_device / GIB, budget / GIB),
            fixit="shrink slots or max_len, serve a smaller model, or "
                  "spread the slot dim over more batch replicas"))
    return out


def verify_sentinel(policy, metadata: dict) -> List[Diagnostic]:
    """ADT42x — health-sentinel configuration hazards, checked against a
    lowered step's metadata (``DistributedStep.metadata``); the Runner
    runs this whenever a policy is armed.

    - ``ADT420``: the policy is active but the step carries no health
      guards (step_fn capture mode) — NaN/Inf detection and the skip
      inside the step are unavailable; the sentinel degrades to host-side
      loss monitoring, which can only roll back, never skip.
    - ``ADT421``: a stale/async PS apply window larger than the
      sentinel's skip window — a peer's delayed push can land a poisoned
      gradient AFTER the window that judged those steps closed, so a bad
      update can slip past the skip budget's accounting.
    """
    out: List[Diagnostic] = []
    if policy is None or not getattr(policy, "enabled", False):
        return out
    metadata = metadata or {}
    if not metadata.get("sentinel_guards", False):
        out.append(warning(
            "ADT420",
            "sentinel policy is active but the lowered program has no "
            "in-graph health guards — gradient/param NaN detection and "
            "the in-graph skip are unavailable (loss-only monitoring)",
            fixit="build with loss_fn mode (AutoDist.build) so the "
                  "guards compile into the step"))
    window = int(metadata.get("staleness", 0) or 0)
    if metadata.get("async"):
        window = max(window, int(const.ENV.ADT_PS_MAX_LAG.val))
    if window > int(policy.window_steps):
        out.append(warning(
            "ADT421",
            "PS apply window (%d steps stale/async lag) exceeds the "
            "sentinel skip window (%d steps) — a delayed poisoned push "
            "can apply after its window's verdict accounting closed"
            % (window, policy.window_steps),
            fixit="raise SentinelPolicy.window_steps above the "
                  "staleness/lag bound, or tighten the PS window"))
    return out


def fail_fast_model_axes(strategy) -> dict:
    """The model-parallel mesh axes (of size > 1) that make a topology
    fail-fast for in-run shrink (ADT430): one predicate, so the lint and
    the coordinator's runtime shrink decision never disagree about what
    "fail-fast" means."""
    mesh_shape = strategy.graph_config.mesh_shape or {}
    return {ax: n for ax, n in mesh_shape.items()
            if ax != const.DATA_AXIS and int(n) > 1}


def verify_elastic(strategy, dead_worker: str = "") -> List[Diagnostic]:
    """ADT43x — can this job's topology survive an in-run elastic shrink
    (``runtime/elastic.py``)? Shared by the build-time lint and the
    coordinator's runtime shrink decision (``_shrink_unsound_reason``).

    - ``ADT430``: the strategy pins model-parallel mesh axes — the
      program spans the whole mesh, and removing a process removes
      shards no survivor replicates. Recovery goes through the whole-job
      checkpoint restart instead.
    - ``ADT431``: a PS group's ``reduction_destination`` lives on the dead
      worker — its host-resident state died with it, so the shrink is
      sound only with a committed checkpoint to fall back to.
    """
    out: List[Diagnostic] = []
    model_axes = fail_fast_model_axes(strategy)
    if model_axes:
        out.append(warning(
            "ADT430",
            "strategy partitions state over model-parallel mesh axes %s — "
            "removing a process removes shards no survivor replicates, so "
            "the job cannot shrink in-run" % (model_axes,),
            fixit="rely on the whole-job checkpoint restart "
                  "(ADT_ELASTIC_SYNC without ADT_ELASTIC_INRUN), or use a "
                  "data-parallel strategy for in-run elasticity"))
    dead_host = (dead_worker or "").split(":")[0]
    for node in strategy.node_config:
        for leaf in (node.part_configs or [node]):
            sync = leaf.synchronizer or node.synchronizer
            dest = getattr(sync, "reduction_destination", "") or ""
            if dead_host and dest.split(":")[0] == dead_host:
                out.append(warning(
                    "ADT431",
                    "PS group of %r is owned by dying worker %s — its "
                    "host-resident state has no live replica; the shrink "
                    "must re-shard that state from the last-good "
                    "checkpoint" % (node.var_name, dead_worker),
                    var=node.var_name,
                    fixit="keep PS destinations on the chief, or "
                          "checkpoint at least once per restart window"))
                break
    return out


def verify_preemption(strategy) -> List[Diagnostic]:
    """ADT432 — preemption handoff armed on a topology the elasticity
    matrix marks fail-fast. The planned-handoff path
    (``runtime/preemption.py``) rides the in-run elastic shrink, and a
    model-parallel strategy cannot shrink (ADT430): every announced
    departure then degrades to rescue-checkpoint + whole-job restart —
    legal, but the operator armed a graceful-handoff feature that can
    never actually hand off. Warned at BUILD time, not at the first
    eviction."""
    out: List[Diagnostic] = []
    model_axes = fail_fast_model_axes(strategy)
    if model_axes:
        out.append(warning(
            "ADT432",
            "preemption handoff is armed but the strategy partitions "
            "state over model-parallel mesh axes %s — the elasticity "
            "matrix marks this family fail-fast, so every planned "
            "departure degrades to rescue-checkpoint + whole-job "
            "restart instead of a live handoff" % (model_axes,),
            fixit="use a data-parallel strategy for live handoffs, or "
                  "accept the checkpoint-restart path and size "
                  "ADT_PREEMPT_DEADLINE_S to cover a full save"))
    return out


def verify_autoscale(policy, strategy=None,
                     max_queue: Optional[int] = None) -> List[Diagnostic]:
    """ADT44x — are a serving autoscaler's bounds sound for the strategy
    it will scale (``serving/autoscale.py``)? Run at controller
    construction, so an unsound clamp fails loudly at deploy time, not
    at the 3 a.m. shrink that would have fallen back to a checkpoint.

    - ``ADT440`` (error): the bounds arm a move the elasticity matrix
      forbids. A fail-fast model-parallel family (ADT430) cannot change
      replica count in-run at all, so any ``min_replicas <
      max_replicas`` would eventually command an impossible resize; a
      PS-backed family's floor is its distinct reduction-destination
      host count — shrinking below it retires a PS owner, and ADT431
      prices that as a checkpoint fallback, the exact thing the
      planned-departure contract promises to avoid.
    - ``ADT441`` (warning): thresholds that cannot fire or cannot
      settle — a grow trigger at/above ``max_queue`` (the tier sheds
      before the controller ever arms), or a zero sustain window with
      zero cooldowns (every sample may scale; the hysteresis band is
      the only flap guard left).
    """
    out: List[Diagnostic] = []
    if strategy is not None:
        model_axes = fail_fast_model_axes(strategy)
        if model_axes and policy.min_replicas < policy.max_replicas:
            out.append(error(
                "ADT440",
                "autoscale bounds [%d, %d] arm replica-count changes on "
                "a strategy that partitions state over model-parallel "
                "mesh axes %s — this family is fail-fast (ADT430): it "
                "can neither shrink nor grow in-run, so the first scale "
                "decision commands an impossible resize"
                % (policy.min_replicas, policy.max_replicas,
                   model_axes),
                fixit="pin min_replicas == max_replicas for this "
                      "family, or serve it from a data-parallel "
                      "strategy"))
        ps_hosts = set()
        for node in strategy.node_config:
            for leaf in (node.part_configs or [node]):
                sync = leaf.synchronizer or node.synchronizer
                dest = getattr(sync, "reduction_destination", "") or ""
                if dest:
                    ps_hosts.add(dest.split(":")[0])
        if ps_hosts and policy.min_replicas < len(ps_hosts):
            out.append(error(
                "ADT440",
                "min_replicas %d is below the PS-owner floor %d (distinct "
                "reduction-destination hosts %s) — an idle shrink would "
                "retire an owner and its authoritative host-resident "
                "state with it, forcing the checkpoint fallback (ADT431) "
                "the planned-departure path exists to avoid"
                % (policy.min_replicas, len(ps_hosts),
                   sorted(ps_hosts)),
                fixit="raise min_replicas to the PS-owner host count, "
                      "or concentrate reduction_destination on fewer "
                      "hosts"))
    if max_queue is not None and policy.queue_high >= max_queue:
        out.append(warning(
            "ADT441",
            "queue_high %.0f >= max_queue %d — submits shed at the "
            "queue bound before the grow trigger can ever arm, so the "
            "controller only ever observes a post-shed queue"
            % (policy.queue_high, max_queue),
            fixit="set queue_high well below max_queue (e.g. half) so "
                  "overload grows the fleet before it sheds clients"))
    if (policy.sustain_s == 0 and policy.grow_cooldown_s == 0
            and policy.shrink_cooldown_s == 0):
        out.append(warning(
            "ADT441",
            "sustain_s and both cooldowns are 0 — every poll may scale, "
            "leaving the hysteresis band as the only flap guard",
            fixit="give the policy a sustain window (seconds) or "
                  "non-zero per-direction cooldowns"))
    return out
