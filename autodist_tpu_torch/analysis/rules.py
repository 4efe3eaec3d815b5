"""The plan rules the port runs: copies of
``autodist_tpu/analysis/rules.py::missing_trainable_configs`` (ADT101, the
compile path's hard failure), ``check_mp_axes_node`` (ADT205/206/207, the
partitioner's model-parallel layout check), ``verify_sentinel``
(ADT420/421, the health sentinel against the lowered step) and
``verify_decode`` (ADT442, the decode engine's cache-vs-memory
projection)."""
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
