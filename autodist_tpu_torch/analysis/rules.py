"""The plan rules the port's first slice runs: copies of
``autodist_tpu/analysis/rules.py::missing_trainable_configs`` (ADT101, the
compile path's hard failure) and ``verify_decode`` (ADT442, the decode
engine's cache-vs-memory projection)."""
from typing import List, Optional

from autodist_tpu_torch.analysis.diagnostics import Diagnostic, warning

GIB = float(1 << 30)


def missing_trainable_configs(strategy, trainable_names) -> List[str]:
    """Trainable variables the strategy has no node for (ADT101).

    The single implementation behind both the linter rule and
    ``StrategyCompiler.compile``'s hard failure."""
    have = {n.var_name for n in strategy.node_config}
    return sorted(set(trainable_names) - have)


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
