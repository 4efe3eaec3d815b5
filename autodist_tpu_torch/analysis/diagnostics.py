"""Typed diagnostics for the pre-compile strategy verifier.

Every check in ``autodist_tpu_torch.analysis`` reports through one shape:
:class:`Diagnostic` — a stable code, a severity, the variable (or graph
node) it anchors to, a human message, and a one-line suggested fix. Codes
are stable across releases so CI greps, issue reports, and suppressions
can key on them:

- ``ADT1xx`` — plan-shape errors (missing/duplicate/unknown nodes,
  replica and mesh geometry);
- ``ADT2xx`` — partitioning/divisibility (partitioner strings, shard
  sizes, model-parallel ``mp_axes``);
- ``ADT3xx`` — synchronizer/compressor configuration;
- ``ADT4xx`` — runtime hazards (warnings by default: pipeline bubbles,
  PS hot spots, lowered-program smells);
- ``ADT5xx`` — memory footprint and collective schedule (projected OOM,
  budget pressure, cross-program schedule deadlocks).

The compile path raises :class:`DiagnosticError` — a ``ValueError``
carrying the same :class:`Diagnostic` the linter would report — so lint
time and compile time can never disagree about what is wrong.
"""
import dataclasses
import enum
from typing import Iterable, List, Sequence


class Severity(enum.IntEnum):
    """Ordered so ``severity >= Severity.ERROR`` reads naturally."""

    INFO = 0
    WARNING = 1
    ERROR = 2

    def __str__(self):
        return self.name.lower()


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding of the static analyzer.

    ``var`` is the strategy node (variable name) the finding anchors to;
    empty for graph-level findings. ``fixit`` is a one-line suggested fix,
    empty when there is no mechanical suggestion.
    """

    code: str
    severity: Severity
    message: str
    var: str = ""
    fixit: str = ""

    def format(self) -> str:
        where = " [%s]" % self.var if self.var else ""
        fix = " (fix: %s)" % self.fixit if self.fixit else ""
        return "%s %s%s: %s%s" % (self.code, self.severity, where,
                                  self.message, fix)

    def to_dict(self) -> dict:
        return {"code": self.code, "severity": str(self.severity),
                "var": self.var, "message": self.message, "fixit": self.fixit}


def error(code: str, message: str, var: str = "", fixit: str = "") -> Diagnostic:
    return Diagnostic(code, Severity.ERROR, message, var, fixit)


def warning(code: str, message: str, var: str = "", fixit: str = "") -> Diagnostic:
    return Diagnostic(code, Severity.WARNING, message, var, fixit)


def info(code: str, message: str, var: str = "", fixit: str = "") -> Diagnostic:
    return Diagnostic(code, Severity.INFO, message, var, fixit)


class DiagnosticError(ValueError):
    """A rule violation raised on the compile path.

    Subclasses ``ValueError`` so every pre-existing ``except ValueError``
    (and test asserting one) keeps working; carries the structured
    :class:`Diagnostic` so callers — and the linter, which runs the same
    rule functions — see identical content.
    """

    def __init__(self, diagnostic: Diagnostic):
        super().__init__(diagnostic.format())
        self.diagnostic = diagnostic

    @property
    def code(self) -> str:
        return self.diagnostic.code


class StrategyVerificationError(ValueError):
    """Raised by ``AutoDist(validate="error")`` when the verifier finds
    error-severity diagnostics before kernel transformation."""

    def __init__(self, diagnostics: Sequence[Diagnostic]):
        self.diagnostics = list(diagnostics)
        lines = [d.format() for d in self.diagnostics]
        super().__init__(
            "strategy failed verification with %d error(s):\n  %s"
            % (len(lines), "\n  ".join(lines)))


def max_severity(diags: Iterable[Diagnostic]) -> Severity:
    out = Severity.INFO
    for d in diags:
        if d.severity > out:
            out = d.severity
    return out


def has_errors(diags: Iterable[Diagnostic]) -> bool:
    return any(d.severity >= Severity.ERROR for d in diags)


def sort_diagnostics(diags: Iterable[Diagnostic]) -> List[Diagnostic]:
    """Most severe first, then by code, then by anchoring var."""
    return sorted(diags, key=lambda d: (-int(d.severity), d.code, d.var))


def format_table(diags: Sequence[Diagnostic]) -> str:
    """Render diagnostics as an aligned text table (the CLI's output)."""
    if not diags:
        return "no diagnostics: plan is clean"
    rows = [("CODE", "SEVERITY", "VAR", "MESSAGE")]
    for d in sort_diagnostics(diags):
        msg = d.message + (" | fix: %s" % d.fixit if d.fixit else "")
        rows.append((d.code, str(d.severity), d.var or "-", msg))
    widths = [max(len(r[i]) for r in rows) for i in range(3)]
    lines = []
    for r in rows:
        lines.append("  ".join([r[0].ljust(widths[0]), r[1].ljust(widths[1]),
                                r[2].ljust(widths[2]), r[3]]).rstrip())
    n_err = sum(1 for d in diags if d.severity == Severity.ERROR)
    n_warn = sum(1 for d in diags if d.severity == Severity.WARNING)
    n_info = len(diags) - n_err - n_warn
    lines.append("%d error(s), %d warning(s), %d info" % (n_err, n_warn, n_info))
    return "\n".join(lines)


# ---------------------------------------------------------------- catalog

# Stable code -> short title. The single registry docs/linting.md and the
# tests enumerate; adding a rule means adding its code here.
CODES = {
    # ADT1xx — plan shape
    "ADT101": "trainable variable has no strategy node",
    "ADT102": "strategy node references unknown variable",
    "ADT103": "duplicate strategy node for one variable",
    "ADT104": "strategy has no replica devices",
    "ADT105": "replica device not in the resource spec",
    "ADT106": "mesh shape does not multiply out to the replica count",
    "ADT107": "mesh axis name unknown to the framework",
    "ADT108": "trainable node carries no synchronizer",
    "ADT109": "part_configs count disagrees with the partitioner",
    "ADT110": "batch/sequence axis missing from the mesh",
    # ADT2xx — partitioning / divisibility
    "ADT201": "malformed partitioner string",
    "ADT202": "partitioner rank disagrees with the variable rank",
    "ADT203": "split dimension smaller than the device count",
    "ADT204": "multi-axis partitioner unsupported",
    "ADT205": "mp_axes names a mesh axis absent from the mesh",
    "ADT206": "mp_axes dimension not exactly divisible by its mesh axis",
    "ADT207": "duplicate-axis sharding conflict",
    "ADT208": "shard_sizes inconsistent with the split dimension",
    "ADT209": "split dimension pads to a multiple of the mesh axis",
    # ADT3xx — synchronizer / compressor
    "ADT301": "unknown synchronizer kind",
    "ADT302": "PS reduction_destination is empty",
    "ADT303": "PS reduction_destination not in the resource spec",
    "ADT304": "invalid staleness configuration",
    "ADT305": "unknown or malformed compressor",
    "ADT306": "compressor is ignored on this synchronization path",
    "ADT307": "async PS plan is not all-or-nothing",
    "ADT308": "PowerSGD on a sub-matrix tensor passes through",
    "ADT309": "sparse variable on a dense-only synchronization path",
    "ADT310": "wire_dtype quantization on an incompatible variable or path",
    "ADT311": "quantized variable smaller than one scale block",
    # ADT4xx — runtime hazards
    "ADT401": "pipeline bubble dominates the schedule",
    "ADT402": "invalid pipeline schedule configuration",
    "ADT403": "parameter-server load imbalance",
    "ADT404": "staleness window is a no-op in this topology",
    "ADT405": "lowered program all-gathers a model-parallel parameter",
    "ADT406": "lowered program transfers to host on the hot path",
    "ADT407": "collective under divergent control flow",
    "ADT408": "host transfer inside a while/scan body (per-iteration cost)",
    "ADT420": "sentinel requested but the program lowered without health "
              "guards",
    "ADT421": "PS apply window larger than the sentinel skip window",
    "ADT430": "in-run elastic shrink requested on a topology that cannot "
              "shrink",
    "ADT431": "in-run elastic shrink loses a PS owner (checkpoint "
              "fallback required)",
    "ADT432": "preemption handoff armed on a fail-fast (model-parallel) "
              "topology",
    "ADT440": "autoscale bounds unsound for this strategy (shrink below "
              "the safe replica floor)",
    "ADT441": "autoscale thresholds cannot work as configured",
    # ADT5xx — memory footprint & collective schedule (analysis/hlo.py,
    # analysis/memory.py)
    "ADT501": "projected per-device OOM: peak HBM exceeds the budget",
    "ADT502": "peak HBM within 10% of the budget",
    "ADT503": "un-donated superstep carry doubles state residency",
    "ADT510": "same-mesh programs issue incompatible collective orders",
    "ADT511": "cross-program replica-group mismatch on a collective",
    "ADT520": "flat collective spans the inter-host level where the "
              "hierarchical schedule crosses provably fewer bytes",
    "ADT521": "replica group straddles hosts non-contiguously",
    "ADT522": "synthesized schedule is not reduction-equivalent to the "
              "op it replaces",
    "ADT523": "per-level byte estimate exceeds the level's "
              "bandwidth-delay budget",
    "ADT524": "malformed topology spec",
    "ADT525": "topology cannot price this collective/plan",
    # ADT6xx — numerics safety (analysis/numerics.py, rules.verify_numerics):
    # the static gate that makes the bf16 compute tier shippable — low-
    # precision compute is allowed, low-precision ACCUMULATION and low-
    # precision MASTER STATE are not
    "ADT601": "half-precision accumulation in a reduction/psum",
    "ADT602": "optimizer state or master params stored in half precision",
    "ADT603": "loss/verdict computed in half precision",
    "ADT604": "bf16 compute armed without a sentinel policy",
    "ADT605": "cross-program dtype mismatch on order-compatible collectives",
}
