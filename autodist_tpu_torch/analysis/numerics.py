"""ADT6xx numerics-safety analysis: a dtype-flow pass over the recorded
program (the port of ``autodist_tpu/analysis/numerics.py``).

The discipline certified is the f32-master rule of mixed-precision
training: low-precision compute is allowed, low-precision ACCUMULATION
and low-precision MASTER STATE are not.

- the cross-replica sum of gradients (an all-reduce, a reduce-scatter)
  must run on f32 values (ADT601);
- the authoritative parameter copy must stay f32: a parameter that
  round-trips ``f32 -> bf16 -> f32`` through value-preserving ops has
  absorbed bf16 rounding (ADT602);
- the loss handed to the sentinel must be f32 (ADT603);
- two programs on one mesh must agree on the dtype of each collective
  they share (ADT605).

:func:`lint_text` is the per-program pass (ADT601/602/603),
:func:`compare_schedule_dtypes` the cross-program check (ADT605), and
:func:`lint_programs` both over a set of programs. Plan-level rules
(ADT601/602/604 before any recording) live in ``analysis/rules.py``.
"""
from typing import Dict, List, Mapping, Optional

from autodist_tpu_torch.analysis.diagnostics import (Diagnostic, error,
                                                     sort_diagnostics,
                                                     warning)
from autodist_tpu_torch.analysis.program import (HALF_DTYPES,
                                                 CollectiveSchedule, Program,
                                                 _as_schedule,
                                                 parse_program_text)

# ops that carry a value through unchanged, element for element: the only
# edges the f32-master taint crosses (arithmetic derives a new value)
VALUE_PRESERVING_OPS = frozenset({
    "_to_copy", "view", "_unsafe_view", "reshape", "t", "transpose",
    "permute", "clone", "detach", "alias", "expand", "contiguous",
})

# the cost classes that ACCUMULATE across replicas
_ACCUMULATING_KINDS = frozenset({"reduce", "scatter"})


def _half_width(dtype: str) -> int:
    return 2 if dtype in HALF_DTYPES else 4


def lint_text(text_or_program, label: str = "") -> List[Diagnostic]:
    """Dtype-flow lint of one recorded program (ADT601/602/603)."""
    program = (text_or_program if isinstance(text_or_program, Program)
               else parse_program_text(text_or_program))
    where = " in %s" % label if label else ""
    out: List[Diagnostic] = []
    for coll in program.collectives():
        if coll.kind not in _ACCUMULATING_KINDS:
            continue
        if coll.elem_dtype not in HALF_DTYPES:
            continue
        elems = coll.payload_elems
        if elems == 0 and coll.payload_bytes:
            elems = coll.payload_bytes // _half_width(coll.elem_dtype)
        if elems > 1:
            out.append(error(
                "ADT601",
                "%s accumulation in %s%s: %s at line %d sums %d %s "
                "elements across replicas — every hop of the reduction "
                "rounds, so the gradient sum loses low-order bits that "
                "f32 accumulation would keep" % (
                    coll.elem_dtype, coll.op, where, coll.describe(),
                    coll.lineno, elems, coll.elem_dtype),
                fixit="cast the operand to f32 before the collective "
                      "(bf16 compute, f32 accumulation) — the built-in "
                      "bf16 tier does this"))
        else:
            out.append(warning(
                "ADT603",
                "scalar %s %s%s at line %d: a cross-replica scalar sum "
                "in half precision is a loss/verdict computed on rounded "
                "values — the sentinel's EWMA judges what it is given" % (
                    coll.elem_dtype, coll.op, where, coll.lineno),
                fixit="cast the loss to f32 before the mean"))
    out.extend(_master_roundtrips(program, where))
    entry = program.entry
    if entry is not None:
        for res in entry.results:
            if res.dtype in HALF_DTYPES and res.type_bytes <= 2:
                out.append(warning(
                    "ADT603",
                    "entry result #%d (%s)%s is a %s scalar — a loss/metric "
                    "returned in half precision feeds rounded values to "
                    "everything that judges it (sentinel EWMA, early "
                    "stopping, logging)" % (res.index, res.result_info,
                                            where, res.dtype),
                    fixit="compute and return the loss in f32"))
    return sort_diagnostics(out)


def _master_roundtrips(program: Program, where: str) -> List[Diagnostic]:
    """f32 parameters that flow ``f32 -> half -> f32`` through
    value-preserving ops only: the f32 value produced IS the rounded half
    value, so a consumer of it has lost the master copy."""
    entry = program.entry
    if entry is None:
        return []
    taint: Dict[str, tuple] = {
        a.value_id: ("master", a.label) for a in entry.args
        if a.dtype == "f32"
        and a.label.startswith(("params", "opt_state", "ps"))}
    if not taint:
        return []
    used: set = set()
    for st in entry.statements:
        used.update(st.operand_ids)
    returned = entry.returned_ids
    out: List[Diagnostic] = []
    flagged: set = set()
    for st in entry.statements:
        if st.short_op not in VALUE_PRESERVING_OPS or not st.result_id:
            continue
        src = next((taint[o] for o in st.operand_ids if o in taint), None)
        if src is None:
            continue
        state, origin = src
        dt = st.out_dtype
        if st.short_op == "_to_copy":
            if state == "master" and dt in HALF_DTYPES:
                taint[st.result_id] = ("half", origin)
            elif state == "half" and dt == "f32":
                if st.result_id in used or st.result_id in returned:
                    if origin not in flagged:
                        flagged.add(origin)
                        out.append(error(
                            "ADT602",
                            "f32 master destroyed%s: %s round-trips f32 -> "
                            "half -> f32 through value-preserving ops (cast "
                            "back at line %d) — the 'f32' value carries "
                            "bf16 rounding, so no authoritative copy "
                            "survives the step" % (where, origin,
                                                   st.lineno),
                            var=origin,
                            fixit="keep the f32 master out of the half "
                                  "cast chain: update params from f32 "
                                  "grads and only cast a COPY down for "
                                  "compute"))
            elif dt == "f32" or dt in HALF_DTYPES:
                taint[st.result_id] = (state, origin)
        else:
            taint[st.result_id] = (state, origin)
    return out


def compare_schedule_dtypes(ref, other, ref_label: str = "train",
                            other_label: str = "eval") -> List[Diagnostic]:
    """Cross-program collective DTYPE consistency (ADT605): two programs
    whose collectives are order-compatible (same kind, groups and element
    count at matching positions) but disagree on the element dtype."""
    ref_sched: CollectiveSchedule = _as_schedule(ref).per_step()
    other_sched: CollectiveSchedule = _as_schedule(other).per_step()
    out: List[Diagnostic] = []
    it = iter(ref_sched)
    for oc in other_sched:
        if not (oc.elem_dtype and oc.payload_elems):
            continue
        for rc in it:
            if (rc.kind == oc.kind
                    and rc.replica_groups == oc.replica_groups
                    and rc.payload_elems == oc.payload_elems
                    and rc.elem_dtype and rc.payload_elems):
                if rc.elem_dtype != oc.elem_dtype:
                    out.append(error(
                        "ADT605",
                        "%s and %s programs disagree on the element dtype "
                        "of an order-compatible %s collective: %s sends "
                        "%s, %s sends %s (%d elements, lines %d/%d) — the "
                        "rendezvous exchanges mistyped words" % (
                            ref_label, other_label, oc.kind, ref_label,
                            rc.elem_dtype, other_label, oc.elem_dtype,
                            oc.payload_elems, rc.lineno, oc.lineno),
                        fixit="build both programs from one compiled "
                              "strategy with one compute_dtype"))
                break
    return sort_diagnostics(out)


def lint_programs(programs: Mapping[str, str],
                  parsed: Optional[Dict[str, Program]] = None
                  ) -> List[Diagnostic]:
    """Numerics lint over a set of same-mesh programs: :func:`lint_text`
    on each, plus ADT605 of each against the first (the reference)."""
    out: List[Diagnostic] = []
    names = list(programs)
    progs = {}
    for name in names:
        prog = (parsed or {}).get(name)
        if prog is None:
            prog = parse_program_text(programs[name])
        progs[name] = prog
        out.extend(lint_text(prog, label=name))
    for name in names[1:]:
        out.extend(compare_schedule_dtypes(
            progs[names[0]], progs[name],
            ref_label=names[0], other_label=name))
    return sort_diagnostics(out)
