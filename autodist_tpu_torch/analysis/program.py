"""Structured parser over the port's recorded program text (the
counterpart of ``autodist_tpu/analysis/hlo.py``).

The JAX package lowers its step with ``jax.jit(...).lower().as_text()``
and parses that StableHLO. The port has no compiler: its step is eager
torch. Its "lowered program" is the step itself, run once on fake tensors
under a recorder (``kernel/lowering.py``) that writes one line per
dispatched op — the eager program torch's caching allocator and the card
really see, with nothing fused and every buffer freed at its last Python
reference. This module parses that text into functions, statements,
arguments and results, so the same deeper analyses the JAX module serves
apply:

- the **collective schedule**: the ordered collectives a program issues
  (cost class, the rank's group, payload bytes, microstep), and
  :func:`compare_schedules`, which turns the mismatched-schedule deadlock
  of two programs on one mesh into ``ADT510``/``ADT511`` findings;
- the **memory analysis** (``analysis/memory.py``): entry buffer sizes,
  donation, and a liveness sweep over the recorded allocations and frees.

Text-based on purpose, as the JAX module is: the analyses work on a dump
saved from a run on the card (``Runner.lowered_text``) and shipped
elsewhere, without running anything again (``python -m
autodist_tpu_torch.analysis --programs``).

The format, one record a line::

    program @train fuse_steps=1 donate=true rank=0 ranks=2 device=cpu
    arg %0 params['w1'] : f32[64,128] s0 +32768 donated
    %5 = aten.mm.default(%3, %0) : f32[32,128] s4 +16384
    %6 = aten.t.default(%0) : f32[128,64] s0
    %9 = c10d.allreduce_.default(%8) : f32[128] s7 bwd {collective=reduce group=[0,1] payload=512 dtype=f32 elems=128}
    _ = aten._local_scalar_dense.default(%7) : scalar {host=read}
    free s4 16384
    microstep 0 {
    }
    result %9 params['w1']
    end

A result is ``dtype[shape] s<storage>``, ``+<bytes>`` where the op
allocated that storage, and its device where it is not the program's.
``bwd`` marks an op the autograd engine ran; ``free`` lines mark the
storages the run released. The parser is forgiving: a line it does not
know is skipped.
"""
import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

from autodist_tpu_torch.analysis.diagnostics import (Diagnostic, error,
                                                     sort_diagnostics,
                                                     warning)

# ------------------------------------------------------------------ types

DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2,
    "f8e4m3fn": 1, "f8e5m2": 1,
    "i64": 8, "ui64": 8, "i32": 4, "ui32": 4, "i16": 2, "ui16": 2,
    "i8": 1, "ui8": 1, "i1": 1,
    "c64": 8, "c128": 16,
}

HALF_DTYPES = frozenset({"bf16", "f16"})

# the cost classes of the c10d ops: the classes ``simulator/cost_model.py``
# prices (the JAX ``hlo.COLLECTIVE_CLASS`` maps the StableHLO spellings)
COLLECTIVE_CLASS = {
    "allreduce_": "reduce", "allreduce_coalesced_": "reduce",
    "reduce_": "reduce",
    "reduce_scatter_": "scatter", "_reduce_scatter_base_": "scatter",
    "reduce_scatter_tensor_coalesced_": "scatter",
    "allgather_": "gather", "_allgather_base_": "gather",
    "allgather_into_tensor_coalesced_": "gather",
    "allgather_coalesced_": "gather", "gather_": "gather",
    # a broadcast moves one rank's payload to every other, as a gather
    "broadcast_": "gather", "scatter_": "scatter",
    "alltoall_": "alltoall", "alltoall_base_": "alltoall",
    "send": "permute", "recv_": "permute",
}


def elems_of(shape: Sequence[int]) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


# ------------------------------------------------------------- dataclasses


@dataclasses.dataclass(frozen=True)
class Arg:
    """One entry argument of the program: a tensor the step reads."""

    index: int
    type_bytes: int
    dtype: str = ""
    shape: Tuple[int, ...] = ()
    label: str = ""
    storage: str = ""
    storage_bytes: int = 0
    donated: bool = False
    value_id: str = ""

    @property
    def per_device_bytes(self) -> float:
        return float(self.type_bytes)


@dataclasses.dataclass(frozen=True)
class Result:
    """One entry result: the value the step returns under ``label``."""

    index: int
    type_bytes: int
    result_info: str = ""
    dtype: str = ""
    value_id: str = ""
    storage: str = ""
    storage_bytes: int = 0


@dataclasses.dataclass
class Statement:
    """One recorded op."""

    result_id: str                 # first result's id ("" for none)
    op: str                        # e.g. "aten.mm.default"
    operand_ids: List[str]
    out_bytes: List[int]
    lineno: int
    loop_depth: int                # 1 inside a microstep of a fused program
    out_dtypes: List[str] = dataclasses.field(default_factory=list)
    result_ids: List[str] = dataclasses.field(default_factory=list)
    out_shapes: List[Tuple[int, ...]] = dataclasses.field(
        default_factory=list)
    storages: List[str] = dataclasses.field(default_factory=list)
    # bytes of each result's storage where this op allocated it, else 0
    alloc_bytes: List[int] = dataclasses.field(default_factory=list)
    devices: List[str] = dataclasses.field(default_factory=list)
    backward: bool = False
    microstep: int = -1
    attrs: Dict[str, str] = dataclasses.field(default_factory=dict)
    collective: Optional["CollectiveOp"] = None

    @property
    def total_out_bytes(self) -> int:
        return sum(self.out_bytes)

    @property
    def out_dtype(self) -> str:
        return self.out_dtypes[0] if self.out_dtypes else ""

    @property
    def short_op(self) -> str:
        """The op's name without its namespace and overload: ``mm``."""
        parts = self.op.split(".")
        return parts[1] if len(parts) >= 2 else self.op

    @property
    def host(self) -> str:
        """``read`` (a value read to the host), ``copy`` (a copy between
        the host and the card) or ``""``."""
        return self.attrs.get("host", "")


@dataclasses.dataclass(frozen=True)
class CollectiveOp:
    """One collective in program order (the JAX record's fields;
    ``microstep`` says which microstep of a fused program issued it)."""

    kind: str
    op: str
    payload_bytes: int
    result_bytes: int
    replica_groups: Tuple[Tuple[int, ...], ...]
    channel: int
    lineno: int
    loop_depth: int
    elem_dtype: str = ""
    payload_elems: int = 0
    microstep: int = -1

    @property
    def group_size(self) -> int:
        return len(self.replica_groups[0]) if self.replica_groups else 1

    def signature(self) -> tuple:
        """What two programs must agree on to rendezvous here."""
        return (self.kind, self.replica_groups, self.payload_bytes)

    def describe(self) -> str:
        return "%s(%dB, groups=%s)" % (
            self.op, self.payload_bytes,
            [list(g) for g in self.replica_groups] or "?")


@dataclasses.dataclass
class Free:
    storage: str
    nbytes: int
    lineno: int


@dataclasses.dataclass
class Function:
    name: str
    args: List[Arg]
    results: List[Result]
    statements: List[Statement]
    frees: List[Free] = dataclasses.field(default_factory=list)
    lineno: int = 0

    @property
    def returned_ids(self) -> set:
        return {r.value_id for r in self.results}


@dataclasses.dataclass
class Program:
    funcs: Dict[str, Function]
    entry: Optional[Function]
    num_partitions: int = 1      # the job's ranks
    attrs: Dict[str, str] = dataclasses.field(default_factory=dict)

    def collectives(self) -> List[CollectiveOp]:
        return collective_schedule(self)

    @property
    def fuse_steps(self) -> int:
        return int(self.attrs.get("fuse_steps", 1))


# ------------------------------------------------------------------ parser

_PROGRAM_RE = re.compile(r"^program\s+@([\w.-]+)(.*)$")
_KV_RE = re.compile(r"(\w+)=(\S+)")
_ARG_RE = re.compile(r"^arg\s+%(\w+)\s+(.*?)\s+:\s+(.*)$")
_RESULT_RE = re.compile(r"^result\s+%(\w+)\s*(.*)$")
_FREE_RE = re.compile(r"^free\s+(s\d+)\s+(\d+)")
_MICRO_RE = re.compile(r"^microstep\s+(\d+)\s*\{")
_STMT_RE = re.compile(r"^((?:%\w+)(?:,\s*%\w+)*|_)\s*=\s*([\w.]+)\((.*?)\)"
                      r"\s*:\s*(.*)$")
_TYPE_RE = re.compile(r"(\w+)\[([\d,\s]*)\]\s+(s\d+)(?:\s+\+(\d+))?"
                      r"(?:\s+((?:cpu|cuda|meta)(?::\d+)?))?")
_ATTRS_RE = re.compile(r"\{(.*)\}\s*$")
_GROUP_RE = re.compile(r"group=\[([\d,\s]*)\]")


def parse_types(segment: str):
    """``(dtype, shape, storage, alloc bytes, device)`` of each
    ``dtype[shape] s<N> [+bytes] [device]`` in ``segment``."""
    out = []
    for m in _TYPE_RE.finditer(segment):
        shape = tuple(int(x) for x in m.group(2).replace(" ", "").split(",")
                      if x)
        out.append((m.group(1), shape, m.group(3), int(m.group(4) or 0),
                    m.group(5) or ""))
    return out


def type_bytes(dtype: str, shape: Sequence[int]) -> int:
    return elems_of(shape) * DTYPE_BYTES.get(dtype, 4)


def _parse_attrs(segment: str) -> Dict[str, str]:
    m = _ATTRS_RE.search(segment)
    if not m:
        return {}
    body = m.group(1)
    attrs = {}
    g = _GROUP_RE.search(body)
    if g:
        attrs["group"] = g.group(1).replace(" ", "")
        body = body[:g.start()] + body[g.end():]
    attrs.update(dict(_KV_RE.findall(body)))
    return attrs


def parse_program_text(text: str) -> Program:
    """Parse a recorded program into its function, statements, frees,
    arguments and results. Lines that match no record are skipped, so a
    partial dump parses to a smaller model rather than failing."""
    funcs: Dict[str, Function] = {}
    entry: Optional[Function] = None
    attrs: Dict[str, str] = {}
    cur: Optional[Function] = None
    microstep = -1
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        m = _PROGRAM_RE.match(line)
        if m:
            attrs = dict(_KV_RE.findall(m.group(2)))
            cur = Function(name=m.group(1), args=[], results=[],
                           statements=[], lineno=lineno)
            funcs[cur.name] = cur
            if entry is None:
                entry = cur
            microstep = -1
            continue
        if cur is None:
            continue
        if line == "end":
            cur = None
            continue
        m = _MICRO_RE.match(line)
        if m:
            microstep = int(m.group(1))
            continue
        if line == "}":
            microstep = -1
            continue
        m = _FREE_RE.match(line)
        if m:
            cur.frees.append(Free(m.group(1), int(m.group(2)), lineno))
            continue
        m = _ARG_RE.match(line)
        if m:
            types = parse_types(m.group(3))
            dtype, shape, storage, alloc, _ = (types[0] if types
                                               else ("", (), "", 0, ""))
            cur.args.append(Arg(
                index=len(cur.args), type_bytes=type_bytes(dtype, shape),
                dtype=dtype, shape=shape, label=m.group(2),
                storage=storage, storage_bytes=alloc,
                donated=m.group(3).rstrip().endswith("donated"),
                value_id=m.group(1)))
            continue
        m = _RESULT_RE.match(line)
        if m:
            cur.results.append(Result(index=len(cur.results), type_bytes=0,
                                      result_info=m.group(2),
                                      value_id=m.group(1)))
            continue
        m = _STMT_RE.match(line)
        if m:
            cur.statements.append(_statement(m, line, lineno, microstep))
    if entry is not None:
        _resolve_results(entry)
    return Program(funcs=funcs, entry=entry,
                   num_partitions=int(attrs.get("ranks", 1)), attrs=attrs)


def _statement(m, line: str, lineno: int, microstep: int) -> Statement:
    ids = [] if m.group(1) == "_" else [
        x.strip().lstrip("%") for x in m.group(1).split(",")]
    op = m.group(2)
    operands = re.findall(r"%(\w+)", m.group(3))
    rhs = m.group(4)
    attrs = _parse_attrs(rhs)
    body = _ATTRS_RE.sub("", rhs)
    types = parse_types(body)
    st = Statement(
        result_id=ids[0] if ids else "", op=op, operand_ids=operands,
        out_bytes=[type_bytes(t[0], t[1]) for t in types], lineno=lineno,
        loop_depth=1 if microstep >= 0 else 0,
        out_dtypes=[t[0] for t in types], result_ids=ids,
        out_shapes=[t[1] for t in types], storages=[t[2] for t in types],
        alloc_bytes=[t[3] for t in types], devices=[t[4] for t in types],
        backward=bool(re.search(r"\sbwd(\s|$)", body)),
        microstep=microstep, attrs=attrs)
    kind = attrs.get("collective")
    if kind:
        group = tuple(int(x) for x in attrs.get("group", "").split(",") if x)
        st.collective = CollectiveOp(
            kind=kind, op=op, payload_bytes=int(attrs.get("payload", 0)),
            result_bytes=st.total_out_bytes,
            replica_groups=(group,) if group else (),
            channel=0, lineno=lineno, loop_depth=st.loop_depth,
            elem_dtype=attrs.get("dtype", ""),
            payload_elems=int(attrs.get("elems", 0)),
            microstep=microstep)
    return st


def _resolve_results(func: Function) -> None:
    """Give each result the type of the value it names (the statement or
    argument that defined that id last)."""
    defs: Dict[str, tuple] = {a.value_id: (a.dtype, a.shape, a.storage)
                              for a in func.args}
    for st in func.statements:
        for rid, dt, shape, sto in zip(st.result_ids, st.out_dtypes,
                                       st.out_shapes, st.storages):
            defs[rid] = (dt, shape, sto)
    sizes = storage_sizes(func)
    out = []
    for r in func.results:
        dt, shape, sto = defs.get(r.value_id, ("", (), ""))
        out.append(dataclasses.replace(
            r, type_bytes=type_bytes(dt, shape) if dt else 0, dtype=dt,
            storage=sto, storage_bytes=sizes.get(sto, 0)))
    func.results = out


def storage_sizes(func: Function) -> Dict[str, int]:
    """Bytes of each storage the program allocated or was given."""
    sizes: Dict[str, int] = {}
    for a in func.args:
        if a.storage:
            sizes[a.storage] = max(sizes.get(a.storage, 0), a.storage_bytes)
    for st in func.statements:
        for sto, alloc in zip(st.storages, st.alloc_bytes):
            if alloc:
                sizes[sto] = alloc
    return sizes


# ------------------------------------------------------------- schedules


class CollectiveSchedule(list):
    """Ordered :class:`CollectiveOp`\\ s of one program (a ``list`` with
    schedule-level helpers)."""

    @property
    def total_payload_bytes(self) -> int:
        return sum(c.payload_bytes for c in self)

    def class_payload_bytes(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for c in self:
            out[c.kind] = out.get(c.kind, 0) + c.payload_bytes
        return out

    def per_step(self) -> "CollectiveSchedule":
        """The per-iteration schedule. A fused program records its k
        microsteps one after the other, each in its own ``microstep``
        region, so when every collective sits in one the first
        microstep's are the per-step schedule (the JAX program's loop
        body, which its text holds once). A program with any collective
        outside a microstep is already per step."""
        if not self or any(c.loop_depth == 0 for c in self):
            return self
        first = self[0].microstep
        return CollectiveSchedule(
            dataclasses.replace(c, loop_depth=c.loop_depth - 1)
            for c in self if c.microstep == first)

    def signature(self) -> tuple:
        return tuple(c.signature() for c in self)


def collective_schedule(text_or_program) -> CollectiveSchedule:
    """The ordered collective schedule of a recorded program."""
    program = (text_or_program if isinstance(text_or_program, Program)
               else parse_program_text(text_or_program))
    out = CollectiveSchedule()
    if program.entry is None:
        return out
    for st in program.entry.statements:
        if st.collective is not None:
            out.append(st.collective)
    return out


def _embeds(needle: Sequence[tuple], haystack: Sequence[tuple]) -> bool:
    """True when ``needle`` is an ordered subsequence of ``haystack``."""
    it = iter(haystack)
    return all(any(h == n for h in it) for n in needle)


def compare_schedules(ref, other, ref_label: str = "train",
                      other_label: str = "eval") -> List[Diagnostic]:
    """Cross-program collective-schedule consistency (ADT510/ADT511), as
    the JAX ``hlo.compare_schedules``: ``other``'s per-step schedule must
    embed (an ordered subsequence matching kind, groups and payload) into
    ``ref``'s, or ranks running the two programs on one mesh block in
    different collectives; a kind sequence that embeds with other groups
    is the softer ``ADT511``. Accepts schedules, programs or text."""
    ref_sched = _as_schedule(ref).per_step()
    other_sched = _as_schedule(other).per_step()
    out: List[Diagnostic] = []
    if not other_sched or not ref_sched:
        return out
    if _embeds([c.signature() for c in other_sched],
               [c.signature() for c in ref_sched]):
        return out
    order_ref = [(c.kind, c.payload_bytes) for c in ref_sched]
    order_other = [(c.kind, c.payload_bytes) for c in other_sched]
    if _embeds(order_other, order_ref):
        it = iter(ref_sched)
        for oc in other_sched:
            for rc in it:
                if (rc.kind, rc.payload_bytes) == (oc.kind,
                                                   oc.payload_bytes):
                    if (rc.replica_groups != oc.replica_groups
                            and rc.replica_groups and oc.replica_groups):
                        out.append(warning(
                            "ADT511",
                            "%s and %s programs disagree on replica groups "
                            "for a %s collective: %s vs %s (lines %d/%d) — "
                            "on a shared mesh the rendezvous never "
                            "completes" % (
                                ref_label, other_label, oc.kind,
                                rc.describe(), oc.describe(),
                                rc.lineno, oc.lineno),
                            fixit="rebuild both programs from the same "
                                  "compiled strategy so device meshes and "
                                  "axis groupings agree"))
                    break
        if not out:
            out.append(warning(
                "ADT511",
                "%s program's collectives embed into %s's by kind and "
                "payload but differ in grouping/channel annotations"
                % (other_label, ref_label),
                fixit="rebuild both programs from the same compiled "
                      "strategy"))
        return sort_diagnostics(out)
    out.append(error(
        "ADT510",
        "%s and %s programs issue incompatible collective orders on the "
        "same mesh: %s's sequence [%s] does not embed into %s's [%s] — "
        "replicas running different programs will block in mismatched "
        "collectives and deadlock" % (
            ref_label, other_label, other_label,
            ", ".join("%s:%dB" % (c.kind, c.payload_bytes)
                      for c in other_sched), ref_label,
            ", ".join("%s:%dB" % (c.kind, c.payload_bytes)
                      for c in ref_sched)),
        fixit="derive every same-mesh program (train/eval/fused) from one "
              "compiled strategy and do not reorder collectives by hand"))
    return sort_diagnostics(out)


def _as_schedule(x) -> CollectiveSchedule:
    if isinstance(x, CollectiveSchedule):
        return x
    if isinstance(x, (Program, str)):
        return collective_schedule(x)
    return CollectiveSchedule(x)
