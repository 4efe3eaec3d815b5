"""Lint the recorded program (the port of ``autodist_tpu/analysis/
lowered.py``).

The plan-level rules (``rules.py``) prove the Strategy well-formed; this
second pass inspects what the step really does — the program
``Runner.lowered_text()`` records (``kernel/lowering.py``) — for hazards
no plan-level rule can see:

- ``ADT405``: an all-gather whose result has the FULL shape of a
  model-parallel (``mp_axes``) variable: its compute should consume the
  local shard, so the "parallel" run pays replicated bandwidth.
- ``ADT406``: a host read (``.item()``) or a copy between the host and
  the card on the hot path — each one stalls the step on the host.
- ``ADT407``: collectives that depend on the rank. JAX flags collectives
  under ``stablehlo.if``/``case`` branches; an eager record holds no
  branch, only the path one rank took, so the port records the program
  at each rank index of the mesh (a fake collective moves nothing, so no
  rank waits) and flags a collective sequence that differs between
  ranks: those ranks would block in different collectives.
- ``ADT408``: a host read or copy inside a microstep of the fused
  program (``Runner.lowered_text(..., fuse_steps=k)``): it repeats every
  microstep, and on the card it fails the CUDA-graph capture
  (``kernel/superstep.py``) — found here before any capture.
- ``ADT409``: the overlap schedule is armed (``overlap_armed=True``) but
  every gradient collective is issued after the backward's last compute
  op: nothing hides behind the backward pass.

Text-based, as the JAX module is: it works on any saved dump.
"""
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from autodist_tpu_torch.analysis.diagnostics import (Diagnostic,
                                                     sort_diagnostics,
                                                     warning)
from autodist_tpu_torch.analysis.program import (Program, collective_schedule,
                                                 parse_program_text)

# backward ops that do compute a collective could hide behind
_COMPUTE_OPS = frozenset({
    "mm", "bmm", "addmm", "baddbmm", "matmul", "convolution_backward",
    "convolution", "_scaled_dot_product_flash_attention_backward",
    "_scaled_dot_product_efficient_attention_backward",
    "flash_bwd_dq", "flash_bwd_dkdv", "embedding_dense_backward",
    "native_layer_norm_backward", "tanh_backward", "gelu_backward",
    "threshold_backward", "_softmax_backward_data",
    "_log_softmax_backward_data", "native_batch_norm_backward",
})


def _gathered_shapes(st) -> List[Tuple[int, ...]]:
    """The shapes an all-gather statement produces: each output, and its
    parts joined on dim 0 (``all_gather`` into a list of shards)."""
    shapes = list(st.out_shapes)
    if len(shapes) > 1 and len(set(shapes)) == 1 and shapes[0]:
        s = shapes[0]
        shapes.append((s[0] * len(shapes),) + tuple(s[1:]))
    return shapes


def lint_lowered_text(text_or_program,
                      mp_full_shapes: Optional[Dict[str, Sequence[int]]] = None,
                      overlap_armed: bool = False) -> List[Diagnostic]:
    """Scan a recorded program for the communication hazards ADT405,
    ADT406, ADT408 and ADT409 (ADT407 compares the programs of several
    ranks: :func:`compare_ranks`).

    ``mp_full_shapes`` maps model-parallel variable names to their FULL
    shapes; an all-gather producing one of them is ADT405 (without it the
    check is skipped). ``overlap_armed`` says the plan built the
    overlapped gradient sync (``DistributedStep.metadata["overlap"]``)."""
    program = (text_or_program if isinstance(text_or_program, Program)
               else parse_program_text(text_or_program))
    out: List[Diagnostic] = []
    if program.entry is None:
        return out
    full = {tuple(int(d) for d in shape): name
            for name, shape in (mp_full_shapes or {}).items()}
    seen_gather, seen_host = set(), set()
    for st in program.entry.statements:
        coll = st.collective
        if coll is not None and coll.kind == "gather" and full:
            for shape in _gathered_shapes(st):
                name = full.get(tuple(shape))
                if name is not None and name not in seen_gather:
                    seen_gather.add(name)
                    out.append(warning(
                        "ADT405",
                        "all-gather materializes the full value of "
                        "model-parallel variable (shape %s, line %d) — "
                        "its compute should consume the local shard"
                        % (list(shape), st.lineno), var=name,
                        fixit="check the model's mp_rules cover every "
                              "consumer of this variable"))
        if not st.host:
            continue
        what = "%s (%s)" % (st.short_op, "host read" if st.host == "read"
                            else "host copy")
        if st.loop_depth > 0:
            key = ("ADT408", st.op)
            if key not in seen_host:
                seen_host.add(key)
                out.append(warning(
                    "ADT408",
                    "host transfer inside microstep %d of the fused "
                    "program (%s, line %d) — it repeats every microstep, "
                    "and on the card it fails the superstep's CUDA-graph "
                    "capture" % (st.microstep, what, st.lineno),
                    fixit="keep the step device-resident: no .item(), "
                          "no .cpu(); in the fused engine pull PS values "
                          "once per superstep (the fused carry), never "
                          "per microstep"))
        else:
            key = ("ADT406", st.op)
            if key not in seen_host:
                seen_host.add(key)
                out.append(warning(
                    "ADT406",
                    "host transfer on the hot path (%s, line %d) — each "
                    "one stalls the step on the host" % (what, st.lineno),
                    fixit="keep the step device-resident; host-PS pulls "
                          "belong in the store, not the step"))
    if overlap_armed:
        out.extend(_overlap_diagnostics(program))
    return sort_diagnostics(out)


def _overlap_diagnostics(program: Program) -> List[Diagnostic]:
    """ADT409: no gradient collective is issued before the backward's
    last compute op."""
    stmts = program.entry.statements
    bwd = [i for i, st in enumerate(stmts)
           if st.backward and st.collective is None
           and st.short_op in _COMPUTE_OPS]
    if not bwd:
        return []
    grads = [i for i, st in enumerate(stmts)
             if st.collective is not None and i > bwd[0]]
    if grads and min(grads) < bwd[-1]:
        return []
    return [warning(
        "ADT409",
        "overlap schedule armed but every gradient collective is issued "
        "after the backward's last compute op (line %d) — the bucketed "
        "sync degenerated to one stage, so nothing hides behind the "
        "backward pass" % stmts[bwd[-1]].lineno,
        fixit="split the gradient sync into >= 2 stages: shrink "
              "chunk_size (more, smaller buckets) or drop overlap and keep "
              "the plain epilogue")]


def compare_ranks(programs: Mapping[int, object]) -> List[Diagnostic]:
    """ADT407: the programs of the ranks of one mesh (``{rank: text or
    Program}``) must issue the same collective sequence — cost class,
    payload and group size, in order — or the ranks block in different
    collectives. One finding names the first rank that differs from the
    lowest."""
    if len(programs) < 2:
        return []
    ranks = sorted(programs)
    scheds = {r: [(c.kind, c.payload_bytes, c.group_size)
                  for c in collective_schedule(programs[r])] for r in ranks}
    ref = scheds[ranks[0]]
    for r in ranks[1:]:
        other = scheds[r]
        if other == ref:
            continue
        at = next((i for i, (a, b) in enumerate(zip(ref, other)) if a != b),
                  min(len(ref), len(other)))
        return [warning(
            "ADT407",
            "collectives depend on the rank: rank %d issues %d "
            "collective(s), rank %d issues %d, first differing at #%d "
            "(%s vs %s) — the ranks block in different collectives and "
            "deadlock" % (
                ranks[0], len(ref), r, len(other), at,
                "%s:%dB" % ref[at][:2] if at < len(ref) else "none",
                "%s:%dB" % other[at][:2] if at < len(other) else "none"),
            fixit="issue every collective on every rank: hoist it out of "
                  "the rank-dependent branch")]
    return []


def mp_full_shapes_of(distributed_step) -> Dict[str, Tuple[int, ...]]:
    """Full shapes of the model-parallel variables of a built
    ``DistributedStep`` — the ``mp_full_shapes`` input of
    :func:`lint_lowered_text`."""
    infos = distributed_step.model_item.var_infos
    return {name: tuple(infos[name].shape)
            for name in distributed_step.mp_layouts if name in infos}


def lint_runner(runner, batch, state=None,
                fuse_steps: int = 1) -> List[Diagnostic]:
    """Record the runner's step for ``batch`` and lint it: ADT405/406/
    408/409 on this rank's program, ADT407 across the programs of every
    rank of the job, and the ADT60x numerics pass
    (``analysis/numerics.py``) on the same text. The single
    implementation behind ``Runner.lint_lowered``. ``fuse_steps=k > 1``
    lints the fused k-microstep program, where a host transfer in a
    microstep is ADT408."""
    from autodist_tpu_torch.analysis import numerics
    dstep = runner.distributed_step
    text = runner.lowered_text(batch, state, fuse_steps=fuse_steps)
    out = lint_lowered_text(
        text, mp_full_shapes_of(dstep),
        overlap_armed=bool(dstep.metadata.get("overlap", False)))
    out.extend(numerics.lint_text(text))
    if dstep.num_replicas > 1:
        programs = {dstep.rank: text}
        for r in range(dstep.num_replicas):
            if r not in programs:
                programs[r] = runner.lowered_text(batch, state,
                                                  fuse_steps=fuse_steps,
                                                  rank=r)
        out.extend(compare_ranks(programs))
    return sort_diagnostics(out)
