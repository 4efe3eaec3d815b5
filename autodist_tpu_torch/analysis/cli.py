"""Plan linter CLI: ``python -m autodist_tpu_torch.analysis <example> --strategy <name>``
(the port of ``autodist_tpu/analysis/cli.py``: the same examples at the
same sizes, the same builders, flags, output and exit codes).

Builds (or loads) a Strategy for one of the bundled examples, runs the
static verifier against the example's ModelItem (its one fake-tensor
trace: no data, no device) and a resource spec, and prints the
diagnostic table. Exit codes: 0 = no errors (warnings/info allowed),
1 = at least one ``ADT`` error, 2 = usage/build failure.

    python -m autodist_tpu_torch.analysis linear_regression --strategy PS
    python -m autodist_tpu_torch.analysis lm1b --strategy Parallax --format json
    python -m autodist_tpu_torch.analysis tp_lm --strategy TensorParallel
    python -m autodist_tpu_torch.analysis lm1b --strategy-json plan.json

``--hbm-budget <GiB>`` adds the plan-level memory gate (ADT501 projected
OOM / ADT502 budget pressure) with no compile — ``--fuse-steps k``
prices the fused engine's device-resident PS carry on top:

    python -m autodist_tpu_torch.analysis lm1b --strategy PS --hbm-budget 16

``--numerics`` adds the plan-level numerics-safety gate (ADT601/602
errors plus the sentinel-aware ADT603/604 warnings) — and
``--compute-dtype bf16`` overrides the built plan's compute tier:

    python -m autodist_tpu_torch.analysis lm1b --strategy AllReduce --numerics --compute-dtype bf16

``--programs`` lints saved program dumps instead (``Runner.lowered_text``
written to a file: the step recorded as a program, ``kernel/lowering.py``)
— memory, donation, communication and numerics per program, and the
cross-program schedule checks (ADT510/511/605) against the FIRST file;
dumps of one program at several ranks are compared for ADT407:

    python -m autodist_tpu_torch.analysis --programs train.txt eval.txt --format json
"""
import argparse
import json
import sys
from typing import Callable, Dict, Optional, Tuple

# (loss_fn, params, example_batch, mp_rules-or-None) factories. Tiny
# configurations of the same models the JAX CLI lints, at its sizes — the
# lint needs shapes and sparsity, not realistic capacity.
ExampleSetup = Tuple[Callable, object, object, Optional[list]]


def _ex_linear_regression() -> ExampleSetup:
    import torch
    from autodist_tpu_torch.convert import jax_named

    params = jax_named({"W": torch.zeros(()), "b": torch.zeros(())})

    def loss_fn(p, batch):
        pred = batch["x"] * p["W"] + p["b"]
        return torch.mean((pred - batch["y"]) ** 2)

    batch = {"x": torch.zeros((64,), dtype=torch.float32),
             "y": torch.zeros((64,), dtype=torch.float32)}
    return loss_fn, params, batch, None


def _ex_sentiment_classifier() -> ExampleSetup:
    import torch
    import torch.nn.functional as F
    from autodist_tpu_torch.convert import jax_named

    gen = torch.Generator().manual_seed(0)
    params = jax_named({
        "embedding": torch.randn((512, 16), generator=gen) * 0.05,
        "dense/kernel": torch.randn((16, 1), generator=gen) * 0.1,
        "dense/bias": torch.zeros((1,)),
    })

    def loss_fn(p, batch):
        emb = F.embedding(batch["tokens"], p["embedding"])  # gather
        pooled = torch.mean(emb, dim=1)
        logits = (pooled @ p["dense/kernel"] + p["dense/bias"])[..., 0]
        labels = batch["label"].to(torch.float32)
        return torch.mean(torch.clamp(logits, min=0) - logits * labels
                          + torch.log1p(torch.exp(-torch.abs(logits))))

    batch = {"tokens": torch.zeros((8, 16), dtype=torch.int32),
             "label": torch.zeros((8,), dtype=torch.int32)}
    return loss_fn, params, batch, None


def _ex_image_classifier() -> ExampleSetup:
    from autodist_tpu_torch.models import resnet
    loss_fn, params, batch, _ = resnet.make_train_setup(
        resnet.ResNetTiny, num_classes=10, image_size=32, batch_size=8)
    return loss_fn, params, batch, None


def _ex_lm1b() -> ExampleSetup:
    from autodist_tpu_torch.models import lm
    cfg = lm.LMConfig(vocab_size=256, d_model=32, num_layers=2,
                      num_heads=4, mlp_dim=64, max_seq_len=32)
    loss_fn, params, batch, _ = lm.make_train_setup(cfg, seq_len=16,
                                                    batch_size=4)
    return loss_fn, params, batch, None


def _ex_tp_lm() -> ExampleSetup:
    from autodist_tpu_torch.models import tp_lm
    cfg = tp_lm.TPLMConfig(vocab_size=256, d_model=32, num_layers=2,
                           num_heads=4, mlp_dim=64, max_seq_len=32)
    loss_fn, params, batch, _ = tp_lm.make_train_setup(cfg, seq_len=16,
                                                       batch_size=4)
    return loss_fn, params, batch, tp_lm.tp_rules()


def _ex_pipe_lm() -> ExampleSetup:
    from autodist_tpu_torch.models import pipe_lm, tp_lm
    cfg = tp_lm.TPLMConfig(vocab_size=256, d_model=32, num_layers=2,
                           num_heads=4, mlp_dim=64, max_seq_len=32)
    loss_fn, params, batch, _ = pipe_lm.make_train_setup(
        cfg, seq_len=16, batch_size=4, n_microbatches=2)
    return loss_fn, params, batch, pipe_lm.pp_rules()


def _ex_moe_lm() -> ExampleSetup:
    from autodist_tpu_torch.models import moe_lm
    cfg = moe_lm.MoEConfig(vocab_size=256, d_model=32, num_layers=2,
                           num_heads=4, expert_dim=64, max_seq_len=32,
                           num_experts=2)
    loss_fn, params, batch, _ = moe_lm.make_train_setup(cfg, seq_len=16,
                                                        batch_size=4)
    return loss_fn, params, batch, moe_lm.ep_rules()


EXAMPLES: Dict[str, Callable[[], ExampleSetup]] = {
    "linear_regression": _ex_linear_regression,
    "sentiment_classifier": _ex_sentiment_classifier,
    "image_classifier": _ex_image_classifier,
    "lm1b": _ex_lm1b,
    "tp_lm": _ex_tp_lm,
    "pipe_lm": _ex_pipe_lm,
    "moe_lm": _ex_moe_lm,
}


def _builders(mp_rules):
    """Strategy-name -> builder factory. Model-parallel builders need the
    example's mp_rules and are only offered when the example has them."""
    from autodist_tpu_torch import strategy as S
    out = {
        "PS": lambda: S.PS(),
        "PSLoadBalancing": lambda: S.PSLoadBalancing(),
        "PartitionedPS": lambda: S.PartitionedPS(),
        "UnevenPartitionedPS": lambda: S.UnevenPartitionedPS(),
        "AllReduce": lambda: S.AllReduce(),
        "AllReduceInt8Wire": lambda: S.AllReduce(wire_dtype="int8"),
        "PSInt8Wire": lambda: S.PS(wire_dtype="int8"),
        "PartitionedAR": lambda: S.PartitionedAR(),
        "ZeroSharded": lambda: S.ZeroSharded(),
        "ZeroShardedInt8Wire": lambda: S.ZeroSharded(wire_dtype="int8"),
        "RandomAxisPartitionAR": lambda: S.RandomAxisPartitionAR(),
        "Parallax": lambda: S.Parallax(),
        "SequenceParallelAR": lambda: S.SequenceParallelAR(seq_shards=2),
        "WithRemat": lambda: S.WithRemat(S.AllReduce(), policy="dots"),
        "AutoStrategy": lambda: S.AutoStrategy(),
    }
    if mp_rules:
        out["TensorParallel"] = lambda: S.TensorParallel(
            tp_shards=2, mp_rules=mp_rules)
        out["PipelineParallel"] = lambda: S.PipelineParallel(
            pp_shards=2, mp_rules=mp_rules, n_microbatches=2)
        out["ExpertParallel"] = lambda: S.ExpertParallel(
            ep_shards=2, mp_rules=mp_rules)
    return out


def default_spec(num_devices: int = 4):
    """Synthetic single node of ``num_devices`` cards — the lint-time
    stand-in (verification is static; no device is touched)."""
    from autodist_tpu_torch.resource_spec import ResourceSpec
    return ResourceSpec.from_dict(
        {"nodes": [{"address": "127.0.0.1", "chief": True,
                    "gpus": num_devices}]})


def topology_spec(topology):
    """Synthesize the multi-node dryrun spec a topology describes — one
    node per host, ``chips_per_host`` cards each — with the topology
    attached, so a 64-card plan lints (ADT52x, per-level pricing) with
    zero hardware."""
    from autodist_tpu_torch.resource_spec import ResourceSpec
    nodes = [{"address": "10.0.0.%d" % (h + 1), "chief": h == 0,
              "gpus": topology.chips_per_host}
             for h in range(topology.hosts)]
    return ResourceSpec.from_dict({"nodes": nodes}).set_topology(topology)


def _load_topology(args):
    """Resolve ``--topology``: ``(topology, error_diagnostic)`` — a
    malformed file becomes an ADT524 finding, never a traceback."""
    if not args.topology:
        return None, None
    from autodist_tpu_torch.analysis.topology import (
        TopologyConfigError, diagnostic_for_config_error)
    from autodist_tpu_torch.resource_spec import Topology
    try:
        return Topology.from_yaml(args.topology), None
    except TopologyConfigError as e:
        return None, diagnostic_for_config_error(e)


def _report(args, label, diags, spec, memory: Optional[dict] = None) -> int:
    """Print the diagnostics (table or JSON); returns the error count."""
    from autodist_tpu_torch.analysis.diagnostics import (
        Severity, format_table, sort_diagnostics)
    n_errors = sum(1 for d in diags if d.severity >= Severity.ERROR)
    if args.format == "json":
        doc = {
            "example": args.example, "strategy": label,
            "errors": n_errors,
            "diagnostics": [d.to_dict() for d in sort_diagnostics(diags)],
        }
        if memory is not None:
            doc["memory"] = {k: v for k, v in memory.items()
                             if k != "diagnostics"}
        print(json.dumps(doc, indent=1, sort_keys=True))
    elif diags or not args.quiet:
        print("%s x %s on %d devices:"
              % (args.example, label, len(spec.devices)))
        if memory is not None:
            print("memory: peak %.3f GiB of %.3f GiB budget (%.0f%%%s)"
                  % (memory["peak_hbm_gib"], memory["budget_gib"],
                     100.0 * (memory["utilization"] or 0.0),
                     ", fuse_steps=%d" % memory["fuse_steps"]
                     if memory.get("fuse_steps", 1) > 1 else ""))
        print(format_table(diags))
    return n_errors


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m autodist_tpu_torch.analysis",
        description="Static pre-compile strategy verifier (plan linter). "
                    "Exit 0 = clean, 1 = ADT errors, 2 = usage/build "
                    "failure.")
    p.add_argument("example", nargs="?",
                   help="bundled example: %s" % ", ".join(sorted(EXAMPLES)))
    p.add_argument("--strategy", default="AllReduce",
                   help="strategy builder name (see --list)")
    p.add_argument("--strategy-json", default=None, metavar="FILE",
                   help="lint a serialized Strategy JSON file instead of "
                        "building one")
    p.add_argument("--spec", default=None, metavar="YAML",
                   help="resource spec yaml (default: synthetic 4-card "
                        "single node)")
    p.add_argument("--topology", default=None, metavar="YAML",
                   help="multi-level topology yaml (hosts x chips with "
                        "per-level link bandwidth): arms the ADT52x "
                        "topology-aware communication lints and, without "
                        "--spec, synthesizes a matching hosts x "
                        "chips_per_host dryrun spec — how a plan for many "
                        "hosts lints with zero hardware. A malformed "
                        "file is reported as ADT524 (exit 1)")
    p.add_argument("--devices", type=int, default=4,
                   help="device count of the synthetic spec (default 4)")
    p.add_argument("--format", choices=("table", "json"), default="table",
                   help="output format; json emits one machine-readable "
                        "document (code/severity/var/message/fixit per "
                        "finding) for scripts and external tooling")
    p.add_argument("--json", action="store_true",
                   help="alias for --format json")
    p.add_argument("--hbm-budget", type=float, default=None, metavar="GIB",
                   help="per-device HBM budget in GiB: run the plan-level "
                        "memory gate (ADT501 projected OOM, ADT502 budget "
                        "pressure) with no compile attempt")
    p.add_argument("--fuse-steps", type=int, default=1, metavar="K",
                   help="price the fused multi-step engine's device-"
                        "resident PS carry into the memory gate (and the "
                        "donation check in --programs mode)")
    p.add_argument("--programs", nargs="+", metavar="FILE", default=None,
                   help="lint saved program dumps (Runner.lowered_text) "
                        "instead of building a plan: per-program memory + "
                        "communication + numerics findings, plus cross-"
                        "program collective-schedule checks (ADT510/511/"
                        "605) against the FIRST file")
    p.add_argument("--numerics", action="store_true",
                   help="add the plan-level numerics-safety gate "
                        "(rules.verify_numerics): ADT601/602 errors plus "
                        "the ADT603 loss-tier and ADT604 sentinel-less "
                        "half-precision warnings")
    p.add_argument("--compute-dtype", choices=("f32", "bf16"), default=None,
                   help="override the built strategy's compute tier "
                        "before linting (lint the bf16 shape of any "
                        "builder without a dedicated builder flag)")
    p.add_argument("--quiet", action="store_true",
                   help="print nothing on a clean plan")
    p.add_argument("--list", action="store_true",
                   help="list examples and strategies, then exit")
    return p


def _programs_mode(args) -> int:
    """Lint recorded program dumps: memory/donation/communication/
    numerics per program, cross-program schedule consistency vs the first
    (reference) program, ADT407 across dumps of one program at several
    ranks, and — with ``--topology`` — the per-link-level ADT52x pass
    over every program's collective schedule. Exit 1 on any ADT error."""
    import dataclasses as _dc

    from autodist_tpu_torch.analysis import memory as memory_lib
    from autodist_tpu_torch.analysis import numerics as numerics_lib
    from autodist_tpu_torch.analysis import program as program_lib
    from autodist_tpu_torch.analysis.diagnostics import (Severity,
                                                         format_table,
                                                         sort_diagnostics)
    from autodist_tpu_torch.analysis.lowered import (compare_ranks,
                                                     lint_lowered_text)
    budget = (args.hbm_budget * memory_lib.GIB
              if args.hbm_budget is not None else None)
    topology, topo_diag = _load_topology(args)
    if topo_diag is not None:
        print(format_table([topo_diag]))
        return 1

    def _attribute(diags, path):
        # every finding names its file
        return [d if d.var else _dc.replace(d, var=path) for d in diags]

    per_program = []
    by_program: Dict[tuple, Dict[int, object]] = {}
    for path in args.programs:
        try:
            with open(path) as f:
                text = f.read()
        except OSError as e:
            print("error: cannot read %s: %s" % (path, e), file=sys.stderr)
            return 2
        label = path
        prog = program_lib.parse_program_text(text)
        est = memory_lib.estimate_from_text(prog)
        sched = program_lib.collective_schedule(prog)
        diags = list(lint_lowered_text(prog))
        diags += numerics_lib.lint_text(prog, label=label)
        diags += memory_lib.donation_diagnostics(
            prog, fuse_steps=args.fuse_steps)
        if budget is not None:
            diags += memory_lib.budget_diagnostics(
                est.peak_hbm_bytes, budget, source="lowered-program")
        if topology is not None:
            from autodist_tpu_torch.analysis.topology import lint_schedule
            diags += lint_schedule(sched, topology, label=label)
        per_program.append((label, est, sched, _attribute(diags, path)))
        if prog.entry is not None:
            key = (prog.entry.name, prog.fuse_steps)
            by_program.setdefault(key, {})[int(prog.attrs.get("rank", 0))] \
                = prog
    ref_label, _, ref_sched, _ = per_program[0]
    cross = []
    for label, _, sched, _ in per_program[1:]:
        batch = program_lib.compare_schedules(ref_sched, sched,
                                              ref_label, label)
        batch += numerics_lib.compare_schedule_dtypes(ref_sched, sched,
                                                      ref_label, label)
        cross += _attribute(batch, label)
    for ranks in by_program.values():
        cross += compare_ranks(ranks)
    all_diags = [d for (_, _, _, ds) in per_program for d in ds] + cross
    n_errors = sum(1 for d in all_diags if d.severity >= Severity.ERROR)
    if args.format == "json":
        print(json.dumps({
            "programs": [{
                "program": label,
                "memory": est.to_dict(),
                "collectives": len(sched),
                "diagnostics": [d.to_dict()
                                for d in sort_diagnostics(diags)],
            } for label, est, sched, diags in per_program],
            "schedule_check": {
                "reference": ref_label,
                "diagnostics": [d.to_dict()
                                for d in sort_diagnostics(cross)],
            },
            "errors": n_errors,
        }, indent=1, sort_keys=True))
    elif all_diags or not args.quiet:
        for label, est, sched, diags in per_program:
            print("%s: peak %.4f GiB, %d collective(s)"
                  % (label, est.peak_hbm_bytes / memory_lib.GIB,
                     len(sched)))
        print(format_table(all_diags))
    return 1 if n_errors else 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.json:
        args.format = "json"
    if args.list:
        print("examples:   " + " ".join(sorted(EXAMPLES)))
        print("strategies: " + " ".join(sorted(_builders([""]))))
        return 0
    if args.programs:
        return _programs_mode(args)
    if not args.example:
        print("error: an example name is required (see --list)",
              file=sys.stderr)
        return 2
    if args.example not in EXAMPLES:
        print("error: unknown example %r (have %s)"
              % (args.example, ", ".join(sorted(EXAMPLES))), file=sys.stderr)
        return 2

    from autodist_tpu_torch.analysis.rules import verify
    from autodist_tpu_torch.model_item import ModelItem
    from autodist_tpu_torch.resource_spec import ResourceSpec
    from autodist_tpu_torch.strategy.base import Strategy

    try:
        loss_fn, params, batch, mp_rules = EXAMPLES[args.example]()
        item = ModelItem(loss_fn=loss_fn, params=params,
                         example_batch=batch).prepare()
    except Exception as e:  # noqa: BLE001 — build failures are exit 2
        print("error: example %r failed to build: %s: %s"
              % (args.example, type(e).__name__, e), file=sys.stderr)
        return 2

    topology, topo_diag = _load_topology(args)
    if topo_diag is not None:
        _report(args, args.strategy, [topo_diag], default_spec(1))
        return 1
    if args.spec:
        spec = ResourceSpec(args.spec)
        if topology is not None:
            spec.set_topology(topology)
    elif topology is not None:
        spec = topology_spec(topology)
    else:
        spec = default_spec(args.devices)

    if args.strategy_json:
        from autodist_tpu_torch.analysis.diagnostics import DiagnosticError
        try:
            strategy = Strategy.deserialize(path=args.strategy_json)
        except DiagnosticError as e:
            # a defect the DESERIALIZER itself detects (e.g. ADT301
            # unknown synchronizer kind) is still an ADT finding, not a
            # tooling failure — report it through the normal output path
            _report(args, args.strategy_json, [e.diagnostic], spec)
            return 1
        except Exception as e:  # noqa: BLE001
            print("error: cannot load strategy from %s: %s"
                  % (args.strategy_json, e), file=sys.stderr)
            return 2
        label = args.strategy_json
    else:
        builders = _builders(mp_rules)
        if args.strategy not in builders:
            print("error: unknown strategy %r for example %r (have %s)"
                  % (args.strategy, args.example,
                     ", ".join(sorted(builders))), file=sys.stderr)
            return 2
        try:
            strategy = builders[args.strategy]().build(item, spec)
        except Exception as e:  # noqa: BLE001
            print("error: builder %s failed: %s: %s"
                  % (args.strategy, type(e).__name__, e), file=sys.stderr)
            return 2
        label = args.strategy

    if args.compute_dtype is not None:
        # GraphConfig is a mutable plan object; overriding the tier here
        # lints exactly the strategy the builder would emit with
        # compute_dtype=..., no per-builder CLI flag needed
        strategy.graph_config.compute_dtype = args.compute_dtype
        label += "[%s]" % args.compute_dtype

    diags = list(verify(strategy, item, spec))
    if args.numerics:
        from autodist_tpu_torch.analysis.rules import verify_numerics
        seen = {(d.code, d.message) for d in diags}
        diags += [d for d in verify_numerics(strategy, item, spec)
                  if (d.code, d.message) not in seen]
    memory = None
    if args.hbm_budget is not None:
        from autodist_tpu_torch.analysis import memory as memory_lib
        memory = memory_lib.plan_memory_report(
            strategy, item, spec,
            budget_bytes=args.hbm_budget * memory_lib.GIB,
            fuse_steps=args.fuse_steps)
        diags += memory["diagnostics"]
    return 1 if _report(args, label, diags, spec, memory) else 0
