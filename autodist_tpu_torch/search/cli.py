"""Auto-strategy search CLI: ``python -m autodist_tpu_torch.search <example>``
(the port of ``autodist_tpu/search/cli.py``: the same flags, output and
exit codes).

Runs the per-variable plan search against one of the bundled examples
(the same registry the plan-linter CLI uses), compares the searched plan
against the zoo ranking under the identical cost model, and prints the
search summary — candidates visited, prune reasons, score trajectory
endpoint, candidates/second. Exit codes: 0 = searched a plan (and it
verifies clean), 1 = the search produced no plan or the chosen plan has
ADT errors, 2 = usage/build failure.

    python -m autodist_tpu_torch.search image_classifier
    python -m autodist_tpu_torch.search lm1b --algo anneal --budget 200 --seed 7
    python -m autodist_tpu_torch.search lm1b --trace-out search-trace.json \\
        --dump-plan searched-plan.json --format json

``--trace-out`` dumps the deterministic search trace (candidates visited
with mutation operators and parents, prune reasons, scores) — re-running
with the seed/config in its header reproduces the identical run.
``--dump-plan`` serializes the chosen Strategy as JSON, ready for
``python -m autodist_tpu_torch.analysis <example> --strategy-json <file>``.
The zoo comparison is ``search/scoring.py::zoo_best`` under the same
simulator.
"""
import argparse
import json
import sys

# the example-model registry and synthetic spec are shared with the
# plan-linter CLI — one place defines what "bundled example" means
from autodist_tpu_torch.analysis.cli import EXAMPLES, default_spec


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m autodist_tpu_torch.search",
        description="Per-variable auto-strategy search over the "
                    "calibrated cost model (no compile). Exit 0 = plan "
                    "found and clean, 1 = no plan / ADT errors, 2 = "
                    "usage failure.")
    p.add_argument("example", nargs="?",
                   help="bundled example: %s" % ", ".join(sorted(EXAMPLES)))
    p.add_argument("--algo", choices=("beam", "anneal", "both"),
                   default="beam", help="search driver (default beam)")
    p.add_argument("--budget", type=int, default=128,
                   help="max scored candidates, seeds included "
                        "(default 128)")
    p.add_argument("--beam-width", type=int, default=4)
    p.add_argument("--branch", type=int, default=6,
                   help="mutations per beam member per round (default 6)")
    p.add_argument("--seed", type=int, default=0,
                   help="rng seed; fixed seed => identical plan and trace")
    p.add_argument("--devices", type=int, default=4,
                   help="device count of the synthetic spec (default 4)")
    p.add_argument("--spec", default=None, metavar="YAML",
                   help="resource spec yaml (default: synthetic "
                        "single node)")
    p.add_argument("--format", choices=("table", "json"), default="table")
    p.add_argument("--trace-out", default=None, metavar="FILE",
                   help="dump the deterministic search trace as JSON")
    p.add_argument("--dump-plan", default=None, metavar="FILE",
                   help="serialize the chosen Strategy as JSON (feed to "
                        "the plan linter's --strategy-json)")
    p.add_argument("--no-zoo", action="store_true",
                   help="skip the zoo comparison (faster; no "
                        "searched-vs-zoo line)")
    p.add_argument("--quiet", action="store_true",
                   help="table mode: print only the chosen-plan line")
    p.add_argument("--list", action="store_true",
                   help="list examples, then exit")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.list:
        print("examples: " + " ".join(sorted(EXAMPLES)))
        return 0
    if not args.example:
        print("error: an example name is required (see --list)",
              file=sys.stderr)
        return 2
    if args.example not in EXAMPLES:
        print("error: unknown example %r (have %s)"
              % (args.example, ", ".join(sorted(EXAMPLES))),
              file=sys.stderr)
        return 2

    from autodist_tpu_torch.analysis.diagnostics import Severity
    from autodist_tpu_torch.model_item import ModelItem
    from autodist_tpu_torch.resource_spec import ResourceSpec
    from autodist_tpu_torch.search.drivers import SearchConfig, run_search
    from autodist_tpu_torch.simulator.simulator import Simulator

    try:
        loss_fn, params, batch, _mp_rules = EXAMPLES[args.example]()
        item = ModelItem(loss_fn=loss_fn, params=params,
                         example_batch=batch).prepare()
    except Exception as e:  # noqa: BLE001 — build failures are exit 2
        print("error: example %r failed to build: %s: %s"
              % (args.example, type(e).__name__, e), file=sys.stderr)
        return 2

    spec = (ResourceSpec(args.spec) if args.spec
            else default_spec(args.devices))
    try:
        cfg = SearchConfig(algo=args.algo, budget=args.budget,
                           beam_width=args.beam_width, branch=args.branch,
                           seed=args.seed)
    except ValueError as e:
        print("error: %s" % e, file=sys.stderr)
        return 2
    sim = Simulator(item, spec)
    result = run_search(item, spec, config=cfg, simulator=sim,
                        trace_path=args.trace_out)

    doc = {
        "example": args.example,
        "config": cfg.to_dict(),
        "candidates": result.candidates,
        "pruned": result.pruned,
        "prune_reasons": result.trace.prune_reasons(),
        "search_s": round(result.wall_s, 3),
        "candidates_per_s": round(
            result.candidates / max(result.wall_s, 1e-9), 1),
    }
    if not result.ok:
        doc["chosen"] = None
        if args.format == "json":
            print(json.dumps(doc, indent=1, sort_keys=True))
        else:
            print("%s: search pruned every candidate (%s)"
                  % (args.example, doc["prune_reasons"]))
        return 1

    doc["chosen"] = result.trace.result.get("plan")
    doc["est_step_ms"] = round(result.record.step_time_s * 1e3, 6)
    doc["score_ms"] = round(result.record.score_s * 1e3, 6)
    if not args.no_zoo:
        from autodist_tpu_torch.search.scoring import zoo_best
        zoo_label, zoo_score, _zoo = zoo_best(item, spec, sim)
        if zoo_label is not None:
            doc["zoo_best"] = zoo_label
            doc["zoo_score_ms"] = round(zoo_score * 1e3, 6)
            doc["beats_zoo"] = bool(result.record.score_s
                                    <= zoo_score + 1e-12)
    if args.dump_plan:
        result.strategy.serialize(args.dump_plan)
        doc["plan_file"] = args.dump_plan
    if args.trace_out:
        doc["trace_file"] = args.trace_out

    n_errors = sum(1 for d in sim.verify(result.strategy)
                   if d.severity >= Severity.ERROR)
    doc["verify_errors"] = n_errors

    if args.format == "json":
        print(json.dumps(doc, indent=1, sort_keys=True))
    else:
        print("%s: %s  est %.3f ms/step  (%d candidates, %d pruned, "
              "%.2fs, %.0f cand/s, seed %d, %s)"
              % (args.example, doc["chosen"], doc["est_step_ms"],
                 result.candidates, result.pruned, result.wall_s,
                 doc["candidates_per_s"], args.seed, args.algo))
        if not args.quiet:
            if "zoo_best" in doc:
                verdict = ("<= zoo best" if doc["beats_zoo"]
                           else "SLOWER than zoo best")
                print("zoo best: %s  score %.3f ms  -> searched %.3f ms "
                      "(%s)" % (doc["zoo_best"], doc["zoo_score_ms"],
                                doc["score_ms"], verdict))
            for reason, count in sorted(doc["prune_reasons"].items()):
                print("pruned %-16s %d" % (reason, count))
            if args.trace_out:
                print("trace: %s" % args.trace_out)
            if args.dump_plan:
                print("plan:  %s" % args.dump_plan)
    return 1 if n_errors else 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
