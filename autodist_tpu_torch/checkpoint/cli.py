"""Checkpoint lifecycle CLI — ``python -m autodist_tpu_torch.checkpoint``.

The counterpart of ``python -m autodist_tpu.checkpoint`` (that module
imports nothing of JAX; the port keeps its own copy), with the same
output: both classify a directory the same way. Three subcommands over a
checkpoint directory (both formats — the plain ``Saver``'s and the JAX
package's ``ShardedSaver``'s — are handled together):

- ``ls``    — every checkpoint step with its format, validity state
  (``committed`` / ``torn`` / ``corrupt``), file count and total bytes.
- ``fsck``  — FULL integrity verification: every recorded crc32 is
  re-computed from the bytes on disk (``integrity.scan(deep=True)``).
  Exit 1 when any committed checkpoint is corrupt (or, with
  ``--strict``, when torn save attempts are present); exit 0 on a clean
  directory.
- ``gc``    — prune: ``--keep N`` keeps the newest N committed
  checkpoints per format; ``--orphans`` removes failed-attempt debris
  (torn attempts, ``.tmp`` leftovers) — only run it when no save is in
  flight, it drops the newest-step safety guard the savers' automatic
  GC keeps; ``--damaged`` removes checkpoints fsck classifies corrupt
  (the fsck-found-damage → gc workflow — restore already refuses them,
  this stops every future resume from re-skipping the wreck).
  ``--dry-run`` prints what would go.

Exit codes: 0 ok, 1 damage found (fsck), 2 usage error.
"""
import argparse
import json
import os
import sys
from typing import List, Optional

from autodist_tpu_torch import const
from autodist_tpu_torch.checkpoint import integrity


def _human_bytes(n: int) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if n < 1024 or unit == "TiB":
            return ("%d %s" % (n, unit) if unit == "B"
                    else "%.1f %s" % (n, unit))
        n /= 1024.0
    return "%d B" % n


def _print_table(statuses: List[integrity.CheckpointStatus],
                 verbose: bool = True):
    if not statuses:
        print("(no checkpoints)")
        return
    print("%6s  %-8s %-10s %-7s %5s  %10s  %s"
          % ("STEP", "FORMAT", "STATE", "HEALTHY", "FILES", "BYTES",
             "PROBLEMS"))
    for s in statuses:
        problems = "-"
        if s.problems:
            problems = "; ".join(s.problems[:2 if verbose else 1])
            if len(s.problems) > 2:
                problems += " (+%d more)" % (len(s.problems) - 2)
        # the sentinel's stamp: yes / NO (saved under a bad verdict —
        # auto-resume skips it) / "?" for pre-stamp checkpoints
        # (healthy-unknown: resumable)
        healthy = {True: "yes", False: "NO"}.get(s.healthy, "?")
        print("%6d  %-8s %-10s %-7s %5d  %10s  %s"
              % (s.step, s.fmt, s.state, healthy, len(s.files),
                 _human_bytes(s.bytes), problems))


def _cmd_ls(args) -> int:
    statuses = integrity.scan(args.dir)
    if args.json:
        print(json.dumps([s.to_dict() for s in statuses], indent=2))
    else:
        _print_table(statuses)
    return 0


def _cmd_fsck(args) -> int:
    statuses = integrity.scan(args.dir, deep=True)
    if args.step is not None:
        statuses = [s for s in statuses if s.step == args.step]
        if not statuses:
            print("fsck: no checkpoint files for step %d in %s"
                  % (args.step, args.dir), file=sys.stderr)
            return 1
    if args.json:
        print(json.dumps([s.to_dict() for s in statuses], indent=2))
    else:
        _print_table(statuses)
    corrupt = [s for s in statuses if s.state == integrity.CORRUPT]
    torn = [s for s in statuses if s.state == integrity.TORN]
    if not args.json:
        print("fsck: %d checkpoint(s), %d committed, %d torn attempt(s), "
              "%d corrupt, %d stamped unhealthy"
              % (len(statuses),
                 sum(1 for s in statuses if s.committed),
                 len(torn), len(corrupt),
                 sum(1 for s in statuses if s.healthy is False)))
    if corrupt:
        return 1
    if torn and args.strict:
        return 1
    return 0


def _cmd_gc(args) -> int:
    if args.keep is None and not args.orphans and not args.damaged:
        print("gc: nothing to do — pass --keep N, --orphans and/or "
              "--damaged", file=sys.stderr)
        return 2
    removed: List[str] = []
    statuses = integrity.scan(args.dir)
    if args.keep is not None:
        if args.keep < 1:
            print("gc: --keep must be >= 1", file=sys.stderr)
            return 2
        for fmt in ("plain", "sharded"):
            committed = [s for s in statuses
                         if s.fmt == fmt and s.committed]
            for victim in committed[:-args.keep] if args.keep else []:
                removed.extend(victim.files)
    if args.orphans:
        victims, _ = integrity.gc_candidates(args.dir, "plain",
                                             force_orphans=True)
        removed.extend(victims)
        victims, _ = integrity.gc_candidates(args.dir, "sharded",
                                             force_orphans=True)
        removed.extend(victims)
    if args.damaged:
        # deep fsck pass so a crc-only mismatch is caught too — a step
        # restore would refuse must be removable without hand-rm
        for s in integrity.scan(args.dir, deep=True):
            if s.state == integrity.CORRUPT:
                removed.extend(s.files)
    removed = sorted(set(removed))
    for f in removed:
        print("%s %s" % ("would remove" if args.dry_run else "removed", f))
        if not args.dry_run:
            try:
                os.remove(os.path.join(args.dir, f))
            except FileNotFoundError:
                pass
    if not removed:
        print("gc: nothing to remove")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m autodist_tpu_torch.checkpoint",
        description="Inspect, verify and prune autodist_tpu and "
                    "autodist_tpu_torch checkpoint directories (both plain "
                    "and sharded formats).")
    parser.add_argument("--dir", default=None,
                        help="checkpoint directory (default: ADT_CKPT_DIR)")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_ls = sub.add_parser("ls", help="list checkpoints with validity state")
    p_ls.add_argument("--json", action="store_true")
    p_ls.set_defaults(fn=_cmd_ls)
    p_fsck = sub.add_parser(
        "fsck", help="full checksum verification; exit 1 on damage")
    p_fsck.add_argument("--step", type=int, default=None,
                        help="verify only this step")
    p_fsck.add_argument("--strict", action="store_true",
                        help="also fail (exit 1) on torn save attempts")
    p_fsck.add_argument("--json", action="store_true")
    p_fsck.set_defaults(fn=_cmd_fsck)
    p_gc = sub.add_parser("gc", help="prune checkpoints / failed attempts")
    p_gc.add_argument("--keep", type=int, default=None,
                      help="keep only the newest N committed checkpoints "
                           "per format")
    p_gc.add_argument("--orphans", action="store_true",
                      help="remove ALL failed-attempt debris (torn "
                           "attempts, .tmp files) — only when no save is "
                           "in flight")
    p_gc.add_argument("--damaged", action="store_true",
                      help="remove checkpoints a deep fsck classifies "
                           "corrupt (restore skips them anyway)")
    p_gc.add_argument("--dry-run", action="store_true")
    p_gc.set_defaults(fn=_cmd_gc)
    for p in (p_ls, p_fsck, p_gc):
        # also after the subcommand (``fsck --dir D``)
        p.add_argument("--dir", default=argparse.SUPPRESS,
                       help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.dir is None:
        args.dir = const.ENV.ADT_CKPT_DIR.val
    if not os.path.isdir(args.dir):
        print("checkpoint directory %s does not exist" % args.dir,
              file=sys.stderr)
        return 2
    return args.fn(args)


if __name__ == "__main__":  # pragma: no cover - exercised via __main__.py
    sys.exit(main())
