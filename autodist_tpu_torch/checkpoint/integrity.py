"""Checkpoint integrity: classification of every on-disk checkpoint.

Counterpart of ``autodist_tpu/checkpoint/integrity.py``, which imports
nothing of JAX; the port keeps its own copy, so the two packages classify
a checkpoint directory the same way (the ``ls``/``fsck`` JSON of both
CLIs is the same on the same directory).

The saver's durability contract is built from two mechanisms this module
verifies:

- **Atomic visibility**: every final file (npz, index, meta) is written to
  a ``.tmp`` sibling and ``os.replace``'d into place; the meta file lands
  last, so a checkpoint is *committed* exactly when its meta exists. A
  crash at any instant leaves either a committed checkpoint or an
  invisible (meta-less) attempt — never a half-visible one.
- **Content checksums**: the plain saver records a crc32 + byte count per
  data file in its meta (the JAX package's sharded saver records one per
  npz entry in its index files), so post-commit damage — bit rot, a torn
  write on a non-atomic filesystem, a truncated copy — is *detectable*,
  not silently loaded into a training run.

``validate_plain`` / ``validate_sharded`` classify one step; ``scan``
classifies a whole directory. Classification states:

- ``committed`` — meta present, every referenced file present and
  structurally sound (and, with ``deep=True``, every recorded checksum
  verified against the bytes on disk).
- ``torn``      — no meta: a save attempt that never committed (crash
  mid-save). Expected debris after a crash; restore skips it silently and
  GC prunes it.
- ``corrupt``   — meta present but the checkpoint is damaged: a referenced
  file is missing/unreadable, an index↔npz nonce pairing is stale, a size
  or checksum mismatches. Restore must *never* load it; ``fsck`` exits 1.

Fast (``deep=False``) validation is what ``restore()``/``latest()`` run
per candidate: file existence, zip central-directory readability, nonce
pairing, and recorded-size checks — no array data is read. ``deep=True``
(the ``fsck`` CLI) additionally streams every entry and verifies the
recorded crc32s. The sharded format is classified too, so the CLI reports
a directory the JAX package's ``ShardedSaver`` wrote; no saver of the port
writes it yet.
"""
import json
import os
import re
import zipfile
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

COMMITTED = "committed"
TORN = "torn"
CORRUPT = "corrupt"

# every file either saver may leave behind, including crash debris (.tmp)
SHARDED_FILE_RE = re.compile(
    r"^ckpt-(\d+)\.shard-(?:p\d+\.(?:npz|index\.json)|meta\.json)"
    r"(\.tmp)?$")
PLAIN_FILE_RE = re.compile(
    r"^ckpt-(\d+)\.(?:(?:params|opt|sync)\.npz|meta\.json)(\.tmp)?$")

_FORMAT_RES = {"plain": PLAIN_FILE_RE, "sharded": SHARDED_FILE_RE}


class CheckpointDamaged(ValueError):
    """A checkpoint's bytes on disk do not match what was committed —
    raised by read paths when damage surfaces mid-restore (zip CRC /
    recorded-checksum mismatch, vanished file). Restore's fallback loop
    catches exactly this class: configuration errors (wrong strategy,
    missing mesh axis) stay loud."""


class CheckpointStatus:
    """Classification of one checkpoint step in one format."""

    __slots__ = ("directory", "step", "fmt", "state", "problems", "files",
                 "damaged", "bytes", "healthy")

    def __init__(self, directory: str, step: int, fmt: str):
        self.directory = directory
        self.step = step
        self.fmt = fmt
        self.state = COMMITTED
        self.problems: List[str] = []
        self.files: List[str] = []
        self.damaged: List[str] = []
        self.bytes = 0
        # the sentinel's health stamp from the meta: True (saved while
        # the run was judged healthy), False (saved despite a bad
        # verdict — auto-resume and rollback must never load it), or
        # None for pre-stamp checkpoints (healthy-UNKNOWN: resumable,
        # logged — an old checkpoint is not rejected for predating the
        # feature)
        self.healthy: Optional[bool] = None

    @property
    def committed(self) -> bool:
        return self.state == COMMITTED

    @property
    def base(self) -> str:
        return os.path.join(self.directory, "ckpt-%d" % self.step)

    def _flag(self, state: str, problem: str, damaged_file: Optional[str] = None):
        # corrupt dominates torn dominates committed
        if state == CORRUPT or self.state == COMMITTED:
            self.state = state
        self.problems.append(problem)
        if damaged_file is not None and damaged_file not in self.damaged:
            self.damaged.append(damaged_file)

    def to_dict(self) -> dict:
        return {"step": self.step, "format": self.fmt, "state": self.state,
                "files": list(self.files), "bytes": self.bytes,
                "problems": list(self.problems),
                "damaged": list(self.damaged), "healthy": self.healthy}

    def __repr__(self):
        return ("CheckpointStatus(step=%d, fmt=%r, state=%r, problems=%r)"
                % (self.step, self.fmt, self.state, self.problems))


def parse_base(path: str) -> Tuple[str, int]:
    """``(directory, step)`` of a checkpoint base path ``.../ckpt-N`` —
    what an explicit ``restore(path=...)`` hands the validators, so the
    checkpoint is validated where it LIVES, not in the saver's own
    directory."""
    base = os.path.basename(path.rstrip("/"))
    m = re.match(r"^ckpt-(\d+)$", base)
    if m is None:
        raise ValueError(
            "not a checkpoint base path (expected .../ckpt-<step>): %r"
            % path)
    return os.path.dirname(path.rstrip("/")) or ".", int(m.group(1))


class Crc32Writer:
    """Non-seekable write-through file proxy recording a crc32 + byte
    count of everything written — a saver records the content digest of
    what it streams with no second read pass. Deliberately NOT seekable:
    ``zipfile`` then writes in data-descriptor mode, never seeking back
    to patch headers, so the digest matches the final bytes on disk."""

    def __init__(self, f):
        self._f = f
        self.crc = 0
        self.nbytes = 0

    def write(self, data):
        self.crc = zlib.crc32(data, self.crc) & 0xFFFFFFFF
        self.nbytes += len(data)
        return self._f.write(data)

    def read(self, *_):  # np.savez file-object probe is hasattr("read")
        raise OSError("Crc32Writer is write-only")

    def readable(self) -> bool:
        return False

    def flush(self):
        self._f.flush()

    def tell(self) -> int:
        return self.nbytes

    def seekable(self) -> bool:
        return False

    def writable(self) -> bool:
        return True

    @property
    def digest(self) -> Dict[str, int]:
        return {"crc32": self.crc, "bytes": self.nbytes}


def file_digest(path: str, chunk: int = 1 << 20) -> Dict[str, int]:
    """Streaming ``{"crc32": ..., "bytes": ...}`` of a file — what the
    plain Saver records per data file in its meta."""
    crc, n = 0, 0
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            crc = zlib.crc32(block, crc)
            n += len(block)
    return {"crc32": crc & 0xFFFFFFFF, "bytes": n}


def _group_files(directory: str, fmt: str) -> Dict[int, List[str]]:
    """step -> file basenames belonging to ``fmt`` in ``directory``."""
    pattern = _FORMAT_RES[fmt]
    out: Dict[int, List[str]] = {}
    try:
        names = os.listdir(directory)
    except OSError:
        return out
    for f in names:
        m = pattern.match(f)
        if m:
            out.setdefault(int(m.group(1)), []).append(f)
    return out


def _sum_bytes(directory: str, files: List[str]) -> int:
    total = 0
    for f in files:
        try:
            total += os.path.getsize(os.path.join(directory, f))
        except OSError:
            pass
    return total


# ------------------------------------------------------------------ sharded


def _read_npz_nonce(zf: zipfile.ZipFile) -> Optional[str]:
    try:
        with zf.open("__nonce__.npy") as f:
            return bytes(np.lib.format.read_array(f)).decode()
    except (KeyError, OSError, ValueError, zipfile.BadZipFile):
        return None


def validate_sharded(directory: str, step: int, deep: bool = False,
                     files: Optional[List[str]] = None) -> CheckpointStatus:
    """Classify one sharded checkpoint step (see module docstring)."""
    status = CheckpointStatus(directory, step, "sharded")
    if files is None:
        files = _group_files(directory, "sharded").get(step, [])
    status.files = sorted(files)
    status.bytes = _sum_bytes(directory, files)
    meta_name = "ckpt-%d.shard-meta.json" % step
    if meta_name not in files:
        status._flag(TORN, "no %s — save attempt never committed"
                     % meta_name)
        return status
    try:
        with open(os.path.join(directory, meta_name)) as f:
            meta = json.load(f)
        key_owner = meta["keys"]
    except (OSError, json.JSONDecodeError, KeyError) as e:
        status._flag(CORRUPT, "meta unreadable: %s" % e, meta_name)
        return status
    if "healthy" in meta:
        status.healthy = bool(meta["healthy"])

    by_pid: Dict[int, List[str]] = {}
    for key, pid in key_owner.items():
        by_pid.setdefault(int(pid), []).append(key)
    for pid in sorted(by_pid):
        idx_name = "ckpt-%d.shard-p%d.index.json" % (step, pid)
        npz_name = "ckpt-%d.shard-p%d.npz" % (step, pid)
        try:
            with open(os.path.join(directory, idx_name)) as f:
                idx = json.load(f)
        except FileNotFoundError:
            status._flag(CORRUPT, "%s missing" % idx_name, idx_name)
            continue
        except (OSError, json.JSONDecodeError) as e:
            status._flag(CORRUPT, "%s unreadable: %s" % (idx_name, e),
                         idx_name)
            continue
        try:
            zf = zipfile.ZipFile(os.path.join(directory, npz_name))
        except FileNotFoundError:
            status._flag(CORRUPT, "%s missing" % npz_name, npz_name)
            continue
        except (OSError, zipfile.BadZipFile) as e:
            status._flag(CORRUPT, "%s unreadable (torn write?): %s"
                         % (npz_name, e), npz_name)
            continue
        with zf:
            _validate_shard_pair(status, zf, idx, by_pid[pid],
                                 idx_name, npz_name, deep)
    return status


def _validate_shard_pair(status: CheckpointStatus, zf: zipfile.ZipFile,
                         idx: dict, meta_keys: List[str], idx_name: str,
                         npz_name: str, deep: bool):
    npz_nonce = _read_npz_nonce(zf)
    if idx.get("nonce") != npz_nonce:
        status._flag(CORRUPT, "%s nonce does not match %s — stale "
                     "index/npz pairing from overlapping attempts"
                     % (idx_name, npz_name), npz_name)
        return
    names = set(zf.namelist())
    idx_keys = set(idx.get("keys", ()))
    for key in meta_keys:
        if key not in idx_keys:
            status._flag(CORRUPT, "meta key %r not in %s" % (key, idx_name),
                         idx_name)
    for key in idx_keys:
        if key + ".npy" not in names:
            status._flag(CORRUPT, "key %r listed in %s but absent from %s"
                         % (key, idx_name, npz_name), npz_name)
    checksums = idx.get("checksums") or {}
    for key, (crc, nbytes) in checksums.items():
        member = key + ".npy"
        if member not in names:
            continue  # already flagged above (or the nonce entry)
        info = zf.getinfo(member)
        if info.file_size != int(nbytes):
            status._flag(CORRUPT, "%s entry %r is %d bytes, index "
                         "recorded %d" % (npz_name, key, info.file_size,
                                          int(nbytes)), npz_name)
            continue
        if deep:
            try:
                with zf.open(member) as f:
                    got = zlib.crc32(f.read()) & 0xFFFFFFFF
            except (OSError, zipfile.BadZipFile) as e:
                status._flag(CORRUPT, "%s entry %r unreadable: %s"
                             % (npz_name, key, e), npz_name)
                continue
            if got != (int(crc) & 0xFFFFFFFF):
                status._flag(CORRUPT, "%s entry %r crc32 mismatch "
                             "(bit rot?)" % (npz_name, key), npz_name)


# -------------------------------------------------------------------- plain


def validate_plain(directory: str, step: int, deep: bool = False,
                   files: Optional[List[str]] = None) -> CheckpointStatus:
    """Classify one plain (Saver-format) checkpoint step."""
    status = CheckpointStatus(directory, step, "plain")
    if files is None:
        files = _group_files(directory, "plain").get(step, [])
    status.files = sorted(files)
    status.bytes = _sum_bytes(directory, files)
    meta_name = "ckpt-%d.meta.json" % step
    if meta_name not in files:
        status._flag(TORN, "no %s — save attempt never committed"
                     % meta_name)
        return status
    try:
        with open(os.path.join(directory, meta_name)) as f:
            meta = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        status._flag(CORRUPT, "meta unreadable: %s" % e, meta_name)
        return status
    if "healthy" in meta:
        status.healthy = bool(meta["healthy"])
    file_meta = meta.get("files")
    if file_meta is None:
        # legacy (pre-checksum) checkpoint: verify the standard files are
        # structurally readable; content checks are impossible — but the
        # params file at least must EXIST or restore fails at read time
        file_meta = {f: None for f in files
                     if f.endswith(".npz") and not f.endswith(".tmp")}
        params_name = "ckpt-%d.params.npz" % step
        if params_name not in file_meta:
            status._flag(CORRUPT, "%s missing (legacy checkpoint with no "
                         "recorded file list)" % params_name, params_name)
    for fname, digest in sorted(file_meta.items()):
        path = os.path.join(directory, fname)
        if not os.path.exists(path):
            status._flag(CORRUPT, "%s listed in meta but missing" % fname,
                         fname)
            continue
        if digest is not None and os.path.getsize(path) != digest["bytes"]:
            status._flag(CORRUPT, "%s is %d bytes, meta recorded %d"
                         % (fname, os.path.getsize(path), digest["bytes"]),
                         fname)
            continue
        if fname.endswith(".npz"):
            try:
                with zipfile.ZipFile(path) as zf:
                    if deep and zf.testzip() is not None:
                        status._flag(CORRUPT, "%s has a bad zip entry"
                                     % fname, fname)
            except (OSError, zipfile.BadZipFile) as e:
                status._flag(CORRUPT, "%s unreadable (torn write?): %s"
                             % (fname, e), fname)
                continue
        if deep and digest is not None:
            if file_digest(path)["crc32"] != (digest["crc32"] & 0xFFFFFFFF):
                status._flag(CORRUPT, "%s crc32 mismatch (bit rot?)"
                             % fname, fname)
    return status


# --------------------------------------------------------------- directory


_VALIDATORS = {"plain": validate_plain, "sharded": validate_sharded}


def scan(directory: str, fmt: Optional[str] = None, deep: bool = False
         ) -> List[CheckpointStatus]:
    """Classify every checkpoint in ``directory`` (both formats unless
    ``fmt`` narrows it); sorted by (step, format), oldest first."""
    out: List[CheckpointStatus] = []
    for f in (fmt,) if fmt else ("plain", "sharded"):
        for step, files in sorted(_group_files(directory, f).items()):
            out.append(_VALIDATORS[f](directory, step, deep=deep,
                                      files=files))
    return sorted(out, key=lambda s: (s.step, s.fmt))


def committed_newest_first(directory: str, fmt: str):
    """Lazily yield ``fmt``'s checkpoints newest step first — the restore
    fallback order. Fast validation runs per step AS CONSUMED, so
    ``latest()``/``restore()`` stopping at the first committed step pay
    one step's validation I/O, not the whole directory's (which matters
    on a networked checkpoint dir at startup). Callers decide what to do
    with the non-committed entries (skip + count, or just skip)."""
    groups = _group_files(directory, fmt)
    for step in sorted(groups, reverse=True):
        yield _VALIDATORS[fmt](directory, step, files=groups[step])


def gc_candidates(directory: str, fmt: str,
                  force_orphans: bool = False
                  ) -> Tuple[List[str], List[CheckpointStatus]]:
    """Failed-attempt debris safe to delete: files (basenames) of torn
    attempts at steps strictly below the newest committed step, plus
    ``.tmp`` leftovers below it. ``force_orphans`` (CLI ``gc --orphans``,
    caller asserts no save is in flight) drops the newest-step guard so
    debris at or above the newest commit goes too. Returns (filenames,
    statuses scanned)."""
    statuses = scan(directory, fmt=fmt)
    committed = [s.step for s in statuses if s.committed]
    newest = max(committed) if committed else None
    victims: List[str] = []
    for s in statuses:
        # never touch a committed step's final files; a torn attempt is
        # debris once a newer commit exists (resume starts past it)
        removable_step = (force_orphans or
                          (newest is not None and s.step < newest))
        if not removable_step:
            continue
        if s.state == TORN:
            victims.extend(s.files)
        else:
            victims.extend(f for f in s.files if f.endswith(".tmp"))
    return sorted(set(victims)), statuses
