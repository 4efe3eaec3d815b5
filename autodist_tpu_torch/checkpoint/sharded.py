"""Sharded checkpoint save/restore: no process ever holds the full tree.

PyTorch counterpart of ``autodist_tpu/checkpoint/sharded.py``, writing
and reading the same files. The plain :class:`~autodist_tpu_torch.
checkpoint.saver.Saver` gathers every variable whole before it writes;
this saver has each rank write only what it holds:

- **save**: every process writes ONE npz with the slices it owns — a
  model-parallel variable's slice over the model axis, a partitioned
  variable's shard, its ZeRO rows of ``sync_state["zero"]``, its
  compressor and sentinel rows, and the host-PS shards it owns (all of
  them on the chief in mirror mode, the owned groups in async serving
  mode). A replicated leaf is written once, by the rank that holds its
  "replica 0" (coordinate 0 on every mesh axis the leaf is not split
  over), the JAX package's unique-writer rule. Peak host memory is this
  rank's slices, never the tree.
- **commit**: a per-process index file lands beside each shard file; the
  chief waits for all of them (a file barrier: the directory is shared
  between hosts), then writes the meta file. A checkpoint without its
  meta file is invisible.
- **restore**: each process reads back the slices it needs. With the
  save's topology (mesh axes and shape, process count) each is one saved
  slice; across topologies (tp 2 -> tp 1, N = 2 -> N = 1, the JAX
  package's 8-device mesh -> the port's N ranks) each needed slice is
  assembled from the overlapping saved slices. ZeRO rows re-lay for the
  new replica count; compressor state and the sentinel's scale start
  fresh (they are per-rank transients). Host-PS shards reload into the
  store, re-sliced when the store's shards differ.
- **export_full**: converts a sharded checkpoint into a plain-format one
  (original unpadded layout, ``numpy.load``-able), one leaf at a time.

The port has no ``jax.Array`` to ask which slice a rank holds, so the
saver derives each leaf's global shape, partition spec and this rank's
slice from the plan: ``DistributedStep.layouts`` (partitioned),
``mp_layouts`` (model-parallel, over ``parallel/mesh.py``'s coordinates),
the ZeRO synchronizers and the replica count. Names and coordinates are
the JAX pytree's: names through ``convert.jax_name`` (the
``convert.jax_named`` names of ``models/tp_lm.py`` as they are), values
in flax's layout (``convert.to_jax_layout``, so a 2-D attention
projection lands in its 3-D flax coordinates), partitioned shards in
padded global coordinates.

File layout for step N (all under ``directory``)::

    ckpt-N.shard-p<pid>.npz         this process's shards
    ckpt-N.shard-p<pid>.index.json  its key list (the barrier token)
    ckpt-N.shard-meta.json          chief-written commit point

npz keys: ``P|<var>|<a:b,c:d>`` (params), ``O|<leaf>|<...>`` (optimizer
state), ``S|<leaf>|<...>`` (sync state: compressor, ZeRO and sentinel
leaves with a leading rank axis), ``H|<var>::<si>`` (host-PS shard
value), ``Ho|<var>::<si>|<leaf>`` (host-PS shard optimizer leaf). Slice
tokens are in the PADDED global coordinates of the stored array; the
meta file records how to unpad. A job whose processes each run their own
replica (async PS) writes its device keys with the suffix ``@p<pid>``,
and each process restores its own.
"""
import json
import os
import re
import time
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from autodist_tpu_torch import const, convert
from autodist_tpu_torch.checkpoint import integrity
from autodist_tpu_torch.checkpoint.integrity import CheckpointDamaged
from autodist_tpu_torch.checkpoint.saver import (
    BackgroundWriter, _skip_unhealthy, _user_state_to_host, _writing,
    scan_checkpoint_metas, sentinel_health_stamp, sentinel_save_vetoed)
from autodist_tpu_torch.model_item import flatten_state, unflatten_state
from autodist_tpu_torch.runtime import elastic
from autodist_tpu_torch.runtime.faultinject import checkpoint_fault
from autodist_tpu_torch.telemetry import spans as tel
from autodist_tpu_torch.train_state import TrainState
from autodist_tpu_torch.utils import logging

_FORMAT = "autodist_tpu.sharded.v1"


# ----------------------------------------------------------------- tokens


def _index_token(ranges) -> str:
    """Stable string for a slice of the global array: ``lo:hi`` a dim,
    ``-`` for a scalar."""
    if not ranges:
        return "-"
    return ",".join("%d:%d" % (lo, hi) for lo, hi in ranges)


def _token_slices(token: str) -> Tuple[slice, ...]:
    if token == "-":
        return ()
    return tuple(slice(*map(int, p.split(":"))) for p in token.split(","))


def _group_keys(meta: dict) -> Dict[str, List[str]]:
    """meta['keys'] grouped by their first two ``|`` segments ('P|emb',
    'Ho|emb::0', ...), so restore and export find each leaf's keys
    directly."""
    out: Dict[str, List[str]] = {}
    for key in meta["keys"]:
        parts = key.split("|", 2)
        out.setdefault("|".join(parts[:2]), []).append(key)
    return out


class _StreamingNpzWriter:
    """npz writer that streams one array at a time (zipfile + np.save), so
    peak memory while saving is a single shard, not the whole file.
    ``checksums`` maps each written key to ``[crc32, nbytes]`` of its
    npy stream, recorded in the index file so fsck and the restore
    fallback can prove the bytes on disk are the bytes written."""

    def __init__(self, path: str):
        self._zf = zipfile.ZipFile(path, "w", zipfile.ZIP_STORED)
        self.checksums: Dict[str, list] = {}

    def write(self, key: str, arr: np.ndarray):
        with self._zf.open(key + ".npy", "w", force_zip64=True) as f:
            cf = integrity.Crc32Writer(f)
            np.save(cf, np.asarray(arr))
        self.checksums[key] = [cf.crc, cf.nbytes]

    def close(self):
        self._zf.close()


# ----------------------------------------------------------------- layouts


def _process_index() -> int:
    """This process's index in the job: its rank in the default group, or
    ``ADT_PROCESS_ID`` without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return const.ENV.ADT_PROCESS_ID.val


class _Topology:
    """The plan's mesh as the JAX package names it: axes and sizes (the
    data axis over every rank without a ``ProcessMesh``) and this rank's
    coordinate on each."""

    def __init__(self, dstep):
        mesh = dstep.mesh
        if mesh is not None:
            self.axes = list(mesh.axes)
            self.shape = [int(mesh.axes[a]) for a in self.axes]
            self.coords = dict(mesh.coords)
        else:
            self.axes = [const.DATA_AXIS]
            self.shape = [int(dstep.num_replicas)]
            self.coords = {const.DATA_AXIS: int(dstep.rank)}
        self.size = int(np.prod(self.shape))

    def axis_size(self, axis) -> int:
        return self.shape[self.axes.index(axis)]

    def sync_spec(self) -> list:
        """The spec of a leaf with a leading axis over every rank (the
        JAX ``P(all_axes)``)."""
        return [self.axes[0]] if len(self.axes) == 1 else [list(self.axes)]

    def ranges(self, shape, spec) -> List[Tuple[int, int]]:
        """This rank's slice of a global ``shape`` split by ``spec``."""
        out = []
        for d, dim in enumerate(shape):
            entry = spec[d] if d < len(spec) else None
            if entry is None:
                out.append((0, int(dim)))
                continue
            axes = entry if isinstance(entry, list) else [entry]
            n, idx = 1, 0
            for a in axes:
                idx = idx * self.axis_size(a) + self.coords[a]
                n *= self.axis_size(a)
            part = int(dim) // n
            out.append((idx * part, (idx + 1) * part))
        return out

    def writes(self, spec) -> bool:
        """The replica-0 rule: this rank holds the leaf's replica 0 when
        its coordinate is 0 on every axis the leaf is not split over."""
        used = set()
        for entry in spec:
            if entry is not None:
                used.update(entry if isinstance(entry, list) else [entry])
        return all(self.coords[a] == 0 for a in self.axes if a not in used)


def _var_layout(dstep, name: str):
    """(JAX name, global shape in the JAX layout, spec, unpad) of the
    port variable ``name`` under the running plan."""
    info = dstep.model_item.var_infos[name]
    fs = tuple(info.flax_shape or info.shape)
    lay = dstep.layouts.get(name)
    if lay is not None and lay.partitioned:
        shape = list(fs)
        shape[lay.axis] = lay.padded_dim
        unpad = ([lay.axis, lay.orig_dim] if lay.padded_dim != lay.orig_dim
                 else None)
        return (info.collective_name, tuple(shape),
                [None] * lay.axis + [const.DATA_AXIS], unpad)
    mlay = dstep.mp_layouts.get(name)
    if mlay is not None:
        spec = [None] * (max(d for d, _ in mlay.mp_axes) + 1)
        for d, a in mlay.mp_axes:
            spec[d] = a
        return info.collective_name, fs, spec, None
    return info.collective_name, fs, [], None


def _sharded_local(dstep, name: str) -> bool:
    """Whether the state holds ``name`` as a slice already in the JAX
    layout (partitioned shards and model-parallel slices) rather than
    the port's full tensor."""
    lay = dstep.layouts.get(name)
    return (lay is not None and lay.partitioned) or name in dstep.mp_layouts


def _slot_vars(dstep) -> List[str]:
    """The variables with a slot in the device optimizer tree: every
    device variable but the ZeRO ones (their slots are ZeRO rows)."""
    return [n for n in dstep.model_item.params
            if n not in dstep.ps_names and n not in dstep.zero_syncs]


def _sync_flat(dstep, sync: dict) -> Dict[str, np.ndarray]:
    """This rank's sync state as the JAX flattened leaves, each with a
    leading axis of 1 (its row)."""
    item = dstep.model_item
    return convert.sync_state_to_jax(
        pytree.tree_map(lambda t: t[None], sync), item.var_infos,
        item.flax_shapes, item.optimizer_spec)


class ShardedSaver:
    """Save/restore distributed state with one shard file a process.

    The same call contract as :class:`~autodist_tpu_torch.checkpoint.
    saver.Saver`: ``save()`` must run on EVERY process (each writes its
    own file), and so must ``restore()``. The ``directory`` must be
    shared across hosts.

    ``async_save=True`` copies this process's shards to the host before
    ``save()`` returns (the step updates its tensors in place) and moves
    the file writes and the chief's commit wait to a background thread.
    """

    def __init__(self, directory: Optional[str] = None, max_to_keep: int = 5,
                 async_save: bool = False, barrier_timeout: float = 300.0):
        self.directory = directory or const.DEFAULT_CHECKPOINT_DIR
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self.barrier_timeout = barrier_timeout
        self._writer = BackgroundWriter("adt-sharded-ckpt")
        os.makedirs(self.directory, exist_ok=True)

    # ------------------------------------------------------------------ save

    @staticmethod
    def _mesh_suffix(dstep) -> str:
        """Device-key namespace: empty for one program over every process
        (the replica-0 rule gives each slice one writer); ``@p<pid>`` when
        each process runs its own replica (async PS) with more than one
        process in the job, so each process's keys stay its own."""
        from autodist_tpu_torch.runtime.coordination import job_processes
        if dstep.num_replicas > 1 or job_processes() <= 1:
            return ""
        return "@p%d" % _process_index()

    @staticmethod
    def _process_count(dstep) -> int:
        from autodist_tpu_torch.runtime.coordination import job_processes
        return max(int(dstep.num_replicas), job_processes())

    def _device_entries(self, dstep, state, collect, leaves_meta,
                        suffix: str):
        """This rank's slices of every device leaf: the params, the
        optimizer state and the sync state."""
        topo = _Topology(dstep)
        item = dstep.model_item

        def add(kind, jname, shape, dtype, spec, unpad, data):
            leaves_meta["%s|%s" % (kind, jname)] = {
                "shape": list(shape), "dtype": dtype, "spec": spec,
                "unpad": unpad}
            if not topo.writes(spec):
                return
            key = "%s|%s|%s%s" % (kind, jname,
                                  _index_token(topo.ranges(shape, spec)),
                                  suffix)
            collect(key, data)

        if item.step_fn is not None:
            # the opaque state's own leaves (its moments included), under
            # its paths, replicated: the step owns its optimizer
            for n, arr in _user_state_to_host(state.params).items():
                add("P", n, arr.shape, str(arr.dtype), [], None,
                    lambda a=arr: a)
            return

        def var_data(name, t):
            if _sharded_local(dstep, name):
                return lambda: t.detach().to("cpu", copy=True).numpy()
            return lambda: convert.leaf_to_jax(t, name, item.flax_shapes)

        def dtype_of(t):
            return "float32" if t.is_floating_point() else \
                str(t.detach().cpu().numpy().dtype)

        for n in item.params:
            if n in dstep.ps_names:
                continue
            t = state.params[n]
            jname, shape, spec, unpad = _var_layout(dstep, n)
            add("P", jname, shape, dtype_of(t), spec, unpad, var_data(n, t))
        opt = state.opt_state
        spec_o = item.optimizer_spec
        if spec_o is not None and opt:
            pre = spec_o.jax_prefix
            if spec_o.has_count:
                c = opt["count"]
                add("O", pre + "count", (), "int32", [], None,
                    lambda c=c: np.asarray(int(c), np.int32))
            for slot in spec_o.slots:
                for n in _slot_vars(dstep):
                    t = opt[slot][n]
                    jname, shape, spec, unpad = _var_layout(dstep, n)
                    add("O", "%s%s/%s" % (pre, slot, jname), shape,
                        "float32", spec, unpad, var_data(n, t))
        rows = _sync_flat(dstep, state.sync_state or {})
        for jname in sorted(rows):
            row = rows[jname]
            shape = (topo.size,) + tuple(row.shape[1:])
            add("S", jname, shape, str(row.dtype), topo.sync_spec(), None,
                lambda r=row: r)

    def save(self, runner_or_step, state=None, step: Optional[int] = None
             ) -> Optional[str]:
        """Write this process's shard file; the chief commits the meta once
        every process's index file has landed. Returns the checkpoint base
        path (None when the sentinel's quarantine vetoes the save)."""
        if hasattr(runner_or_step, "distributed_step"):  # Runner
            dstep = runner_or_step.distributed_step
            state = state if state is not None else runner_or_step.state
        else:
            dstep = runner_or_step
        if state is None:
            raise ValueError("no state to save")
        # the epoch fence before any file: a zombie's late shard save
        # must leave the checkpoint directory untouched
        elastic.maybe_fence("ckpt.save")
        if sentinel_save_vetoed(runner_or_step):
            return None
        healthy = sentinel_health_stamp(runner_or_step)
        if step is None:
            step = int(state.step)
        base = os.path.join(self.directory, "ckpt-%d" % step)
        pid = _process_index()
        nproc = self._process_count(dstep)
        # a crash-resume can save the SAME step again: this attempt's
        # files must never mix with an earlier attempt's. Our own stale
        # index goes first, and index and npz pair by a nonce the commit
        # checks
        try:
            os.remove("%s.shard-p%d.index.json" % (base, pid))
        except FileNotFoundError:
            pass
        nonce = "%d-%d-%s" % (pid, os.getpid(), os.urandom(8).hex())

        # this process's entries. A sync save streams: each producer is
        # read one at a time inside write() (peak = one shard). An async
        # save copies up front: the next step updates the tensors
        entries: List[Any] = []
        leaves_meta: Dict[str, dict] = {}
        if self.async_save:
            def collect(key, data):
                entries.append((key, data()))
        else:
            def collect(key, data):
                entries.append((key, data))
        suffix = self._mesh_suffix(dstep)
        with tel.span("ckpt.collect", "ckpt", step=int(step),
                      mode="async" if self.async_save else "sync"):
            self._device_entries(dstep, state, collect, leaves_meta, suffix)
        checkpoint_fault("collect", step=int(step))

        ps_meta: Dict[str, dict] = {}
        store = dstep.ps_store
        infos = dstep.model_item.var_infos
        if store is not None:
            dstep.flush_ps()  # the in-flight push (and a fused carry) lands
            if store.serving:
                store.drain()
            for name, plan in sorted(store.plans.items()):
                ranges = plan.shard_ranges() if plan.partitioned else None
                ps_meta[infos[name].collective_name] = {
                    "axis": plan.axis, "nshards": len(ranges) if ranges
                    else 1,
                    # the split axis's sizes, so a restore under another
                    # shard layout re-slices without reading every shard
                    "shard_sizes": ([hi - lo for lo, hi in ranges]
                                    if ranges else None)}
            chief = (dstep.rank == 0 if dstep.num_replicas > 1
                     else const.is_chief())
            for name, si in store.checkpoint_pairs(chief):
                jname = infos[name].collective_name

                def ps_group(name=name, si=si, jname=jname):
                    value, opt_flat = store.shard_state(name, si)
                    out = [("H|%s::%d" % (jname, si), value)]
                    out.extend(("Ho|%s::%d|%s" % (jname, si, ln), arr)
                               for ln, arr in sorted(opt_flat.items()))
                    return out
                if self.async_save:
                    entries.extend(ps_group())
                else:
                    # one shard read at a time, each an atomic snapshot
                    # against the store's apply
                    entries.append(ps_group)

        topo = _Topology(dstep)
        meta = {
            "format": _FORMAT, "step": int(step),
            "strategy_id": dstep.strategy.id, "healthy": healthy,
            "mesh": {"axes": list(topo.axes), "shape": list(topo.shape)},
            "process_count": nproc,
            "leaves": leaves_meta,
            "ps": ps_meta,
        }

        def write(barrier=None):
            t_begin = time.monotonic()
            with tel.span("ckpt.write", "ckpt", step=int(step)):
                shard_path = "%s.shard-p%d.npz" % (base, pid)
                tmp = shard_path + ".tmp"
                w = _StreamingNpzWriter(tmp)
                w.write("__nonce__", np.frombuffer(nonce.encode(), np.uint8))
                written_keys: List[str] = []
                for item in entries:
                    if callable(item):  # a host-PS shard's group
                        for key, arr in item():
                            w.write(key, arr)
                            written_keys.append(key)
                    else:
                        key, arr = item
                        w.write(key, arr() if callable(arr) else arr)
                        written_keys.append(key)
                w.close()
                checkpoint_fault("write", path=tmp, step=int(step))
                os.replace(tmp, shard_path)
                checkpoint_fault("index", path=shard_path, step=int(step))
                index_path = "%s.shard-p%d.index.json" % (base, pid)
                tmp = index_path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump({"pid": pid, "nonce": nonce,
                               "keys": written_keys,
                               "checksums": w.checksums}, f)
                os.replace(tmp, index_path)
                entries.clear()  # the host copies are on disk
            # the BASE, so a damage rule at this phase can target any of
            # the step's files
            checkpoint_fault("meta", path=base, step=int(step))
            if barrier is not None:
                t_bar = time.monotonic()
                with tel.span("ckpt.barrier", "ckpt", step=int(step),
                              kind="device"):
                    barrier()
                tel.counter_add("ckpt.barrier_s", time.monotonic() - t_bar)
            if pid == 0:
                t_bar = time.monotonic()
                with tel.span("ckpt.barrier", "ckpt", step=int(step),
                              kind="index-files"):
                    key_owner = self._await_indexes(base, nproc)
                tel.counter_add("ckpt.barrier_s", time.monotonic() - t_bar)
                # fenced again at the commit point: an epoch can change
                # between the save's start and the meta (the shard debris
                # stays uncommitted)
                elastic.maybe_fence("ckpt.commit")
                meta["keys"] = key_owner
                tmp = base + ".shard-meta.json.tmp"
                with open(tmp, "w") as f:
                    json.dump(meta, f)
                os.replace(tmp, base + ".shard-meta.json")
                checkpoint_fault("committed", path=base, step=int(step))
                with tel.span("ckpt.gc", "ckpt"):
                    self._gc()
                tel.counter_add("ckpt.saves")
                tel.hist_observe("ckpt.save_ms",
                                 (time.monotonic() - t_begin) * 1e3)
                logging.info("sharded checkpoint %s committed (step %d, "
                             "%d keys over %d processes)", base, step,
                             len(key_owner), nproc)

        if not self.async_save:
            # a sync save of one program over every process: a real
            # barrier between the per-process writes and the chief's
            # commit, so the commit can never pair this attempt's chief
            # file with an earlier attempt's peer files (the nonce check
            # is the only guard for async saves and between-graph jobs)
            barrier = None
            if dstep.num_replicas > 1 and not suffix:
                barrier = dist.barrier
            with _writing():
                write(barrier)
            return base
        self._writer.submit(_writing()(write))
        return base

    def _await_indexes(self, base: str, nproc: int) -> Dict[str, int]:
        """File barrier: the chief's commit waits until every process's
        index file exists, parses, and its nonce matches the one in that
        process's npz (an index left by a crashed earlier attempt at the
        same step cannot pair with a fresh npz, or the reverse); returns
        the merged key -> pid map. The timeout names each laggard and
        why."""
        deadline = time.monotonic() + self.barrier_timeout
        key_owner: Dict[str, int] = {}
        pending = set(range(nproc))
        laggard: Dict[int, str] = {}  # pid -> why its commit is incomplete
        while pending:
            for q in sorted(pending):
                path = "%s.shard-p%d.index.json" % (base, q)
                npz_path = "%s.shard-p%d.npz" % (base, q)
                try:
                    with open(path) as f:
                        idx = json.load(f)
                except FileNotFoundError:
                    laggard[q] = "index file %s not written" % (
                        os.path.basename(path))
                    continue
                except json.JSONDecodeError as e:
                    laggard[q] = "index file %s unreadable (%s)" % (
                        os.path.basename(path), e)
                    continue
                try:
                    with np.load(npz_path) as zf:
                        npz_nonce = bytes(zf["__nonce__"]).decode()
                except FileNotFoundError:
                    laggard[q] = "shard file %s not written" % (
                        os.path.basename(npz_path))
                    continue
                except (KeyError, zipfile.BadZipFile, OSError) as e:
                    laggard[q] = "shard file %s unreadable (%s)" % (
                        os.path.basename(npz_path), e)
                    continue
                if idx.get("nonce") != npz_nonce:
                    laggard[q] = ("index %s does not pair with %s (nonce "
                                  "mismatch — stale file from a crashed "
                                  "earlier attempt at this step)"
                                  % (os.path.basename(path),
                                     os.path.basename(npz_path)))
                    continue
                for k in idx["keys"]:
                    prev = key_owner.setdefault(k, q)
                    if prev != q:
                        raise ValueError(
                            "sharded checkpoint key %r written by both "
                            "process %d and %d — the replica-0 writer rule "
                            "was violated (mismatched mesh layouts between "
                            "processes?)" % (k, prev, q))
                pending.discard(q)
                laggard.pop(q, None)
            if pending:
                if time.monotonic() > deadline:
                    detail = "; ".join(
                        "p%d: %s" % (q, laggard.get(q, "no index file"))
                        for q in sorted(pending))
                    raise TimeoutError(
                        "sharded checkpoint commit: %d of %d processes "
                        "never wrote a valid index under %s within %.0fs "
                        "[%s] — is the checkpoint directory shared across "
                        "hosts?" % (len(pending), nproc, self.directory,
                                    self.barrier_timeout, detail))
                time.sleep(0.05)
        return key_owner

    def wait(self):
        """Join a pending async write; re-raises any writer error."""
        self._writer.wait()

    # ------------------------------------------------------------- discovery

    _META_RE = re.compile(r"^ckpt-(\d+)\.shard-meta\.json$")

    def _own_metas(self):
        return scan_checkpoint_metas(self.directory, self._META_RE)

    def _gc(self):
        metas = self._own_metas()
        while len(metas) > self.max_to_keep:
            step, fname = metas.pop(0)
            base = "ckpt-%d" % step
            for f in os.listdir(self.directory):
                if f == fname or f.startswith(base + ".shard-p"):
                    try:
                        os.remove(os.path.join(self.directory, f))
                        tel.counter_add("ckpt.gc_removed")
                    except FileNotFoundError:
                        pass
        # failed-attempt debris: shard/index/tmp files of attempts that
        # never committed, below the newest commit
        victims, _ = integrity.gc_candidates(self.directory, "sharded")
        for f in victims:
            try:
                os.remove(os.path.join(self.directory, f))
                tel.counter_add("ckpt.gc_orphans")
            except FileNotFoundError:
                pass
        if victims:
            logging.info("sharded checkpoint gc: removed %d failed-attempt "
                         "files (%s)", len(victims), ", ".join(victims[:6]))

    def latest(self) -> Optional[str]:
        """Base path of the newest COMMITTED sharded checkpoint that is
        not stamped unhealthy; fast validation skips torn attempts and
        damaged steps, with a logged reason."""
        self.wait()
        for status in integrity.committed_newest_first(self.directory,
                                                       "sharded"):
            if status.committed:
                if _skip_unhealthy(status):
                    continue
                return status.base
            logging.warning("sharded checkpoint step %d is %s, skipping: "
                            "%s", status.step, status.state,
                            "; ".join(status.problems[:3]))
        return None

    # --------------------------------------------------------------- restore

    class _ShardReader:
        """Lazy per-process npz handles + key->pid routing. Damage that
        surfaces at read time — a vanished shard file, a zip CRC mismatch
        on an entry — raises :class:`CheckpointDamaged`, which the restore
        fallback catches to try the next-older checkpoint; a missing key
        (a strategy mismatch) stays loud."""

        def __init__(self, base: str, meta: dict):
            self._base = base
            self._keys = meta["keys"]
            self._files: Dict[int, Any] = {}

        def __contains__(self, key: str) -> bool:
            return key in self._keys

        def __call__(self, key: str) -> np.ndarray:
            pid = self._keys.get(key)
            if pid is None:
                raise KeyError("checkpoint is missing key %r" % key)
            path = "%s.shard-p%d.npz" % (self._base, pid)
            try:
                zf = self._files.get(pid)
                if zf is None:
                    zf = np.load(path)
                    self._files[pid] = zf
                return zf[key]
            except (zipfile.BadZipFile, OSError, ValueError) as e:
                tel.counter_add("ckpt.corrupt_shards")
                raise CheckpointDamaged(
                    "shard file %s is damaged (reading key %r: %s)"
                    % (os.path.basename(path), key, e)) from e

        def close(self):
            for zf in self._files.values():
                zf.close()

    def _read_meta(self, path: str) -> dict:
        try:
            with open(path + ".shard-meta.json") as f:
                meta = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise CheckpointDamaged("%s.shard-meta.json unreadable: %s"
                                    % (path, e)) from e
        if meta.get("format") != _FORMAT:
            raise ValueError("not a sharded checkpoint: %s" % path)
        return meta

    def _topology_matches(self, meta: dict, dstep) -> bool:
        topo = _Topology(dstep)
        have = meta["mesh"]
        return (have["axes"] == topo.axes and have["shape"] == topo.shape
                and meta["process_count"] == self._process_count(dstep))

    def _flex_precheck(self, meta: dict, dstep, suffix: str):
        """Raise when a cross-topology restore is impossible: it needs
        checkpoints of one program over every process at save AND restore
        (a between-graph job's ``@p`` keys are process-private views with
        no global slice identity) and every saved leaf's mesh axes on the
        running mesh."""
        if suffix or any("@" in k for k in meta["keys"]):
            raise ValueError(
                "cross-topology sharded restore requires global-mesh "
                "checkpoints on both sides; this one involves a "
                "between-graph (process-local mesh) program. Convert with "
                "ShardedSaver.export_full() and restore through Saver.")
        topo = _Topology(dstep)
        mesh_axes = set(topo.axes)
        for lkey, lm in meta["leaves"].items():
            if lkey.startswith("S|"):
                continue  # a rank-row leaf: re-laid or reset, not read
            for entry in lm["spec"]:
                for ax in (entry if isinstance(entry, list) else [entry]):
                    if ax is not None and ax not in mesh_axes:
                        raise ValueError(
                            "saved leaf %r is sharded over mesh axis %r, "
                            "absent from the running mesh %s — restore "
                            "under a strategy with the same axis names"
                            % (lkey, ax, sorted(mesh_axes)))
        logging.warning(
            "sharded restore across topologies: saved mesh %s=%s over %d "
            "processes -> running %s over %d processes; reassembling from "
            "global slice ranges", meta["mesh"]["axes"],
            meta["mesh"]["shape"], meta["process_count"],
            dict(zip(topo.axes, topo.shape)), self._process_count(dstep))

    def _read_slice(self, kind, name, lm, need, new_shape, reader, groups,
                    suffix) -> np.ndarray:
        """The slice ``need`` (ranges in the RUNNING padded coordinates of
        ``new_shape``) of one leaf: the saved slice of the same token when
        there is one, else assembled from the overlapping saved slices
        (clipped to the original extent: save-time padding is zeros, and
        so is the new padding)."""
        key = "%s|%s|%s%s" % (kind, name, _index_token(need), suffix)
        dtype = np.dtype(lm["dtype"])
        if key in reader and tuple(lm["shape"]) == tuple(new_shape):
            return np.asarray(reader(key), dtype=dtype)
        saved_shape = tuple(lm["shape"])
        unpad = lm.get("unpad")
        orig = list(saved_shape)
        if unpad:
            orig[int(unpad[0])] = int(unpad[1])
        pieces = []
        for k in groups.get("%s|%s" % (kind, name), []):
            token = k.split("|", 2)[2]
            if "@" in token:
                continue
            ranges = [(s.start, min(s.stop, od)) for s, od in
                      zip(_token_slices(token), orig)]
            pieces.append((k, ranges))
        if not pieces:
            raise KeyError("checkpoint has no slices of %s leaf %r"
                           % (kind, name))
        return self._assemble_flex_slice(need, new_shape, tuple(orig), dtype,
                                         pieces, reader)

    @staticmethod
    def _assemble_flex_slice(need, new_shape, orig_shape, dtype, pieces,
                             reader) -> np.ndarray:
        """One needed slice (ranges in NEW-padded coordinates) filled from
        the overlapping saved pieces (ranges in original coordinates)."""
        if not new_shape:  # scalar: the single '-' piece is the value
            return np.asarray(reader(pieces[0][0]), dtype=dtype)
        out = np.zeros([hi - lo for lo, hi in need], dtype)
        need_orig = [(lo, min(hi, od)) for (lo, hi), od in
                     zip(need, orig_shape)]
        if any(lo >= hi for lo, hi in need_orig):
            return out  # a slice of padding only
        for key, pranges in pieces:
            ov = [(max(nl, pl), min(nh, ph))
                  for (nl, nh), (pl, ph) in zip(need_orig, pranges)]
            if any(lo >= hi for lo, hi in ov):
                continue
            arr = np.asarray(reader(key))
            src = tuple(slice(lo - pl, hi - pl)
                        for (lo, hi), (pl, _) in zip(ov, pranges))
            dst = tuple(slice(lo - nl, hi - nl)
                        for (lo, hi), (nl, _) in zip(ov, need))
            out[dst] = arr[src]
        return out

    def restore(self, runner, path: Optional[str] = None) -> Tuple[Any, int]:
        """Restore a Runner's state reading only this process's slices;
        returns (state, step). The topology may differ from the save's
        (see the module docstring).

        **Last-good fallback**: with no explicit ``path``, checkpoints are
        tried newest first; torn attempts, damaged steps and steps stamped
        unhealthy are skipped with a logged reason (``ckpt.fallback`` /
        ``ckpt.corrupt_shards``), and the call fails only when NO valid
        checkpoint exists. An explicit ``path`` is validated where it
        lives and refused when torn or damaged; its unhealthy stamp is
        overridden, with a warning. Damage found while reading falls back
        only with one process: peers choosing different steps would
        diverge."""
        self.wait()
        if path is not None:
            status = integrity.validate_sharded(*integrity.parse_base(path))
            if not status.committed:
                tel.counter_add("ckpt.corrupt_shards", len(status.damaged))
                raise CheckpointDamaged(
                    "sharded checkpoint %s is %s: %s" % (
                        path, status.state, "; ".join(status.problems[:5])))
            if status.healthy is False:
                logging.warning("restoring %s despite its UNHEALTHY stamp "
                                "(explicit path overrides the quarantine)",
                                path)
            return self._restore_at(runner, path)
        tried = 0
        for status in integrity.committed_newest_first(self.directory,
                                                       "sharded"):
            if not status.committed:
                logging.warning(
                    "sharded restore: skipping step %d (%s): %s",
                    status.step, status.state,
                    "; ".join(status.problems[:3]))
                tel.counter_add("ckpt.fallback")
                tel.counter_add("ckpt.corrupt_shards", len(status.damaged))
                continue
            if _skip_unhealthy(status):
                tel.counter_add("ckpt.fallback")
                continue
            tried += 1
            try:
                return self._restore_at(runner, status.base)
            except CheckpointDamaged as e:
                if self._process_count(runner.distributed_step) > 1:
                    raise  # peers must all restore the SAME step
                logging.warning(
                    "sharded restore: step %d damaged mid-read (%s); "
                    "falling back to the previous checkpoint",
                    status.step, e)
                tel.counter_add("ckpt.fallback")
        raise FileNotFoundError(
            "no valid sharded checkpoint in %s (%d committed candidate(s) "
            "tried)" % (self.directory, tried))

    def _restore_at(self, runner, path: str) -> Tuple[Any, int]:
        """Restore from one checkpoint base, already validated."""
        dstep = runner.distributed_step
        item = dstep.model_item
        meta = self._read_meta(path)
        suffix = self._mesh_suffix(dstep)
        same = self._topology_matches(meta, dstep)
        if not same:
            self._flex_precheck(meta, dstep, suffix)
        if meta.get("strategy_id") != dstep.strategy.id:
            logging.warning(
                "sharded checkpoint %s was saved under strategy %s, "
                "restoring under %s — layouts must match or this will fail",
                path, meta.get("strategy_id"), dstep.strategy.id)
        reader = self._ShardReader(path, meta)
        groups = _group_keys(meta)
        topo = _Topology(dstep)
        device = dstep.device
        try:
            def leaf(kind, name, shape, spec):
                lm = meta["leaves"].get("%s|%s" % (kind, name))
                if lm is None:
                    raise KeyError(
                        "checkpoint has no %s leaf %r — was it saved under "
                        "a different strategy?" % (kind, name))
                return self._read_slice(kind, name, lm,
                                        topo.ranges(shape, spec), shape,
                                        reader, groups, suffix)

            if item.step_fn is not None:
                template = dict(flatten_state(item.params))
                placed = {}
                for n, v in template.items():
                    arr = leaf("P", n, tuple(np.shape(v)), [])
                    dtype = v.dtype if isinstance(v, torch.Tensor) else \
                        torch.as_tensor(np.asarray(v)).dtype
                    placed[n] = torch.as_tensor(arr).to(device, dtype)
                state = TrainState(step=int(meta["step"]),
                                   params=unflatten_state(item.params,
                                                          placed),
                                   opt_state={}, sync_state={})
            else:
                state = self._restore_tensors(dstep, meta, reader, groups,
                                              leaf, same, suffix)
        finally:
            reader.close()
        runner.state = state
        notify = getattr(runner, "notify_state_restored", None)
        if callable(notify):
            notify()  # re-sync the process-local LR scales
        tel.counter_add("ckpt.restores")
        logging.info("restored sharded checkpoint %s (step %d, local slices "
                     "only)", path, state.step)
        return state, state.step

    def _restore_tensors(self, dstep, meta, reader, groups, leaf, same,
                         suffix) -> TrainState:
        """The loss_fn-mode state: params, optimizer state and sync state
        of this rank, and the host-PS store's shards."""
        item = dstep.model_item
        device = dstep.device

        def place(name, arr):
            if _sharded_local(dstep, name) or not np.issubdtype(
                    arr.dtype, np.floating):
                return torch.from_numpy(np.array(arr)).to(device)
            return convert.leaf_from_jax(
                arr, name, item.var_infos[name].shape, device).contiguous()

        params = {}
        for n in item.params:
            if n in dstep.ps_names:
                continue
            jname, shape, spec, _ = _var_layout(dstep, n)
            params[n] = place(n, leaf("P", jname, shape, spec))
        opt_state = None
        spec_o = item.optimizer_spec
        if spec_o is not None:
            pre = spec_o.jax_prefix
            opt_state = {}
            if spec_o.has_count:
                opt_state["count"] = torch.tensor(
                    int(leaf("O", pre + "count", (), [])),
                    dtype=torch.int32, device=device)
            for slot in spec_o.slots:
                opt_state[slot] = {}
                for n in _slot_vars(dstep):
                    jname, shape, spec, _ = _var_layout(dstep, n)
                    opt_state[slot][n] = place(
                        n, leaf("O", "%s%s/%s" % (pre, slot, jname), shape,
                                spec)).to(torch.float32)
        sync = dstep._sync_state_init()
        if sync:
            self._restore_sync(dstep, sync, meta, reader, groups, same,
                               suffix)
        store = dstep.ps_store
        if store is not None:
            # a staged prefetch of pre-restore values must not survive
            dstep.invalidate_ps()
            store.load_shard_states(self._ps_provider(dstep, meta, reader,
                                                      groups, same))
        return TrainState(step=int(meta["step"]), params=params,
                          opt_state=opt_state, sync_state=sync)

    def _restore_sync(self, dstep, sync, meta, reader, groups, same,
                      suffix) -> None:
        """This rank's sync state written into the fresh ``sync`` tree:
        its saved row with the save's topology; across topologies the
        ZeRO rows re-laid for the running replica count (they are global
        flat slices of the variable: losing Adam's moments on a shrink is
        not a safe transient) and everything else — compressor residuals,
        the sentinel's scale — left at the fresh init (per-rank
        transients the JAX restore resets too)."""
        from autodist_tpu_torch.kernel.synchronization.zero_synchronizer \
            import relayout_zero_sync_leaf
        item = dstep.model_item
        topo = _Topology(dstep)
        rank = topo.ranges((topo.size,), topo.sync_spec())[0][0]
        template = _sync_flat(dstep, sync)
        by_jax = {i.collective_name: n for n, i in item.var_infos.items()}
        rows, relaid, reset = {}, [], []
        for jname, tmpl in sorted(template.items()):
            lm = meta["leaves"].get("S|%s" % jname)
            if same and lm is not None:
                need = [(rank, rank + 1)] + [(0, d) for d in tmpl.shape[1:]]
                shape = (topo.size,) + tuple(tmpl.shape[1:])
                rows[jname] = self._read_slice("S", jname, lm, need, shape,
                                               reader, groups, suffix)
                continue
            zero = jname.startswith("zero/")
            if not zero or lm is None:
                if lm is not None or not jname.startswith("sentinel/"):
                    reset.append(jname)
                continue
            saved = self._read_slice(
                "S", jname, lm, [(0, d) for d in lm["shape"]],
                tuple(lm["shape"]), reader, groups, "")
            var = max((j for j in by_jax if jname.startswith(
                "zero/%s/" % j)), key=len)
            laid = relayout_zero_sync_leaf(saved, int(saved.shape[0]),
                                           dstep.zero_syncs[by_jax[var]],
                                           topo.size)
            if laid is None:
                reset.append(jname)
                continue
            rows[jname] = laid[rank:rank + 1]
            relaid.append(jname)
        if relaid or reset:
            logging.warning(
                "sharded restore: %d ZeRO opt-state leaves re-laid onto %d "
                "replicas; %d per-rank leaves (compressor residuals, the "
                "sentinel's scale) reset to fresh init", len(relaid),
                topo.size, len(reset))
        if not rows:
            return
        got = convert.sync_state_from_jax(rows, item.var_infos,
                                          item.flax_shapes,
                                          item.optimizer_spec)

        def put(dst, src):
            for k, v in dst.items():
                if k not in src:
                    continue
                if isinstance(v, dict):
                    put(v, src[k])
                else:
                    v.copy_(src[k][0].to(v.dtype))
        put(sync, got)

    def _ps_provider(self, dstep, meta, reader, groups, same):
        """``provider(name, si) -> (value, opt_flat)`` for
        ``PSStore.load_shard_states``: each saved shard as it is when the
        running store shards the variable as the save did, else each new
        shard's range re-sliced from the saved shards along the split
        axis, reading only the overlapping ones."""
        infos = dstep.model_item.var_infos
        store = dstep.ps_store
        ps_meta = meta.get("ps", {})

        def gather_range(keys, lo, hi, axis, offs):
            parts = []
            for s, k in enumerate(keys):
                if hi >= 0:
                    slo, shi = offs[s], offs[s + 1]
                    olo, ohi = max(lo, slo), min(hi, shi)
                    if olo >= ohi:
                        continue
                    arr = np.asarray(reader(k))
                    idx = [slice(None)] * arr.ndim
                    idx[axis] = slice(olo - slo, ohi - slo)
                    parts.append(arr[tuple(idx)])
                else:
                    parts.append(np.asarray(reader(k)))
            if not parts:
                raise ValueError("PS shard range [%d,%d) matches no saved "
                                 "shard" % (lo, hi))
            return (parts[0] if len(parts) == 1
                    else np.concatenate(parts, axis=axis))

        def provider(name, si):
            jname = infos[name].collective_name
            pm = ps_meta.get(jname)
            if pm is None:
                raise KeyError("checkpoint has no host-PS var %r" % jname)
            plan = store.plans[name]
            axis, nsaved = int(pm["axis"]), int(pm["nshards"])
            if plan.partitioned and plan.axis != axis:
                raise ValueError(
                    "PS var %r: saved split axis %d != running split axis "
                    "%d" % (jname, axis, plan.axis))
            n_now = len(plan.shard_ranges()) if plan.partitioned else 1
            sizes = pm.get("shard_sizes")
            now = ([hi - lo for lo, hi in plan.shard_ranges()]
                   if plan.partitioned else None)
            if nsaved == n_now and (n_now == 1 or list(now) == list(
                    map(int, sizes or []))):
                value = np.asarray(reader("H|%s::%d" % (jname, si)))
                prefix = "Ho|%s::%d|" % (jname, si)
                return value, {k[len(prefix):]: np.asarray(reader(k))
                               for k in groups.get(prefix[:-1], [])}
            if not sizes:  # a single saved shard
                sizes = [int(np.asarray(
                    reader("H|%s::%d" % (jname, s))).shape[axis])
                    for s in range(nsaved)]
            offs = [0]
            for s in sizes:
                offs.append(offs[-1] + int(s))
            lo, hi = (plan.shard_ranges()[si] if plan.partitioned
                      else (0, -1))
            vkeys = ["H|%s::%d" % (jname, s) for s in range(nsaved)]
            value = gather_range(vkeys, lo, hi, axis, offs)
            # var-shaped optimizer leaves re-slice like the value; the
            # shard-invariant ones (the count) copy shard 0's
            shard0_shape = tuple(np.asarray(reader(vkeys[0])).shape)
            opt_flat: Dict[str, np.ndarray] = {}
            leaf_names = sorted({
                k.split("|", 2)[2]
                for s in range(nsaved)
                for k in groups.get("Ho|%s::%d" % (jname, s), [])})
            for ln in leaf_names:
                lkeys = ["Ho|%s::%d|%s" % (jname, s, ln)
                         for s in range(nsaved)]
                probe = np.asarray(reader(lkeys[0]))
                if tuple(probe.shape) == shard0_shape:
                    opt_flat[ln] = gather_range(lkeys, lo, hi, axis, offs)
                else:
                    opt_flat[ln] = probe
            return value, opt_flat
        return provider

    # ---------------------------------------------------------------- export

    def export_full(self, path: Optional[str] = None,
                    out_dir: Optional[str] = None) -> str:
        """Convert a sharded checkpoint into a plain-format one (original
        unpadded layout, ``numpy.load``-able), assembling ONE leaf at a
        time. Any single process can run it (typically the chief,
        offline). Returns the exported base path."""
        self.wait()
        path = path or self.latest()
        if path is None:
            raise FileNotFoundError("no sharded checkpoint in %s"
                                    % self.directory)
        meta = self._read_meta(path)
        out_dir = out_dir or self.directory
        os.makedirs(out_dir, exist_ok=True)
        base = os.path.join(out_dir, "ckpt-%d" % meta["step"])
        reader = self._ShardReader(path, meta)
        try:
            by_kind: Dict[str, List[str]] = {"P": [], "O": [], "S": []}
            for lkey in meta["leaves"]:
                kind, name = lkey.split("|", 1)
                by_kind[kind].append(name)
            groups = _group_keys(meta)
            ps_values, ps_opt = self._assemble_ps_full(meta, reader, groups)

            def write_kind(kind: str, out_path: str, extra: Dict[str, Any]):
                w = _StreamingNpzWriter(out_path + ".tmp")
                written = set()
                for name in sorted(by_kind[kind]):
                    w.write(name, self._assemble_leaf(kind, name, meta,
                                                      reader, groups))
                    written.add(name)
                for name in sorted(extra):
                    # a shared leaf (the optimizer's count) can be in the
                    # device tree and in a PS little tree: one copy wins
                    if name not in written:
                        w.write(name, extra[name])
                w.close()
                os.replace(out_path + ".tmp", out_path)

            write_kind("P", base + ".params.npz", ps_values)
            write_kind("O", base + ".opt.npz", ps_opt)
            if by_kind["S"]:
                write_kind("S", base + ".sync.npz", {})
            with open(base + ".meta.json.tmp", "w") as f:
                json.dump({"step": meta["step"], "format": "autodist_tpu.v1",
                           "strategy_id": meta.get("strategy_id")}, f)
            os.replace(base + ".meta.json.tmp", base + ".meta.json")
        finally:
            reader.close()
        logging.info("exported sharded checkpoint %s -> full layout %s",
                     path, base)
        return base

    def _assemble_leaf(self, kind: str, name: str, meta, reader,
                       groups: Dict[str, List[str]]) -> np.ndarray:
        """One leaf reassembled from its slices and unpadded."""
        lm = meta["leaves"]["%s|%s" % (kind, name)]
        shape = tuple(lm["shape"])
        dtype = np.dtype(lm["dtype"])
        prefix = "%s|%s|" % (kind, name)
        full = np.zeros(shape, dtype)
        if not shape:
            try:
                return np.asarray(reader(prefix + "-"), dtype=dtype)
            except KeyError:
                # a process-local-mesh checkpoint: export the chief's view
                return np.asarray(reader(prefix + "-@p0"), dtype=dtype)
        for key in groups.get(prefix[:-1], []):
            token = key[len(prefix):]
            token, _, pnum = token.partition("@")
            if pnum not in ("", "p0"):
                continue  # local-mesh checkpoints export the chief's view
            full[_token_slices(token)] = reader(key)
        unpad = lm.get("unpad")
        if unpad:
            axis, orig = unpad
            sl = [slice(None)] * len(shape)
            sl[axis] = slice(0, orig)
            full = full[tuple(sl)]
        return full

    def _assemble_ps_full(self, meta, reader, groups: Dict[str, List[str]]):
        """Host-PS values + optimizer leaves in the full original layout
        (the JAX store's ``full_values`` / ``full_opt_leaf`` naming: the
        little-tree leaf ``0/mu/v`` becomes the full leaf
        ``0/mu/<var>``)."""
        ps_values: Dict[str, np.ndarray] = {}
        ps_opt: Dict[str, np.ndarray] = {}
        for name, pm in meta.get("ps", {}).items():
            axis, n_shards = int(pm["axis"]), int(pm["nshards"])
            shards = [np.asarray(reader("H|%s::%d" % (name, si)))
                      for si in range(n_shards)]
            ps_values[name] = (shards[0] if n_shards == 1
                               else np.concatenate(shards, axis=axis))
            # a slot: var-shaped leaves concatenate; others copy shard 0
            slot_leaves: Dict[str, List[np.ndarray]] = {}
            for si in range(n_shards):
                prefix = "Ho|%s::%d|" % (name, si)
                for key in groups.get(prefix[:-1], []):
                    slot_leaves.setdefault(key[len(prefix):], []).append(
                        np.asarray(reader(key)))
            for ln, pieces in slot_leaves.items():
                if ln.endswith("/v") or ln == "v":
                    full_name = ((ln[:-2] + "/" + name) if ln.endswith("/v")
                                 else name)
                    if (len(pieces) > 1 and pieces[0].ndim > axis
                            and sum(p.shape[axis] for p in pieces)
                            == ps_values[name].shape[axis]):
                        ps_opt[full_name] = np.concatenate(pieces, axis=axis)
                    else:
                        ps_opt[full_name] = pieces[0]
                else:
                    ps_opt.setdefault(ln, pieces[0])
        return ps_values, ps_opt
