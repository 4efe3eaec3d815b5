"""Checkpoint saver — the JAX package's original layout, framework-free.

PyTorch counterpart of ``autodist_tpu/checkpoint/saver.py``, writing the
same files: ``ckpt-<step>.params.npz``, ``.opt.npz``, ``.sync.npz`` (when
a compressor keeps state) and ``.meta.json`` (``"format":
"autodist_tpu.v1"``, the step, the strategy id, the ``healthy`` stamp and
each data file's crc32 and bytes). The npz files hold flat arrays keyed
by the JAX package's variable names, in flax's shapes and element order
(``convert.params_to_jax``): ``params/...`` and ``batch_stats/...``,
the optax optimizer's state as the JAX saver flattens it (optax.adam's
``0/count``, ``0/mu/...`` and ``0/nu/...``; sgd with momentum's
``0/trace/...``; behind a clip, ``1/0/...``), and the compressor states
with their leading rank axis. They load with
``numpy.load`` alone, and a checkpoint either package writes restores
into the other.

Writes go to ``.tmp`` siblings that are ``os.replace``'d into place, the
meta last: a checkpoint is committed exactly when its meta exists
(``checkpoint/integrity.py``). Only the chief writes: rank 0 of the
default ``torch.distributed`` group with more than one replica (every
rank joins the gathers), else ``const.is_chief()``. Host-PS variables
save from the store, whole, in the same files: the gathers land the
in-flight push and write a fused superstep's device carry back first,
and read the store's values and optimizer state, and a restore's
``init_state`` puts them back into the store (and drops any carry).
Under async PS (a serving store) a save first drains this process's
owner queues, and each shard another host owns is saved from that
owner's latest publish: its values, and its optimizer state from the
owner's side channel (``PSStore._remote_opt_state``), so the checkpoint
holds the owner's moments, not this process's frozen init. The JAX
saver's epoch fence (``elastic.maybe_fence``) comes with in-run shrink
and grow (ROADMAP A item 8.3b). The writes in flight in this process are
counted (:func:`wait_for_writes`): the sync-elastic restart waits for
them before it reads the newest checkpoint.
"""
import contextlib
import json
import os
import re
import threading
import time
import zipfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from autodist_tpu_torch import const, convert
from autodist_tpu_torch.checkpoint import integrity
from autodist_tpu_torch.checkpoint.integrity import CheckpointDamaged
from autodist_tpu_torch.model_item import flatten_state, unflatten_state
from autodist_tpu_torch.runtime.faultinject import checkpoint_fault
from autodist_tpu_torch.telemetry import spans as tel
from autodist_tpu_torch.train_state import TrainState
from autodist_tpu_torch.utils import logging


def _is_chief(dstep) -> bool:
    """Rank 0 of the default process group writes (``const.is_chief()``
    is true on every rank the group's launcher starts); with one replica,
    the process that ``const.is_chief()`` names."""
    if dstep.num_replicas > 1:
        return dstep.replica_info.process_rank == 0
    return const.is_chief()


def _read_npz(path: str) -> Dict[str, np.ndarray]:
    """Fully read one npz, converting every read-path failure — vanished
    file, I/O error, zip/npy corruption — to :class:`CheckpointDamaged`,
    so the restore fallback loop can catch exactly that and configuration
    errors (template mismatch in ``_flat_to_tree``) stay loud. In
    particular a mid-read ``FileNotFoundError`` must NOT escape: the
    caller's no-valid-checkpoint sentinel shares that type, and
    ``Runner.init`` would misread the error as "start fresh"."""
    try:
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    except (OSError, ValueError, zipfile.BadZipFile) as e:
        raise CheckpointDamaged("%s unreadable: %s" % (path, e)) from e


def _flat_to_tree(template: Dict[str, tuple], flat: Dict[str, np.ndarray]
                  ) -> Dict[str, np.ndarray]:
    """The entries of ``flat`` that the JAX-named ``template`` (``{name:
    shape}``) asks for; raises on a missing name or another shape, as the
    JAX saver does against its pytree template."""
    out = {}
    for n, want in template.items():
        if n not in flat:
            raise KeyError("checkpoint missing variable %r" % n)
        if tuple(flat[n].shape) != tuple(want):
            raise ValueError("checkpoint var %r has shape %s, model wants %s"
                             % (n, flat[n].shape, tuple(want)))
        out[n] = flat[n]
    return out


def _user_state_to_host(tree) -> Dict[str, np.ndarray]:
    """A step_fn state tree as host arrays under its ``/``-joined paths
    (bfloat16 leaves as float32: numpy has no bfloat16)."""
    out = {}
    for name, leaf in flatten_state(tree):
        t = torch.as_tensor(leaf).detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        out[name] = t.to("cpu", copy=True).numpy()
    return out


def _user_state_from_flat(template, path: str, device=None):
    """The step_fn state tree of ``template``'s structure, leaf dtypes and
    shapes from a checkpoint's params file, its tensors on ``device``."""
    leaves = dict(flatten_state(template))
    flat = _flat_to_tree({n: np.shape(v) for n, v in leaves.items()},
                         _read_npz(path + ".params.npz"))
    placed = {}
    for n, v in leaves.items():
        dtype = v.dtype if isinstance(v, torch.Tensor) else \
            torch.as_tensor(np.asarray(v)).dtype
        placed[n] = torch.as_tensor(flat[n]).to(device or "cpu", dtype)
    return unflatten_state(template, placed)


def _skip_unhealthy(status) -> bool:
    """Automatic restore paths (``latest()``, fallback ``restore()``,
    auto-resume) never load a checkpoint stamped ``healthy: false``; a
    checkpoint with no stamp is healthy-unknown and resumable."""
    if status.healthy is False:
        logging.warning("checkpoint step %d is stamped UNHEALTHY "
                        "(committed under a bad sentinel verdict); "
                        "skipping", status.step)
        tel.counter_add("ckpt.unhealthy_skipped")
        return True
    if status.healthy is None:
        logging.info("checkpoint step %d predates the health stamp "
                     "(healthy-unknown); treating as resumable",
                     status.step)
    return False


def scan_checkpoint_metas(directory: str, pattern) -> list:
    """Sorted (step, filename) pairs for meta files matching ``pattern``
    (a compiled regex whose group 1 is the step). Foreign files in a
    shared directory are ignored, not crashed on."""
    out = []
    for f in os.listdir(directory):
        m = pattern.match(f)
        if m:
            out.append((int(m.group(1)), f))
    return sorted(out)


def sentinel_save_vetoed(runner_or_step) -> bool:
    """The JAX savers' quarantine gate, duck-typed: a runner whose
    ``sentinel_save_veto()`` is true vetoes the save, before the gathers.
    In a job of more than one process only a runner whose verdicts are
    computed inside the step (``metadata["sentinel_guards"]``, the same
    on every rank) may veto: a divergent veto would strand the peers in
    the gather (``runtime/sentinel.py``: the Runner's quarantine)."""
    veto = getattr(runner_or_step, "sentinel_save_veto", None)
    if not (callable(veto) and veto()):
        return False
    dstep = getattr(runner_or_step, "distributed_step", runner_or_step)
    if getattr(dstep, "num_replicas", 1) > 1:
        metadata = getattr(dstep, "metadata", None) or {}
        if not metadata.get("sentinel_guards", False):
            logging.warning(
                "sentinel quarantine NOT vetoing this save: loss-only "
                "monitoring is not replica-uniform in a multi-process "
                "job — the checkpoint will carry its healthy stamp instead")
            return False
    tel.counter_add("sentinel.save_vetoes")
    logging.warning("checkpoint save vetoed: sentinel quarantine "
                    "(health verdict is bad)")
    return True


def sentinel_health_stamp(runner_or_step) -> bool:
    """The ``healthy`` stamp this save carries: ``sentinel_healthy()`` of
    a runner that has one, else True (no evidence of ill health)."""
    fn = getattr(runner_or_step, "sentinel_healthy", None)
    return bool(fn()) if callable(fn) else True


# this process's checkpoints between their host copy and their commit:
# the sync-elastic restart (runtime/coordinator.py) waits for them before
# it reads the newest checkpoint, so a worker that dies while the chief
# still writes the save before its death restarts the job from that save
_writes = 0
_writes_cv = threading.Condition()


@contextlib.contextmanager
def _writing():
    global _writes
    with _writes_cv:
        _writes += 1
    try:
        yield
    finally:
        with _writes_cv:
            _writes -= 1
            _writes_cv.notify_all()


def wait_for_writes(timeout: float) -> bool:
    """Wait up to ``timeout`` s until no save of this process is between
    its host copy and its commit; True when none is."""
    with _writes_cv:
        return _writes_cv.wait_for(lambda: _writes == 0, timeout)


class BackgroundWriter:
    """At most one background checkpoint write in flight. ``wait()`` joins
    the pending write and re-raises any error it hit — a failed checkpoint
    must never look like a success."""

    def __init__(self, name: str):
        self._name = name
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def submit(self, fn):
        self.wait()  # serialize: at most one write in flight
        self._error = None

        def run():
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 — re-raised in wait()
                self._error = e

        self._thread = threading.Thread(target=run, name=self._name,
                                        daemon=False)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            # the time the caller is held up by the write ("ckpt.wait")
            with tel.span("ckpt.wait", "ckpt"):
                self._thread.join()
            self._thread = None
            err, self._error = self._error, None
            if err is not None:
                raise err


class Saver:
    """Save/restore a Runner's state in the JAX package's original layout.

    ``save()`` copies the state to the host in the JAX layout before it
    returns (the step updates the device tensors in place, so the copy is
    what the files hold). ``async_save=True`` moves the npz serialization
    to a background thread, which overlaps the following steps; at most
    one write is in flight, a new ``save()`` joins the previous one, and
    ``wait()`` joins explicitly (``latest()`` and ``restore()`` do)."""

    def __init__(self, directory: Optional[str] = None, max_to_keep: int = 5,
                 chief_only: bool = True, async_save: bool = False):
        self.directory = directory or const.DEFAULT_CHECKPOINT_DIR
        self.max_to_keep = max_to_keep
        self.chief_only = chief_only
        self.async_save = async_save
        self._writer = BackgroundWriter("adt-ckpt-writer")
        os.makedirs(self.directory, exist_ok=True)

    # ------------------------------------------------------------------ save

    def save(self, runner_or_step, state: Optional[TrainState] = None,
             step: Optional[int] = None) -> Optional[str]:
        """Write a checkpoint of a Runner (its state) or of a
        DistributedStep and an explicit TrainState; returns its base path
        (``.../ckpt-<step>``), or None where this process does not write.
        The gathers of the compressor states and of sharded variables are
        collectives: EVERY rank must call save(); only the file writes are
        chief-gated."""
        if hasattr(runner_or_step, "distributed_step"):  # Runner
            dstep = runner_or_step.distributed_step
            state = state if state is not None else runner_or_step.state
        else:
            dstep = runner_or_step
        if state is None:
            raise ValueError("no state to save")
        if sentinel_save_vetoed(runner_or_step):
            return None
        healthy = sentinel_health_stamp(runner_or_step)
        item = dstep.model_item
        store = getattr(dstep, "ps_store", None)
        if store is not None and store.serving:
            # every gradient this process queued, applied by its owner
            # loops, before the state is read
            dstep.flush_ps()
            store.drain()
        # the collectives first, on every rank (the compressor states; a
        # partitioned or ZeRO-sharded variable's shards); then the chief's
        # host copy in the JAX layout, taken before save() returns
        with tel.span("ckpt.gather", "ckpt"):
            sync = dstep.gather_sync_state(state)
            opt = dstep.gather_opt_state(state)
            params = dstep.gather_params(state)
        if step is None:
            step = int(state.step)
        checkpoint_fault("collect", step=step)
        if self.chief_only and not _is_chief(dstep):
            return None
        with _writing():
            return self._write(dstep, step, params, opt, sync, healthy)

    def _write(self, dstep, step, params, opt, sync, healthy):
        """The chief's host copy in the JAX layout, then the files (now or
        in the background writer)."""
        item = dstep.model_item
        with tel.span("ckpt.to_host", "ckpt"):
            if item.step_fn is not None:
                # an opaque step's state saves under its own paths, as the
                # JAX saver flattens it; the step owns its optimizer
                trees = [(".params.npz", _user_state_to_host(params)),
                         (".opt.npz", {})]
            else:
                trees = [(".params.npz", convert.params_to_jax(
                    params, item.flax_shapes, item.jax_names)),
                    (".opt.npz", {} if opt is None else
                     convert.opt_state_to_jax(opt, item.flax_shapes,
                                              item.optimizer_spec,
                                              item.jax_names))]
            sync_flat = convert.sync_state_to_jax(sync, item.var_infos,
                                                  item.flax_shapes,
                                                  item.optimizer_spec)
            if sync_flat:
                trees.append((".sync.npz", sync_flat))
        path = os.path.join(self.directory, "ckpt-%d" % step)
        meta = {"step": step, "format": "autodist_tpu.v1",
                "strategy_id": dstep.strategy.id, "healthy": healthy}

        @_writing()
        def write():
            t_begin = time.monotonic()
            with tel.span("ckpt.write", "ckpt", step=int(step)):
                # every data file goes to a .tmp sibling first and is
                # os.replace'd into place; the meta records each file's
                # crc32 and bytes, digested as the bytes are written
                file_meta: Dict[str, dict] = {}
                finals = []
                for suffix, flat in trees:
                    final = path + suffix
                    tmp = final + ".tmp"
                    with open(tmp, "wb") as f:
                        w = integrity.Crc32Writer(f)
                        np.savez(w, **flat)
                    file_meta[os.path.basename(final)] = w.digest
                    finals.append((tmp, final))
                checkpoint_fault("write", path=path, step=int(step))
                for tmp, final in finals:
                    os.replace(tmp, final)
                meta["files"] = file_meta
                # meta last, atomically: the commit point
                checkpoint_fault("meta", path=path, step=int(step))
                with open(path + ".meta.json.tmp", "w") as f:
                    json.dump(meta, f)
                os.replace(path + ".meta.json.tmp", path + ".meta.json")
                checkpoint_fault("committed", path=path, step=int(step))
            with tel.span("ckpt.gc", "ckpt"):
                self._gc()
            tel.counter_add("ckpt.saves")
            tel.hist_observe("ckpt.save_ms",
                             (time.monotonic() - t_begin) * 1e3)
            logging.info("saved checkpoint %s (step %d)", path, step)

        if not self.async_save:
            write()
            return path
        self._writer.submit(write)
        return path

    def wait(self):
        """Join a pending async write; re-raises any error the writer hit —
        a failed checkpoint must not look like a success."""
        self._writer.wait()

    _META_RE = re.compile(r"^ckpt-(\d+)\.meta\.json$")

    def _own_metas(self):
        return scan_checkpoint_metas(self.directory, self._META_RE)

    def _gc(self):
        metas = self._own_metas()
        while len(metas) > self.max_to_keep:
            _, fname = metas.pop(0)
            victim = fname.replace(".meta.json", "")
            for suffix in (".meta.json", ".params.npz", ".opt.npz",
                           ".sync.npz"):
                try:
                    os.remove(os.path.join(self.directory, victim + suffix))
                except FileNotFoundError:
                    pass
        # failed-attempt debris (.tmp siblings, data files whose meta —
        # the commit point — never landed) below the newest commit
        victims, _ = integrity.gc_candidates(self.directory, "plain")
        for f in victims:
            try:
                os.remove(os.path.join(self.directory, f))
                tel.counter_add("ckpt.gc_orphans")
            except FileNotFoundError:
                pass
        if victims:
            logging.info("checkpoint gc: removed %d failed-attempt files "
                         "(%s)", len(victims), ", ".join(victims[:6]))

    # --------------------------------------------------------------- restore

    def latest(self) -> Optional[str]:
        """Base path of the newest COMMITTED checkpoint — fast validation
        skips torn save attempts and structurally damaged steps with a
        logged reason."""
        self.wait()  # an in-flight async write must be visible to readers
        for status in integrity.committed_newest_first(self.directory,
                                                       "plain"):
            if status.committed:
                if _skip_unhealthy(status):
                    continue
                return status.base
            logging.warning("checkpoint step %d is %s, skipping: %s",
                            status.step, status.state,
                            "; ".join(status.problems[:3]))
        return None

    def restore_params(self, params_template, path: Optional[str] = None,
                       device=None) -> dict:
        """The params of a checkpoint as the port's ``{name: float32
        tensor}`` on ``device`` (default: the CPU) for the variables of
        ``params_template`` (a port params mapping; its ``flax_shapes``
        give the DenseGeneral shapes) — usable without a runner."""
        self.wait()
        path = path or self.latest()
        if path is None:
            raise FileNotFoundError("no checkpoint in %s" % self.directory)
        shapes = {n: tuple(t.shape) for n, t in params_template.items()}
        names = getattr(params_template, "jax_names", None)
        template = convert.jax_shapes(
            shapes, getattr(params_template, "flax_shapes", None), names)
        flat = _flat_to_tree(template, _read_npz(path + ".params.npz"))
        return {n: convert.leaf_from_jax(flat[convert.jax_name(n, s, names)],
                                         n, s, device)
                for n, s in shapes.items()}

    def restore(self, runner, path: Optional[str] = None) -> Tuple[Any, int]:
        """Restore a Runner's state; returns (state, step).

        **Last-good fallback**: with no explicit ``path``, checkpoints are
        tried newest-first, skipping torn attempts and damaged steps (fast
        validation up front, read-time zip-CRC failures during the load)
        with a logged reason and ``ckpt.fallback``/``ckpt.corrupt_shards``
        counters; hard-fails only when no valid checkpoint exists. An
        explicit ``path`` is validated where it lives and refused when
        damaged."""
        self.wait()
        if path is not None:
            status = integrity.validate_plain(*integrity.parse_base(path))
            if not status.committed:
                tel.counter_add("ckpt.corrupt_shards", len(status.damaged))
                raise CheckpointDamaged(
                    "checkpoint %s is %s: %s" % (
                        path, status.state, "; ".join(status.problems[:5])))
            if status.healthy is False:
                logging.warning("restoring %s despite its UNHEALTHY stamp "
                                "(explicit path overrides the quarantine)",
                                path)
            return self._restore_at(runner, path)
        tried = 0
        for status in integrity.committed_newest_first(self.directory,
                                                       "plain"):
            if not status.committed:
                logging.warning("restore: skipping step %d (%s): %s",
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
            except (CheckpointDamaged, zipfile.BadZipFile) as e:
                if runner.distributed_step.num_replicas > 1:
                    raise  # peers must all restore the SAME step
                logging.warning("restore: step %d damaged mid-read (%s); "
                                "falling back", status.step, e)
                tel.counter_add("ckpt.fallback")
                tel.counter_add("ckpt.corrupt_shards")
        raise FileNotFoundError(
            "no valid checkpoint in %s (%d committed candidate(s) tried)"
            % (self.directory, tried))

    def _restore_at(self, runner, path: str) -> Tuple[Any, int]:
        dstep = runner.distributed_step
        item = dstep.model_item
        # the arrays go to the card as they are read, and change layout
        # there (a host transpose of a large kernel is the slow part)
        if item.step_fn is not None:
            params = _user_state_from_flat(item.params, path, dstep.device)
        else:
            params = self.restore_params(item.params, path, dstep.device)
        opt_state = None
        if item.optimizer_spec is not None:
            shapes = {n: tuple(t.shape) for n, t in params.items()}
            flat = _flat_to_tree(
                convert.opt_state_template(shapes, item.flax_shapes,
                                           item.optimizer_spec,
                                           item.jax_names),
                _read_npz(path + ".opt.npz"))
            opt_state = convert.opt_state_from_jax(flat, shapes,
                                                   dstep.device,
                                                   item.optimizer_spec,
                                                   item.jax_names)
        sync_state = None
        if os.path.exists(path + ".sync.npz"):
            try:
                sync_state = convert.sync_state_from_jax(
                    _read_npz(path + ".sync.npz"), item.var_infos,
                    item.flax_shapes, item.optimizer_spec)
            except (KeyError, ValueError) as e:
                logging.warning("sync state in checkpoint incompatible with "
                                "current strategy (%s); reinitializing", e)
        state = dstep.init_state(params, opt_state, sync_state)
        try:
            with open(path + ".meta.json") as f:
                step = int(json.load(f)["step"])
        except (OSError, json.JSONDecodeError, KeyError) as e:
            raise CheckpointDamaged(
                "%s.meta.json unreadable: %s" % (path, e)) from e
        state = TrainState(step=step, params=state.params,
                           opt_state=state.opt_state,
                           sync_state=state.sync_state)
        runner.state = state
        notify = getattr(runner, "notify_state_restored", None)
        if callable(notify):
            notify()  # re-sync the process-local LR scales
        tel.counter_add("ckpt.restores")
        logging.info("restored checkpoint %s (step %d)", path, step)
        return state, step
