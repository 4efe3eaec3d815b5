"""The port's "lowering": a step recorded as a program.

The JAX package lowers its step (``jax.jit(...).lower().as_text()``) and
its analyses read the StableHLO. The port's step is eager torch, so its
program is the step itself: :func:`record_step` runs the real step
function (the loss, its backward, the gradient sync, the optimizer and
the sentinel's verdict) once on fake tensors (``FakeTensorMode``: no data,
no kernel, no transfer; a fake collective moves nothing) under a
:class:`ProgramRecorder`, a ``TorchDispatchMode`` that writes one line per
dispatched op in the text ``analysis/program.py`` parses:

- each op with its operand ids and each result's id, dtype, shape,
  storage (a view shares its base's) and the bytes it allocated;
- each collective with its cost class, the ranks of its group and its
  payload; the ``all_to_all`` that carries a reduce-scatter
  (``parallel/collectives.py``) is recorded as the scatter it is;
- host reads (``.item()``, the value handed back as 0) and copies between
  the host and the card;
- a ``free`` line where the run drops the last reference to a storage (a
  ``weakref`` finalizer): the lifetimes torch's caching allocator sees;
- ``bwd`` on ops the autograd engine ran, and ``microstep`` regions in a
  fused program;
- the entry arguments with their labels (params, opt_state, sync_state,
  the host-PS values entered as fakes, as the JAX ``_ps_avals`` enters
  them as avals, the batch) and whether each is donated, and the results.

The flash kernels are custom ops with fake implementations
(``ops/flash_attention.py``), so on the card each is one op with its true
outputs. On the CPU the step runs the kernels' plain versions, and the
program lists theirs.

Recording has no side effects: the state, the step, the telemetry
counters, the kernels' launch counts, the host-PS store and the RNG state
are as they were.
"""
import contextlib
import copy
import threading
import weakref
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from autodist_tpu_torch.train_state import TrainState

DTYPE_NAMES = {
    torch.float64: "f64", torch.float32: "f32", torch.float16: "f16",
    torch.bfloat16: "bf16", torch.int64: "i64", torch.int32: "i32",
    torch.int16: "i16", torch.int8: "i8", torch.uint8: "ui8",
    torch.bool: "i1", torch.complex64: "c64", torch.complex128: "c128",
}

_aten = torch.ops.aten
# ops that hand a value to the host, and what the recording returns for it
_HOST_READS = {_aten._local_scalar_dense.default: 0,
               _aten.is_nonzero.default: False,
               _aten.equal.default: True}
_COPIES = {_aten._to_copy.default, _aten.copy_.default,
           _aten._copy_from.default, _aten._copy_from_and_resize.default}
# which arguments of a c10d op carry the payload and which receive it
_PAYLOAD_ARGS = ("input", "input_tensor", "input_tensors", "inputs",
                 "input_list")
_OUTPUT_ARGS = ("output", "output_tensor", "output_tensors", "outputs",
                "output_lists")

_ACTIVE = threading.local()


def active() -> Optional["ProgramRecorder"]:
    """The recorder running on this thread, or None."""
    return getattr(_ACTIVE, "recorder", None)


@contextlib.contextmanager
def microstep(i: int):
    """Mark microstep ``i`` of a fused program in the running recording
    (nothing without one)."""
    rec = active()
    if rec is None:
        yield
        return
    rec.lines.append("microstep %d {" % i)
    try:
        yield
    finally:
        rec.lines.append("}")


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _written(func, args, kwargs) -> List[torch.Tensor]:
    """The tensors an op that returns nothing writes in place (a
    ``_foreach_*_`` op's lists)."""
    out = []
    for i, a in enumerate(func._schema.arguments):
        if a.alias_info is not None and a.alias_info.is_write:
            value = args[i] if i < len(args) else kwargs.get(a.name)
            out += _tensors(value)
    return out


def _device_name(device) -> str:
    d = torch.device(device)
    return d.type if d.index is None else "%s:%d" % (d.type, d.index)


class ProgramRecorder(TorchDispatchMode):
    """Writes the ops dispatched under it as program text (above). Holds
    no reference to a tensor it saw: ids and storages are kept by
    ``id()``, and released by ``weakref`` finalizers."""

    def __init__(self, fake_mode, device):
        super().__init__()
        self.fake_mode = fake_mode
        self.device = _device_name(device)
        self.lines: List[str] = []
        self.args: List[str] = []
        self._ids: Dict[int, str] = {}
        # storage key -> [storage id, bytes, live tensors]
        self._storages: Dict[StorageWeakRef, list] = {}
        self._next_value = 0
        self._next_storage = 0
        self._finalizers = []
        self._captured: Dict[int, torch.Tensor] = {}
        self._open = True

    # -------------------------------------------------------- values

    def _register(self, t: torch.Tensor):
        """``(value id, storage id, bytes allocated here)`` of ``t``,
        registering it at its first sight."""
        key = StorageWeakRef(t.untyped_storage())
        entry = self._storages.get(key)
        fresh = 0
        if entry is None:
            nbytes = int(t.untyped_storage().nbytes())
            entry = ["s%d" % self._next_storage, nbytes, 0]
            self._next_storage += 1
            self._storages[key] = entry
            fresh = nbytes
        vid = self._ids.get(id(t))
        if vid is None:
            vid = str(self._next_value)
            self._next_value += 1
            self._ids[id(t)] = vid
            entry[2] += 1
            self._finalizers.append(
                weakref.finalize(t, self._release, id(t), key))
        return vid, entry[0], fresh

    def _release(self, tid: int, key) -> None:
        self._ids.pop(tid, None)
        entry = self._storages.get(key)
        if entry is None:
            return
        entry[2] -= 1
        if entry[2] <= 0:
            del self._storages[key]
            if self._open:
                self.lines.append("free %s %d" % (entry[0], entry[1]))

    def _describe(self, t: torch.Tensor) -> str:
        _, sid, fresh = self._register(t)
        text = "%s[%s] %s" % (DTYPE_NAMES.get(t.dtype, str(t.dtype)),
                              ",".join(str(int(d)) for d in t.shape), sid)
        if fresh:
            text += " +%d" % fresh
        dev = _device_name(t.device)
        if dev != self.device:
            text += " " + dev
        return text

    def enter(self, label: str, tree, donated: bool = False) -> None:
        """Record the tensors of ``tree`` as entry arguments labelled
        ``label`` and their pytree path."""
        flat, _ = pytree.tree_flatten_with_path(tree)
        for path, leaf in flat:
            if isinstance(leaf, torch.Tensor):
                desc = self._describe(leaf)
                self.args.append("arg %%%s %s%s : %s%s" % (
                    self._ids[id(leaf)], label, pytree.keystr(path), desc,
                    " donated" if donated else ""))

    def results(self, label: str, tree) -> List[str]:
        out = []
        flat, _ = pytree.tree_flatten_with_path(tree)
        for path, leaf in flat:
            if isinstance(leaf, torch.Tensor):
                vid, _, _ = self._register(leaf)
                out.append("result %%%s %s%s" % (vid, label,
                                                  pytree.keystr(path)))
        return out

    def close(self) -> None:
        self._open = False
        for f in self._finalizers:
            f.detach()
        self._finalizers = []

    # ------------------------------------------------------- dispatch

    def _fake(self, x):
        """A real tensor met inside the recording becomes a fake one (its
        first sight recorded as a captured argument), so no op writes to
        a real tensor."""
        if not isinstance(x, torch.Tensor) or isinstance(x, FakeTensor):
            return x
        fake = self._captured.get(id(x))
        if fake is None:
            fake = self.fake_mode.from_tensor(x)
            self._captured[id(x)] = fake
            desc = self._describe(fake)
            self.args.append("arg %%%s captured : %s" % (
                self._ids[id(fake)], desc))
        return fake

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat, spec = pytree.tree_flatten((args, kwargs))
        if any(isinstance(x, torch.Tensor) and not isinstance(x, FakeTensor)
               for x in flat):
            flat = [self._fake(x) for x in flat]
            args, kwargs = pytree.tree_unflatten(flat, spec)
        operands = [x for x in flat if isinstance(x, torch.Tensor)]
        if func in _HOST_READS:
            self.lines.append("_ = %s(%s) : scalar {host=read}" % (
                func, ", ".join("%" + self._register(t)[0]
                                for t in operands)))
            value = _HOST_READS[func]
            if func is _aten._local_scalar_dense.default:
                dtype = operands[0].dtype
                value = (False if dtype == torch.bool
                         else 0.0 if dtype.is_floating_point else 0)
            return value
        ids = ["%" + self._register(t)[0] for t in operands]
        out = func(*args, **kwargs)
        backward = torch._C._current_autograd_node() is not None
        if func.namespace == "c10d":
            self._collective(func, args, kwargs, ids, backward)
            return out
        results = _tensors(out) or _written(func, args, kwargs)
        if not results:
            return out
        attrs = ""
        if func in _COPIES and operands:
            src = operands[-1] if func is _aten.copy_.default else operands[0]
            devs = {src.device.type, results[0].device.type}
            if "cpu" in devs and len(devs) > 1:
                attrs = " {host=copy}"
        types = ", ".join(self._describe(t) for t in results)
        self.lines.append("%s = %s(%s) : %s%s%s" % (
            ", ".join("%" + self._ids[id(t)] for t in results), func,
            ", ".join(ids), types, " bwd" if backward else "", attrs))
        return out

    def _collective(self, func, args, kwargs, ids, backward):
        from autodist_tpu_torch.analysis.program import COLLECTIVE_CLASS
        from autodist_tpu_torch.parallel import collectives
        named = dict(zip((a.name for a in func._schema.arguments), args))
        named.update(kwargs)
        payload = _tensors([named[n] for n in _PAYLOAD_ARGS if n in named]) \
            or _tensors(named.get("tensors"))
        outputs = _tensors([named[n] for n in _OUTPUT_ARGS if n in named]) \
            or _tensors(named.get("tensors"))
        ranks = []
        for a in args:
            if isinstance(a, torch.ScriptObject):
                try:
                    pg = dist.ProcessGroup.unbox(a)
                except (RuntimeError, TypeError):
                    continue
                ranks = dist.get_process_group_ranks(pg)
                break
        name = func._schema.name.split("::")[-1]
        kind = COLLECTIVE_CLASS.get(name, "reduce")
        if kind == "alltoall" and collectives.carried_kind():
            kind = collectives.carried_kind()
        nbytes = sum(t.numel() * t.element_size() for t in payload)
        elems = sum(t.numel() for t in payload)
        dtype = DTYPE_NAMES.get(payload[0].dtype, "") if payload else ""
        types = ", ".join(self._describe(t) for t in outputs)
        names = ", ".join("%" + self._ids[id(t)] for t in outputs) or "_"
        self.lines.append(
            "%s = %s(%s) : %s%s {collective=%s group=[%s] payload=%d "
            "dtype=%s elems=%d}" % (
                names, func, ", ".join(ids), types,
                " bwd" if backward else "", kind,
                ",".join(str(r) for r in ranks), nbytes, dtype, elems))


# ------------------------------------------------------------ the step


def _fake_tree(mode, tree):
    return pytree.tree_map(
        lambda t: mode.from_tensor(t) if isinstance(t, torch.Tensor) else t,
        tree)


@contextlib.contextmanager
def _as_rank(dstep, rank: Optional[int]):
    """The step's view of the mesh as rank ``rank`` sees it (its
    coordinates, its data index), the groups as they are: a recording
    moves nothing, so the program of another rank of the mesh can be
    recorded here."""
    if rank is None or rank == dstep.rank:
        yield
        return
    saved = (dstep.mesh, dstep.rank, dstep.data_rank)
    try:
        if dstep.mesh is not None:
            view = copy.copy(dstep.mesh)
            view.rank = int(rank)
            where = (view._grid == view.rank).nonzero()
            view.coords = {a: int(i[0]) for a, i in zip(view.axes, where)}
            dstep.mesh = view
            from autodist_tpu_torch import const
            dstep.data_rank = view.axis_index(const.DATA_AXIS)
        else:
            dstep.data_rank = int(rank)
        dstep.rank = int(rank)
        yield
    finally:
        dstep.mesh, dstep.rank, dstep.data_rank = saved


def _ps_fakes(dstep, with_opt: bool, wire: bool):
    """Fake host-PS values (and, with ``with_opt``, their little optimizer
    states), created inside the fake mode from the variables' shapes: the
    JAX ``_ps_avals``. ``wire`` gives the int8-wire variables their
    ``{"q", "s"}`` containers, as the per-step pull does."""
    from autodist_tpu_torch.parallel import collectives
    from autodist_tpu_torch.model_item import _torch_dtype
    store = dstep.ps_store
    if store is None:
        return {}, {}
    infos = dstep.model_item.var_infos
    vals = {n: torch.zeros(tuple(infos[n].shape),
                           dtype=_torch_dtype(infos[n].dtype),
                           device=dstep.device)
            for n in store.var_names}
    opts = {}
    if with_opt:
        opts = {n: dstep.optimizer.init({"v": v}) for n, v in vals.items()}
    if wire:
        for n in store.wire_quant:
            vals[n] = collectives.quant_wire(vals[n])
    return vals, opts


def record_step(dstep, state: TrainState, batch, fuse_steps: int = 1,
                program: str = "train", donate: bool = False,
                rank: Optional[int] = None) -> str:
    """The program text of ``dstep``'s step on ``state`` and the placed
    ``batch`` (module docstring): ``program="eval"`` records the
    forward-only evaluation, ``fuse_steps=k > 1`` the fused superstep of k
    microsteps over ``batch`` stacked k times, ``donate`` the variant that
    updates the state in place (the steady state's), ``rank`` the program
    of another rank of the mesh."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from autodist_tpu_torch.telemetry import spans as tel
    if program not in ("train", "eval"):
        raise ValueError("program must be 'train' or 'eval', got %r"
                         % (program,))
    if program == "eval" and dstep.model_item.loss_fn is None:
        program = "train"   # step_fn mode has no eval program (as in JAX)
    if program == "train":
        dstep._check_trainable()
    fused = program == "train" and fuse_steps > 1
    if fused:
        dstep._check_fused_ps()
    mode = FakeTensorMode()
    rec = ProgramRecorder(mode, dstep.device)
    # what the step writes on the dstep; nothing global changes: a fake
    # op draws no random number and a fake kernel counts no launch
    saved = (dstep.writes_begun, dstep.overlap_log, dstep._step_t,
             dstep.dispatches)
    parts = _fake_tree(mode, (state.params, state.opt_state,
                              state.sync_state))
    feed = _fake_tree(mode, batch)
    if dstep._step_t is not None:
        dstep._step_t = mode.from_tensor(dstep._step_t)
    body: List[str] = []
    try:
        with mode:
            ps_vals, ps_opts = _ps_fakes(dstep, with_opt=fused,
                                         wire=not fused)
            if fused:
                feed = pytree.tree_map(
                    lambda t: t.unsqueeze(0).expand(
                        (fuse_steps,) + tuple(t.shape)).contiguous()
                    if isinstance(t, torch.Tensor) else t, feed)
        fake = TrainState(step=state.step, params=parts[0],
                          opt_state=parts[1], sync_state=parts[2])
        donated = donate and program == "train"
        rec.enter("params", fake.params, donated)
        rec.enter("opt_state", fake.opt_state, donated)
        rec.enter("sync_state", fake.sync_state, donated)
        rec.enter("ps", ps_vals, donated and fused)
        rec.enter("ps_opt", ps_opts, donated and fused)
        rec.enter("batch", feed)
        _ACTIVE.recorder = rec
        with mode, rec, tel.muted(), _as_rank(dstep, rank):
            if program == "eval":
                metrics = dstep.evaluate(fake, feed, ps_vals)
                outs = [("metrics", metrics)]
            elif fused:
                st, carry = fake, ((ps_vals, ps_opts)
                                   if dstep.ps_store is not None else None)
                if not donate:
                    from autodist_tpu_torch.kernel.graph_transformer import \
                        _clone, _clone_state
                    st, carry = _clone_state(st), _clone(carry)
                dstep._set_step(state.step)
                new, metrics = dstep._loop(st, feed, fuse_steps, carry)
                outs = [("params", new.params), ("opt_state", new.opt_state),
                        ("sync_state", new.sync_state),
                        ("ps", carry), ("metrics", metrics)]
            else:
                st = fake
                if not donate:
                    from autodist_tpu_torch.kernel.graph_transformer import \
                        _clone_state
                    st = _clone_state(st)
                dstep._set_step(state.step)
                if dstep.model_item.step_fn is not None:
                    new, metrics = dstep._step(st, feed)
                    ps_grads = {}
                else:
                    new, ps_grads, metrics = dstep._train(st, feed, ps_vals)
                outs = [("params", new.params), ("opt_state", new.opt_state),
                        ("sync_state", new.sync_state),
                        ("ps_grads", ps_grads), ("metrics", metrics)]
            body = list(rec.lines)
            for label, tree in outs:
                body += rec.results(label, tree)
    finally:
        _ACTIVE.recorder = None
        rec.close()
        (dstep.writes_begun, dstep.overlap_log, dstep._step_t,
         dstep.dispatches) = saved
    ranks = dstep.num_replicas
    head = ["# autodist_tpu_torch program: the eager step recorded op by op "
            "(kernel/lowering.py)",
            "program @%s fuse_steps=%d donate=%s rank=%d ranks=%d device=%s"
            % (program, fuse_steps if fused else 1,
               "true" if donate and program == "train" else "false",
               dstep.rank if rank is None else rank, ranks, rec.device)]
    return "\n".join(head + rec.args + body + ["end"]) + "\n"
