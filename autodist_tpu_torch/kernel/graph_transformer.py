"""GraphTransformer — turns a compiled Strategy into the programs a Runner
executes.

PyTorch counterpart of ``autodist_tpu/kernel/graph_transformer.py``. JAX
lowers the plan to jitted SPMD programs over a device mesh; the port runs
eagerly, one process a replica (the ranks of the ``torch.distributed``
group the caller created, ``kernel/replicator.py``), so a "program" here
is a Python callable with the signature the JAX program has.
:class:`DistributedStep` carries:

- the training step (``__call__``): the JAX ``local_step`` — loss and
  grads of this rank's shard of the batch (under the plan's compute tier
  and remat policy, at every replica count), then, with more than one
  replica, the gradient sync: the ZeRO-sharded variables'
  reduce-scatters, the concatenated buckets of compressed variables
  (``parallel/collectives.py``), then the per-variable synchronizers
  (a reduce-scatter for a partitioned variable), each a mean over the
  replicas — as one epilogue after the backward, or, with
  ``overlap=True``, launched from backward hooks in the schedule's
  reverse layer order; frozen variables held still; the optimizer
  apply (on each partitioned variable's shard, and on each ZeRO
  variable's flat shard, whose delta is all-gathered); ``{"loss":
  ...}`` metrics averaged over the replicas. One replica issues no
  collective;
- the fused superstep (:meth:`DistributedStep.multi_step`,
  :meth:`DistributedStep.run_multi`): k microsteps in one dispatch, on
  ``cuda`` one replay of a CUDA graph (``kernel/superstep.py``), on the
  CPU the k-step loop, with the host-PS variables in a device carry;
- in step_fn mode (``AutoDist.build_step``) the user's opaque
  ``step_fn(state, batch) -> (new_state, metrics)`` in place of the
  loss, grads and optimizer, on one replica;
- :meth:`DistributedStep.evaluate`: forward-only metrics;
- the serving programs (:meth:`DistributedStep.predict_program`,
  :meth:`DistributedStep.decode_program`), run under
  ``torch.inference_mode()`` with the mesh's axes bound; at N > 1 a
  bucket (or the slots) splits over the batch axes only, and the rows
  come back over the batch axes' group.

The bf16 compute tier (``graph_config.compute_dtype="bf16"``) casts the
f32 params and float batch leaves to bf16 inside the loss and the loss
and bf16 aux back to f32, so gradients reach the f32 masters as f32 and
every collective accumulates in f32; ``graph_config.remat``
(``strategy/remat.py``) checkpoints each transformer layer of the loss
(or the loss whole). Both apply at every replica count, as in the JAX
lowering.

Host-resident parameter servers (``parallel/ps.py``): a PS variable
without a proxy rests in the store's host memory with its optimizer
state, at every replica count. Each step pulls the store's values to the device
(through :class:`~autodist_tpu_torch.parallel.ps.PSPipeline`, which
overlaps the pull and the push with compute), runs the loss on the full
params, and pushes each PS variable's mean gradient back — dense, the
(ids, values) pairs of a lookup table, or the int8 wire container —
where the host applies the optimizer. Fused supersteps instead carry
the PS variables' values and optimizer state on the device for a run of
supersteps (:meth:`DistributedStep.run_multi`), emulating the pull, the
push and the store's apply inside each microstep, and write the carry
back before the next read of the store. Lookup tables the JAX package
syncs over its sparse (ids, values) wire (``ops/embedding.py``: the
taps) take that wire here too: pushed to the store as pairs, or, for an
AllReduce table at N > 1, all-gathered over the ranks and scatter-added
into the update. Async PS (``sync=False``) builds each process at one
replica of its own and puts the store in serving mode over the
coordination service (``AutoDist._wire_async_ps``); a stale plan
(``staleness`` > 0) at N > 1 is paced across processes by the Runner's
step window.

A TensorParallel, PipelineParallel, SequenceParallelAR or
ExpertParallel plan lays the processes out as its mesh
(``parallel/mesh.py``: ``{data, model}``, ``{pipe, data[, model]}``,
``{data, seq[, model]}``, ``{data, expert}``): the batch axes split the
batch (``kernel/replicator.py``; the data axis alone, or data and expert
jointly; the pipe, model and seq ranks of one batch index see the same
rows) and the seq axis a sequence leaf's dim 1, each model-parallel
variable rests as this rank's slice (``VarLayout.mp_axes``) and the loss
consumes the slices with the model, pipe, seq and expert axes bound
(``parallel/tensor.py``, ``parallel/pipeline.py``,
``ops/attention.py``'s ring and Ulysses attention,
``parallel/sequence.py``, ``parallel/expert.py``), its backward
included. Those variables sync by the sum over the other mesh axes'
groups, every other variable by the buckets and synchronizers over all
ranks, each divided by N, every process (the JAX lowering's
``psum(complement) / N``). Sharded storage lives on the data axis, as in
the JAX lowering: a partitioned variable's shards and a ZeRO variable's
flat optimizer shards split over the data axis's group, so the ranks of
one data index hold the same shard; their gradients reduce-scatter there
and then sum over the groups of the other axes, over N. A host-PS
gradient is the mean over every rank, whatever the mesh. The transform
refuses, by name and at every replica count, the plan features the port
has not reached.

With a health-sentinel policy (``runtime/sentinel.py``) the step guards
its own update (the JAX ``_health_verdict``): the global gradient L2
norm (sharded storage adds ``local * S/N`` in one stacked all-reduce),
the NaN/Inf counts of the synced gradients (the PS wire included) and
of the updated params, and the loss's finiteness make a verdict that
rides the metrics; a bad one keeps the params, the optimizer state and
the compressor state as they were (``torch.where``) and suppresses the
host-PS push, all on the device, in every microstep of a fused
superstep too. The optimizer's updates are scaled by the state's
``sync_state["sentinel"]["lr_scale"]`` (the sentinel's LR halving).
``ADT_GRAD_FAULT_PLAN`` (``runtime/faultinject.py``) corrupts named
gradients before the sync, keyed on a step counter kept on the device.
The ``rhd`` and ``hier`` all-reduce schedules (``schedule=`` or
``spec="DCN"`` on a synchronizer) lower to ``collectives.rhd_psum`` and
``collectives.hierarchical_psum`` over the resource spec's hosts
(``parallel/mesh.py::HostGroups``).
"""
import collections
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from autodist_tpu_torch import const
from autodist_tpu_torch.convert import from_jax_layout, to_jax_layout
from autodist_tpu_torch.kernel import lowering
from autodist_tpu_torch.kernel.partitioner import VarLayout, VariablePartitioner
from autodist_tpu_torch.kernel.replicator import ReplicaInfo
from autodist_tpu_torch.kernel.synchronization.all_reduce_synchronizer \
    import AllReduceSynchronizer
from autodist_tpu_torch.kernel.synchronization.ps_synchronizer import \
    PSSynchronizer
from autodist_tpu_torch.kernel.synchronization.zero_synchronizer import \
    ZeroSynchronizer
from autodist_tpu_torch.kernel.synchronization.synchronizer import \
    all_reduce_sum
from autodist_tpu_torch.ops import embedding
from autodist_tpu_torch.parallel import collectives
from autodist_tpu_torch.parallel import mesh as mesh_lib
from autodist_tpu_torch.parallel import ps as ps_lib
from autodist_tpu_torch.remapper import CACHE_KEYS, path_name
from autodist_tpu_torch.runtime import faultinject
from autodist_tpu_torch.strategy.base import Strategy
from autodist_tpu_torch.telemetry import spans as tel
from autodist_tpu_torch.train_state import TrainState
from autodist_tpu_torch.utils import logging


def _leading_rows(tree) -> int:
    """Leading dim of the first array leaf with one (0 if none)."""
    for leaf in pytree.tree_leaves(tree):
        shape = np.shape(leaf)
        if len(shape) >= 1:
            return int(shape[0])
    return 0


def _classify(out, rows: int):
    """Per-leaf batch mask: True for leaves whose leading dim is the
    feed's row count (per-example outputs), False for the rest — the
    rule the JAX lowering applies to its abstract output shapes."""
    return pytree.tree_map(
        lambda a: bool(rows) and np.ndim(a) >= 1 and np.shape(a)[0] == rows,
        out)


def _status_agree(code: int, group, device) -> int:
    """The largest of the ranks' dispatch status codes (0 ok, 1 a typed
    shed, 2 another error) over ``group``: a rank whose local part failed
    still takes part in this one reduction, and then no rank enters the
    gathers, so none is left waiting in one."""
    on = device if dist.get_backend(group) == "nccl" else "cpu"
    flag = torch.tensor([code], dtype=torch.int32, device=on)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
    return int(flag.item())


def _gather_rows(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The ranks' ``[rows, ...]`` blocks of one leaf, concatenated in rank
    order (the block order of ``P(batch_axes)``)."""
    x = x.detach().contiguous()
    wire = x.to(torch.uint8) if x.dtype == torch.bool else x
    parts = [torch.empty_like(wire) for _ in range(n)]
    dist.all_gather(parts, wire, group=group)
    out = torch.cat(parts)
    return out.to(torch.bool) if x.dtype == torch.bool else out


def _reduce_replicated(x, group, n: int):
    """A non-batch leaf reduced as the JAX lowering reduces it (eval
    metrics' rule): the mean over the ranks for floating types, the max
    otherwise."""
    if not isinstance(x, torch.Tensor):
        return x
    flat = x.detach().reshape(-1).clone()
    if flat.is_floating_point():
        dist.all_reduce(flat, group=group)
        flat = flat / n
    else:
        wire = flat.to(torch.uint8) if flat.dtype == torch.bool else flat
        dist.all_reduce(wire, op=dist.ReduceOp.MAX, group=group)
        flat = wire.to(flat.dtype)
    return flat.reshape(x.shape)


class ForwardProgram:
    """A forward-only fetch program plus its per-leaf batch classification
    (the JAX ``ForwardProgram``).

    ``batch_mask`` mirrors the fetch tree with one bool per leaf: True for
    per-example rows, False for anything else. Serving's padded-row
    masking and per-request fan-out consult it instead of comparing
    shapes at each call. JAX classifies from abstract shapes at lowering
    time; the eager port classifies at the first call (``classify``), on
    this rank's rows.

    With ``world`` > 1 ranks a call is SPMD over ``group``: each rank runs
    :meth:`local` on its rows, the ranks agree on their status, then
    :meth:`collect` all-gathers the per-example leaves over
    ``rows_group`` (the batch axes' block of ``rows_world`` ranks, in
    its order; every rank of ``group`` without a mesh) — the ranks of one
    model, pipe, seq or expert line ran the same rows — (those under a
    top-level key in ``keep_local`` stay on their rank: the decode
    caches) and reduces the others over ``group`` as the JAX lowering
    does (``pmean`` for floating types, ``pmax`` otherwise)."""

    def __init__(self, fn: Callable, classify: Callable, group=None,
                 world: int = 1, device=None, keep_local=(), *,
                 rows_group, rows_world: int):
        self.fn = fn
        self._classify = classify
        self._mask = None
        self.group = group
        self.world = int(world)
        self.device = device
        self.keep_local = frozenset(keep_local)
        self.rows_group, self.rows_world = rows_group, int(rows_world)

    def local(self, state, ps_vals, batch):
        """This rank's outputs on its rows, nothing gathered."""
        out = self.fn(state, ps_vals, batch)
        if self._mask is None:
            self._mask = self._classify(state, ps_vals, batch, out)
        return out

    def collect(self, out, error: Optional[BaseException] = None):
        """The global fetch tree from this rank's :meth:`local` outputs (or
        the ``error`` its local part raised). Every rank calls it for every
        dispatch; if any rank failed, every rank raises (the typed shed
        when the failure was one)."""
        if self.world <= 1:
            if error is not None:
                raise error
            return out
        from autodist_tpu_torch.serving.engine import ServingUnavailable
        code = 0 if error is None else (
            1 if isinstance(error, ServingUnavailable) else 2)
        worst = _status_agree(code, self.group, self.device)
        if error is not None:
            raise error
        if worst == 1:
            raise ServingUnavailable("a serving dispatch shed on another "
                                     "rank (its PS snapshot window ran out)")
        if worst:
            raise RuntimeError("a serving dispatch failed on another rank")

        def get(path, is_batch, leaf):
            if not isinstance(leaf, torch.Tensor):
                return leaf
            if is_batch:
                top = path_name(path[:1])
                if top in self.keep_local or self.rows_world <= 1:
                    return leaf
                return _gather_rows(leaf, self.rows_group, self.rows_world)
            return _reduce_replicated(leaf, self.group, self.world)
        with torch.inference_mode():
            return pytree.tree_map_with_path(
                lambda path, is_batch, leaf: get(path, is_batch, leaf),
                self._mask, out)

    def __call__(self, state, ps_vals, batch):
        if self.world <= 1:
            return self.local(state, ps_vals, batch)
        try:
            out, error = self.local(state, ps_vals, batch), None
        except Exception as e:  # noqa: BLE001 — agreed in collect()
            out, error = None, e
        return self.collect(out, error)

    @property
    def batch_mask(self):
        if self._mask is None:
            raise RuntimeError("a program's batch_mask is known after its "
                               "first call")
        return self._mask


def _named_leaves(tree, prefix="") -> dict:
    """``{"a/b": leaf}`` of a tree of nested dicts."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_named_leaves(v, "%s/%s" % (prefix, k) if prefix else k))
    return out


def _map_named(fn, tree, prefix=""):
    """``tree`` with each leaf replaced by ``fn(name, leaf)`` (names as
    :func:`_named_leaves` gives them)."""
    if not isinstance(tree, dict):
        return fn(prefix, tree)
    return {k: _map_named(fn, v, "%s/%s" % (prefix, k) if prefix else k)
            for k, v in tree.items()}


def _clone(tree):
    return pytree.tree_map(
        lambda t: t.clone() if isinstance(t, torch.Tensor) else t, tree)


def _clone_state(state: TrainState) -> TrainState:
    return TrainState(step=state.step, params=_clone(state.params),
                      opt_state=_clone(state.opt_state),
                      sync_state=_clone(state.sync_state))


def _detach(leaf):
    return leaf.detach() if isinstance(leaf, torch.Tensor) else leaf


def _select(ok, new_tree, old_tree):
    """Keep ``new_tree``'s tensors where ``ok`` (a 0-d bool tensor) holds,
    else write ``old_tree``'s values (the same structure) back into them,
    in place: the sentinel's discard of a bad update, on the device."""
    new, old = _named_leaves(new_tree), _named_leaves(old_tree)
    for k, t in new.items():
        o = old.get(k)
        if isinstance(t, torch.Tensor) and isinstance(o, torch.Tensor) \
                and o is not t:
            torch.where(ok, t, o, out=t)


def _health_stats(tensors):
    """(sum of squares, nonfinite count) over ``tensors``, float32 0-d
    tensors on their device: one concatenation, then one reduction each
    (the JAX verdict sums each leaf's squares and adds the sums; the
    order differs, within float32 rounding)."""
    ts = [t.detach().reshape(-1) for t in tensors]
    if not ts:
        return None, None
    flat = ts[0] if len(ts) == 1 else torch.cat(
        [t.to(torch.float32) for t in ts])
    flat = flat.to(torch.float32)
    return flat.square().sum(), (~torch.isfinite(flat)).sum().to(
        torch.float32)


def _stack(*leaves):
    """One metric over k microsteps, ``[k, ...]``: tensors stack where they
    live; host values (a constant the step returns) stack on the host."""
    if all(isinstance(t, torch.Tensor) for t in leaves):
        return torch.stack(leaves)
    return np.stack([np.asarray(t) for t in leaves])


def _lead_dims(tree) -> set:
    return {int(np.shape(t)[0]) for t in pytree.tree_leaves(tree)
            if np.ndim(t) >= 1}


def _step_fn_output(out, template):
    """``(new_state, metrics)`` of a step_fn's return value, the state in
    the template's structure; refused (the JAX lowering's ``ValueError``)
    unless it is such a pair whose state has the template's leaves."""
    from autodist_tpu_torch.model_item import flatten_state, unflatten_state
    if not (isinstance(out, tuple) and len(out) == 2):
        raise ValueError("step_fn must return (new_state, metrics); got %s"
                         % type(out).__name__)
    got = dict(flatten_state(out[0]))
    want = [n for n, _ in flatten_state(template)]
    if sorted(got) != sorted(want):
        raise ValueError("step_fn's new_state leaves %s do not match the "
                         "state template's %s" % (sorted(got), sorted(want)))
    return unflatten_state(template, got), out[1]


def sparse_wire_vars(item, replicas: ReplicaInfo, ps_names=frozenset(),
                     partitioned=frozenset(),
                     require_sparse: bool = False,
                     model_parallel=frozenset()) -> set:
    """The lookup tables that sync over the sparse (ids, values) wire, as
    the JAX lowering picks them
    (``autodist_tpu/kernel/graph_transformer.py:1141-1262``): trainable
    lookup-indexed variables that are host-PS (at every replica count:
    pairs beat a vocab-sized push) or, with more than one process, neither
    partitioned nor model-parallel; whose lookups carry their name
    (``ops.embedding.embedding_lookup(name=...)``); with no other
    differentiable use (a tied table stays dense); and whose gathered
    pairs — ids looked up a replica x replicas x (features + 1) —
    undercut the dense gradient (rows x features). The lookups are traced
    on fake tensors against one replica's shard of the example batch (its
    rows, and its chunk of a sequence leaf), the mesh axes unbound.
    A failed trace leaves every table dense with a warning, or raises
    under ``require_sparse`` (and ``ADT_IS_TESTING``); an unrouted
    candidate warns, or raises ``ValueError`` under ``require_sparse``."""
    N = replicas.num_processes
    candidates = {n for n, v in item.var_infos.items()
                  if v.sparse and v.trainable
                  and (n in ps_names or (N > 1 and n not in partitioned
                                         and n not in model_parallel))}
    if not candidates or item.example_batch is None:
        return set()
    loss = item.loss_fn
    if item.has_aux:
        loss = lambda p, b: item.loss_fn(p, b)[0]  # noqa: E731

    def local(path, leaf):
        shape = np.shape(leaf)
        if not shape:
            return leaf
        want = replicas.local_shape(shape, path_name(path))
        return leaf[tuple(slice(0, n) for n in want[:2])]
    routed, out = {}, set()
    try:
        routed, dense_uses = embedding.discover(
            loss, item.params,
            pytree.tree_map_with_path(local, item.example_batch),
            candidates)
        safe = embedding.safe_sparse_names(routed, dense_uses)
        tied = sorted(set(routed) - safe)
        if tied:
            logging.info("sparse vars %s have dense gradient paths besides "
                         "their lookups (tied embeddings); keeping them on "
                         "the dense sync path", tied)
        for n in sorted(safe):
            shape = item.var_infos[n].shape
            feat = max(1, int(np.prod(shape[1:] or (1,))))
            if sum(routed[n]) * N * (feat + 1) < int(shape[0]) * feat:
                out.add(n)
    except Exception as e:  # noqa: BLE001 — routing is best-effort
        if require_sparse or const.ENV.ADT_IS_TESTING.val:
            raise RuntimeError(
                "sparse-wire discovery failed and the strategy requires "
                "the sparse gradient path (vars: %s)" % sorted(candidates)
            ) from e
        logging.warning("sparse-wire discovery failed (%s); dense sync for "
                        "all sparse vars", e)
    uncaptured = sorted(candidates - set(routed))
    if uncaptured:
        if require_sparse:
            raise ValueError(
                "strategy requires the sparse gradient wire but vars %s are "
                "not routed through ops.embedding.embedding_lookup(name=...)"
                " — their gradients would sync DENSE (vocab-sized wire). "
                "Route the lookups through ops.embedding, or build with "
                "require_sparse=False." % uncaptured)
        logging.warning("sparse vars %s not routed through "
                        "ops.embedding.embedding_lookup(name=...); their "
                        "gradients sync DENSE (vocab-sized wire)", uncaptured)
    return out


def _cd_down(x):
    """The bf16 compute tier's cast into the loss: f32 tensors to bf16,
    anything else as it is."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
        return x.to(torch.bfloat16)
    return x


def _cd_up(x):
    """The tier's cast out of the loss: bf16 tensors back to f32."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
        return x.to(torch.float32)
    return x


class _OverlapRun:
    """One step's overlapped gradient sync (``graph_config.overlap``):
    a ``Tensor.register_hook`` on each trainable leaf records its
    gradient as the backward produces it (the hook fires under the
    ``torch.autograd.grad`` the step uses, where a post-accumulate hook
    would not), and each unit of the schedule launches its collective,
    asynchronously where it can, as soon as its last gradient is ready
    and every earlier stage has launched — so every rank issues the
    collectives in the schedule's order. :meth:`finish` launches what the
    backward left (variables with no gradient) and returns the launched
    units, which the step waits on before the apply. The units are the
    epilogue's, with its arithmetic, so the values are bit-identical to
    it."""

    def __init__(self, dstep, full, bucket_state, var_state):
        self._dstep = dstep
        self._stages = dstep.schedule.stages
        self._bucket_state, self._var_state = bucket_state, var_state
        self.ready: Dict[str, torch.Tensor] = {}
        self.launched = []
        # (unit, launched while the backward ran) in launch order
        self.log = []
        self._in_backward = True
        self._next = 0
        names = {n for st in self._stages for n in st.var_names}
        self._handles = [full[n].register_hook(self._hook(n))
                         for n in sorted(names)]

    def _hook(self, name):
        def hook(grad):
            # the gradient faults land before the sync, as in the epilogue
            self.ready[name] = self._dstep._fault_one(name, grad)
            self._advance()
        return hook

    def _advance(self):
        while self._next < len(self._stages):
            stage = self._stages[self._next]
            if not all(n in self.ready for n in stage.var_names):
                return
            for op in stage.ops:
                self.launched.append(self._dstep._launch_unit(
                    op.unit, self.ready, self._bucket_state,
                    self._var_state, async_op=True))
                self.log.append((op.unit, self._in_backward))
            self._next += 1

    def disarm(self):
        for h in self._handles:
            h.remove()
        self._handles = []

    def finish(self, grads):
        self._in_backward = False
        for n, g in grads.items():
            self.ready.setdefault(n, g)
        self._advance()
        return self.launched


class DistributedStep:
    """The executable plan on this process's device: parameter state init,
    the training step with its gradient sync, evaluation and the serving
    programs built from user functions."""

    def __init__(self, *, strategy: Strategy, model_item, device,
                 metadata: Optional[dict] = None,
                 replica_info: Optional[ReplicaInfo] = None,
                 sentinel=None):
        self.strategy = strategy
        self.model_item = model_item
        self.optimizer = model_item.optimizer_spec
        self.device = torch.device(device)
        self.metadata = metadata or {}
        self.replica_info = replica_info or ReplicaInfo()
        # the JAX lowering's N: every process (device) of the job; the
        # data replicas, which split the batch, are replica_info's
        self.num_replicas = self.replica_info.num_processes
        self.rank = self.replica_info.process_rank
        # the mesh of a TensorParallel or PipelineParallel plan, its
        # groups made here by every rank (parallel/mesh.py); None without
        # a mesh
        self.mesh = self.replica_info.mesh
        if self.mesh is not None and self.num_replicas > 1:
            # the batch axes' blocks too: the serving rows gather there
            self.mesh.build_groups(joint=[self.replica_info.batch_axes])
        # the data axis, where sharded storage (partitioned, ZeRO) lives:
        # its size and this rank's index on it (every process without a
        # mesh)
        self.n_data = self._mesh_axis_sizes().get(const.DATA_AXIS, 1)
        self.data_rank = (self.mesh.axis_index(const.DATA_AXIS)
                          if self.mesh is not None else self.rank)
        # host-resident PS variables (parallel/ps.py): their values and
        # optimizer state rest in the store, off the device state
        self.ps_plans: Dict[str, ps_lib.PSVarPlan] = {}
        self.ps_names = frozenset()
        self.ps_store: Optional[ps_lib.PSStore] = None
        # how many submitted pushes each recent training step's read of
        # the store lagged behind (at most the plan's staleness)
        self.ps_read_lags = collections.deque(maxlen=1024)
        self._ps_pushes = 0
        # the fused supersteps' device-resident PS carry: (values, each
        # variable's full little optimizer state), loaded at the first
        # superstep after a flush, written back at the next read of the
        # store (``_flush_ps_carry``)
        self._ps_carry = None
        self._ps_carry_dirty = False
        self._warned_partitioned_carry = False
        self._predict_progs: Dict[tuple, ForwardProgram] = {}
        self._decode_progs: Dict[tuple, ForwardProgram] = {}
        self.syncs: Dict[str, AllReduceSynchronizer] = {}
        # dispatches: a step, or a fused superstep of k microsteps
        self.dispatches = 0
        # set when the running dispatch begins to write its state in
        # place (the first optimizer apply), cleared when one starts: a
        # collective that fails before it leaves the state as it was, so
        # the in-run elastic plane may run the step again on a new world;
        # one that fails after it leaves the state torn
        # (``Runner._inrun_recover`` restores a checkpoint instead)
        self.writes_begun = False
        # the CUDA graphs of the fused supersteps, by (k, feed structure
        # and shapes), and the eager microsteps their captures ran first
        # to warm up
        self._graphs: Dict[tuple, object] = {}
        self.warmup_microsteps = 0
        gc = strategy.graph_config
        # the health sentinel's guards and the gradient fault plan, fixed
        # here as the JAX lowering fixes them at transform time
        self.guard = sentinel is not None and model_item.step_fn is None
        self._grad_norm_limit = (getattr(sentinel, "grad_norm_limit", None)
                                 if self.guard else None)
        self._grad_plan = (faultinject.GradFaultPlan.from_env()
                           if model_item.step_fn is None
                           else faultinject.GradFaultPlan())
        # the TrainState step on the device, which the gradient faults
        # read: set from the host step before each dispatch, advanced by
        # each microstep (also inside a captured superstep)
        self._step_t = (torch.zeros((), dtype=torch.int64,
                                    device=self.device)
                        if self._grad_plan.rules else None)
        # the resource spec's hosts of the ranks, for the hierarchical
        # schedule's groups (built with the synchronizers)
        self._replica_hosts = [r.split(":")[0] for r in gc.replicas]
        self.host_groups: Optional[mesh_lib.HostGroups] = None
        self.compute_dtype = gc.compute_dtype or "f32"
        self.remat = gc.remat
        self.buckets = []
        self._bucketed = set()
        self.sparse_wire = frozenset()
        # partitioned variables' layouts and the ZeRO-sharded variables'
        # kernels (N > 1 only: one replica has nothing to shard); the
        # model-parallel variables' layouts (a model axis of size > 1)
        self.layouts: Dict[str, VarLayout] = {}
        self.mp_layouts: Dict[str, VarLayout] = {}
        self.zero_syncs: Dict[str, ZeroSynchronizer] = {}
        self.schedule = None
        # the last overlapped step's launches: (unit, launched while the
        # backward ran), in launch order
        self.overlap_log = []
        if model_item.step_fn is None:
            self.ps_plans = ps_lib.plan_host_ps(strategy, model_item.var_infos)
            self.ps_names = frozenset(self.ps_plans)
            if self.ps_plans:
                self.ps_store = ps_lib.PSStore(
                    self.ps_plans, model_item.var_infos, self.optimizer,
                    self.device)
            zero_names = self._zero_nodes()
            layouts = VariablePartitioner.apply(
                strategy, model_item.var_infos, self.n_data,
                self._mesh_axis_sizes())
            self.mp_layouts = {n: lay for n, lay in layouts.items()
                               if lay.mp_axes}
            if self.num_replicas > 1:
                self.layouts = {n: lay for n, lay in layouts.items()
                                if lay.partitioned and n not in self.ps_names}
            self.sparse_wire = frozenset(sparse_wire_vars(
                model_item, self.replica_info, self.ps_names,
                frozenset(self.layouts), gc.require_sparse,
                frozenset(self.mp_layouts)))
            if self.num_replicas > 1:
                self._build_synchronizers(zero_names)
            self._make_losses()
            self._check_grad_plan()
        # sharded storage's share of the verdict's sums: a leaf sharded
        # over mesh axes of total size S is held by N/S ranks, so the sum
        # over the ranks of local * S/N is the global value (partitioned
        # and ZeRO storage: S is the data axis)
        data_frac = float(self.n_data) / self.num_replicas
        self._shard_frac = {n: data_frac for n in self.layouts}
        self._shard_frac.update({n: data_frac for n in self.zero_syncs})
        for n, lay in self.mp_layouts.items():
            self._shard_frac[n] = float(np.prod(
                [self.mesh.axis_size(a) for a in lay.mp_axis_names])
            ) / self.num_replicas
        self.metadata.update(self._plan_metadata())
        self._zero_rs_step = self.metadata.get("zero_rs_bytes_per_step", 0.0)
        self._zero_ag_step = self.metadata.get("zero_ag_bytes_per_step", 0.0)
        if self.metadata.get("zero_hbm_saved_bytes"):
            tel.gauge_set("zero.hbm_saved_bytes",
                          self.metadata["zero_hbm_saved_bytes"])
        if self.schedule is not None:
            tel.counter_add("overlap.buckets", self.schedule.num_stages)

    def _check_grad_plan(self):
        """The JAX lowering's warnings for a gradient fault plan."""
        plan = self._grad_plan
        if not plan.rules:
            return
        infos = self.model_item.var_infos
        unknown = sorted({r.var for r in plan.rules if r.var not in infos})
        if unknown:
            logging.warning("ADT_GRAD_FAULT_PLAN names unknown variables %s "
                            "— those rules never fire", unknown)
        on_wire = sorted({r.var for r in plan.rules
                          if r.var in self.sparse_wire})
        if on_wire:
            logging.warning(
                "ADT_GRAD_FAULT_PLAN targets sparse-wire vars %s: the fault "
                "lands on the (unused) dense gradient — route those vars "
                "dense to observe the fault", on_wire)
        logging.warning("gradient fault plan built into the step: %s",
                        plan.describe())

    def _fault_one(self, name, grad):
        """``grad`` of variable ``name`` with the fault plan applied at
        the device step (itself without a plan)."""
        if self._step_t is None:
            return grad
        return faultinject.apply_grad_faults(
            self._grad_plan, self._step_t, {name: grad})[name]

    def _set_step(self, step) -> None:
        """Put the host step on the device for the gradient faults (a fill
        kernel, no read back)."""
        if self._step_t is not None:
            self._step_t.fill_(int(step))

    def _mesh_axis_sizes(self) -> dict:
        """``{axis: size}`` of the plan's mesh: the data axis alone (every
        process) without one."""
        if self.mesh is not None:
            return dict(self.mesh.axes)
        return {const.DATA_AXIS: self.num_replicas}

    def _data_group(self, mesh=None, group=None):
        """The data axis's group on ``mesh`` (this plan's when None; a
        data axis over every process takes the mesh's full group);
        ``group`` (None: the default group) without a mesh or a data axis
        of more than one rank."""
        mesh = mesh if mesh is not None else self.mesh
        if mesh is None or self.n_data <= 1:
            return group
        return mesh.group(const.DATA_AXIS)

    def _extra_groups(self) -> list:
        """The groups of the mesh's axes of size > 1 other than the data
        axis, in the mesh's order: sharded storage's gradient sums over
        them after the data axis's reduce-scatter."""
        if self.mesh is None:
            return []
        return [self.mesh.group(a) for a, n in self.mesh.axes.items()
                if a != const.DATA_AXIS and n > 1]

    def _zero_stride(self) -> int:
        """The data axis's row stride in the ``[N, ...]`` rows of a
        gathered sync state: the product of the axes after it (the JAX
        ``leading_stride``)."""
        if self.mesh is None:
            return 1
        axes = list(self.mesh.axes)
        after = axes[axes.index(const.DATA_AXIS) + 1:] \
            if const.DATA_AXIS in axes else []
        return int(np.prod([self.mesh.axes[a] for a in after] or [1]))

    def _zero_nodes(self) -> list:
        """The trainable variables a ZeroSharded synchronizer names; the
        combinations the JAX lowering refuses (ADT312) raise here with its
        messages, at every replica count."""
        out = []
        for node in self.strategy.node_config:
            cfg = node.synchronizer
            if cfg is None or getattr(cfg, "kind", "") != "ZeroSharded":
                continue
            info = self.model_item.var_infos.get(node.var_name)
            if info is None or not info.trainable:
                continue
            if info.sparse:
                raise ValueError(
                    "var %s: ZeroSharded on a sparse (gather-indexed) "
                    "variable — the reduce-scatter would densify its "
                    "batch-row-sized gradient to the full table every "
                    "step (ADT312); route it to PS or plain AllReduce"
                    % node.var_name)
            if node.mp_axes or node.partitioner:
                raise ValueError(
                    "var %s: ZeroSharded cannot combine with %s storage "
                    "(ADT312) — the sharded update owns the whole flat "
                    "variable" % (node.var_name,
                                  "mp_axes" if node.mp_axes
                                  else "partitioner"))
            if self.n_data <= 1:
                # one data replica: nothing to shard; the node syncs by
                # the plain mean all-reduce (_build_synchronizers)
                logging.info("var %s: ZeroSharded on a single data replica "
                             "degrades to plain AllReduce sync",
                             node.var_name)
                continue
            out.append(node.var_name)
        return out

    def _build_synchronizers(self, zero_names):
        """Per-variable synchronizer kernels from the node configs (the
        JAX ``_build_synchronizers``): the ZeRO kernels, the per-variable
        AllReduce kernels (a partitioned variable's reduce-scatters), the
        proxied PS variables' mean all-reduce (``PSSynchronizer``) and
        the buckets of the concatable compressed unpartitioned AllReduce
        variables (``make_buckets``); with ``overlap=True`` the schedule
        of those units. NoneCompressor variables all-reduce one by one;
        the host-PS variables and the sparse-wire tables keep out of all
        of them, as in the JAX lowering."""
        N, item = self.num_replicas, self.model_item
        data_group, extra = self._data_group(), self._extra_groups()
        for n in zero_names:
            info = item.var_infos[n]
            self.zero_syncs[n] = ZeroSynchronizer(
                n, self.strategy.find(n).synchronizer, info.shape,
                info.dtype, self.n_data, self.data_rank, N,
                collective_name=info.collective_name,
                process_group=data_group, extra_groups=extra,
                leading_stride=self._zero_stride())
        for node in self.strategy.node_config:
            info = item.var_infos.get(node.var_name)
            if (info is None or not info.trainable
                    or node.var_name in self.sparse_wire
                    or node.var_name in self.ps_names
                    or node.var_name in self.zero_syncs):
                continue
            if node.var_name in self.mp_layouts:
                # model-parallel vars sync by the complement-axes sum in
                # the step (_mp_sync), not a synchronizer kernel; a
                # configured compressor cannot apply to them
                comp = getattr(node.synchronizer, "compressor",
                               "NoneCompressor")
                if comp != "NoneCompressor":
                    logging.warning(
                        "var %s: compressor %s ignored — model-parallel "
                        "(mp_axes) gradients reduce uncompressed over the "
                        "complement axes", node.var_name, comp)
                continue
            cfg = node.synchronizer
            if cfg is None and node.part_configs:
                cfg = node.part_configs[0].synchronizer
            if cfg is None:
                raise ValueError("no synchronizer for var %s"
                                 % node.var_name)
            if cfg.kind == "ZeroSharded":
                # one data replica (_zero_nodes): the plain mean
                # all-reduce is the same update with nothing to shard
                from autodist_tpu_torch.strategy.base import \
                    AllReduceSynchronizer as ARConfig
                cfg = ARConfig()
            kernel = (PSSynchronizer if cfg.kind == "PS"
                      else AllReduceSynchronizer)
            self.syncs[node.var_name] = kernel(
                node.var_name, cfg, N,
                collective_name=info.collective_name,
                layout=self.layouts.get(node.var_name),
                data_group=data_group, n_data=self.n_data,
                extra_groups=extra)
            if kernel is AllReduceSynchronizer and \
                    self._wants_hier(cfg.spec, cfg.schedule):
                self.syncs[node.var_name].host_groups = self._host_groups()
        compressed = {n: s for n, s in self.syncs.items()
                      if s.compressor.name != "NoneCompressor"
                      and n not in self.layouts}
        self.buckets, _ = collectives.make_buckets(compressed,
                                                   item.var_infos)
        self._bucketed = {n for b in self.buckets for n in b.var_names}
        self._bucket_by_key = {b.key: b for b in self.buckets}
        for b in self.buckets:
            if self._wants_hier(b.spec, b.schedule):
                self._host_groups()
        # one data axis: the default group, all N ranks
        self._ring_axes = ((None, N),)
        overlap = bool(self.strategy.graph_config.overlap)
        store = self.ps_store
        if overlap and store is not None and (
                store.max_staleness() > 0 or store.any_async()):
            # a stale or async PS wire is already decoupled from the step:
            # ordering the collectives against it would pin the schedule
            # to the slowest (host) path
            logging.warning(
                "overlap disarmed: stale/async host-PS plan — the PS wire "
                "is already decoupled from the step; remove staleness/"
                "async or drop overlap to silence this")
            overlap = False
        if overlap:
            self.schedule = collectives.build_grad_sync_schedule(
                self._units(), {n: i for i, n in enumerate(item.var_infos)})

    @staticmethod
    def _wants_hier(spec, schedule) -> bool:
        return (spec or "") == "DCN" or (schedule or "auto") == "hier"

    def _host_groups(self):
        """The intra-host and inter-host groups of the hierarchical
        schedule over the resource spec's hosts, made once, by every rank
        in one order (None when the ranks sit on one host)."""
        if self.host_groups is None and len(set(self._replica_hosts)) > 1:
            self.host_groups = mesh_lib.HostGroups(self._replica_hosts,
                                                   self.rank)
        return self.host_groups

    def _bucket_psum(self, bucket):
        """The sum a bucket's reduce goes through: the schedule the
        bucket's synchronizers name (the JAX ``_run_bucket``): the
        hierarchical psum for ``spec="DCN"`` or ``schedule="hier"`` across
        hosts, ``rhd`` as reduce-scatter + all-gather, else the ring."""
        hg = self.host_groups
        if self._wants_hier(bucket.spec, bucket.schedule) and hg is not None:
            return lambda x: collectives.hierarchical_psum(x, hg)
        if (bucket.schedule or "auto") == "rhd":
            return lambda x: collectives.rhd_psum(x, None,
                                                  self.num_replicas)
        return self._psum

    def _units(self):
        """The sync units as the JAX lowering lists them for its schedule:
        ``(unit, kind, variables, elements, wire, axes)``."""
        axes = ("data",)
        units = [("bucket:" + b.key, "reduce", tuple(b.var_names),
                  b.total_size,
                  "int8" if b.compressor_name.startswith("Int8")
                  else "fp32", axes) for b in self.buckets]
        infos = self.model_item.var_infos
        units += [("var:" + n, "reduce", (n,), infos[n].num_elements,
                   "fp32", axes) for n in sorted(self.syncs)
                  if n not in self._bucketed]
        units += [("zero:" + n, "reduce_scatter", (n,),
                   infos[n].num_elements, zs.wire_dtype, axes)
                  for n, zs in sorted(self.zero_syncs.items())]
        return units

    def _epilogue_units(self):
        """The units in the epilogue's order: the ZeRO reduce-scatters,
        the buckets, then the per-variable syncs."""
        return (["zero:" + n for n in sorted(self.zero_syncs)]
                + ["bucket:" + b.key for b in self.buckets]
                + ["var:" + n for n in self.syncs if n not in self._bucketed])

    def _plan_metadata(self) -> dict:
        """The JAX lowering's metadata keys for what this plan lowered."""
        item = self.model_item
        infos = item.var_infos
        zero_saved = 0.0
        if self.zero_syncs and self.optimizer is not None:
            # the optimizer's state: a 4-byte count where it keeps one and
            # an f32 slot a variable for each of its slots
            opt_total = 4.0 * self.optimizer.has_count + \
                4.0 * len(self.optimizer.slots) * sum(
                    i.num_elements for i in infos.values())
            params_total = float(item.total_bytes()) or 1.0
            N = self.n_data
            zero_saved = sum(opt_total * infos[n].byte_size / params_total
                             * (N - 1) / N for n in self.zero_syncs)
        sched = self.schedule
        proxied = {n: s.reduction_destination for n, s in self.syncs.items()
                   if isinstance(s, PSSynchronizer)}
        ps_cfgs = [p for n in self.strategy.node_config
                   for p in ([n.synchronizer] + [q.synchronizer for q in
                                                 n.part_configs or ()])
                   if p is not None and p.kind == "PS"]
        return {
            # proxied PS vars keep one destination; host-resident plans
            # carry one owner a shard
            "ps_assignments": dict(
                proxied, **{n: list(p.destinations)
                            for n, p in self.ps_plans.items()}),
            "ps_host_resident": sorted(self.ps_names),
            "ps_wire_int8": (self.ps_store.wire_quant
                             if self.ps_store is not None else []),
            # the staleness window of the Runner's cross-process pacing
            "staleness": max([c.staleness for c in ps_cfgs], default=0),
            "async": any(not c.sync for c in ps_cfgs),
            "sparse_wire": sorted(self.sparse_wire),
            "mesh": dict(self.mesh.axes) if self.mesh is not None else None,
            "model_parallel": sorted(self.mp_layouts),
            "buckets": [b.key for b in self.buckets],
            "partitioned": sorted(self.layouts),
            "zero_sharded": sorted(self.zero_syncs),
            "zero_wire_int8": sorted(n for n, zs in self.zero_syncs.items()
                                     if zs.wire_dtype == "int8"),
            "zero_rs_bytes_per_step": sum(
                zs.rs_payload_bytes() for zs in self.zero_syncs.values()),
            "zero_ag_bytes_per_step": sum(
                zs.ag_payload_bytes() for zs in self.zero_syncs.values()),
            "zero_hbm_saved_bytes": zero_saved,
            "compute_dtype": self.compute_dtype,
            "remat": self.remat,
            "overlap": sched is not None,
            "overlap_requested": bool(self.strategy.graph_config.overlap),
            "overlap_stages": sched.num_stages if sched is not None else 0,
            "overlap_schedule": sched.describe() if sched is not None
            else "",
            # health guards built into the step? (the ADT420 lint and the
            # Runner's policy read it; savers gate a multi-process veto)
            "sentinel_guards": self.guard,
            "grad_fault_plan": self._grad_plan.describe(),
        }

    def _make_losses(self):
        """The loss the step differentiates and the one ``evaluate``
        runs: the user's loss under the compute tier (the JAX
        ``loss_fn_cd``), and that under the remat policy."""
        item = self.model_item
        if item.loss_fn is None:
            self._loss_cd = self._loss_grad = None
            return
        fn, has_aux = item.loss_fn, item.has_aux
        if self.compute_dtype == "bf16":
            def loss_cd(params, batch):
                out = fn(pytree.tree_map(_cd_down, params),
                         pytree.tree_map(_cd_down, batch))
                if has_aux:
                    loss, aux = out
                    return _cd_up(loss), pytree.tree_map(_cd_up, aux)
                return _cd_up(out)
        elif self.compute_dtype == "f32":
            loss_cd = fn
        else:
            raise ValueError("compute_dtype must be 'f32' or 'bf16', got %r"
                             % (self.compute_dtype,))
        self._loss_cd = loss_cd
        self._loss_grad = loss_cd
        if self.remat:
            from autodist_tpu_torch.strategy.remat import remat_transform
            self._loss_grad = remat_transform(self.remat)(loss_cd)

    def _slots(self):
        """The optimizer state's per-variable fields (none without an
        optimizer)."""
        return self.optimizer.slots if self.optimizer is not None else ()

    def _sync_state_init(self) -> dict:
        """Compressor states and the ZeRO variables' optimizer-state shards
        on the device, one copy per rank (the JAX ``sync_state_init``
        without its leading device axis)."""
        st = {"bucket": {}, "var": {}, "zero": {}}
        for b in self.buckets:
            s = b.make_compressor().state_init((b.total_size,), b.dtype)
            if s is not None:
                st["bucket"][b.key] = s.to(self.device)
        for n, s in self.syncs.items():
            if n in self._bucketed:
                continue
            info = self.model_item.var_infos[n]
            init = s.state_init(tuple(info.shape), info.dtype)
            if init is not None:
                st["var"][n] = pytree.tree_map(
                    lambda t: t.to(self.device), init)
        if self.optimizer is not None:
            for n, zs in sorted(self.zero_syncs.items()):
                st["zero"][n] = zs.opt_state_init(self.optimizer,
                                                  self.device)
        if self.guard:
            # the sentinel's effective-LR scale: state, not a rebuild, so
            # halving it is an edit of the state (checkpoints keep it)
            st["sentinel"] = {"lr_scale": torch.ones(
                (), dtype=torch.float32, device=self.device)}
        return {k: v for k, v in st.items() if v}

    @staticmethod
    def _psum(x):
        return all_reduce_sum(x)

    def _broadcast(self, tree):
        """Rank 0's values in every replica: the counterpart of placing a
        replicated value on the mesh."""
        for t in pytree.tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                dist.broadcast(t, src=0)

    def init_state(self, params, opt_state=None,
                   sync_state=None) -> TrainState:
        """Place ``params`` (``{name: tensor or numpy}``) on the device as
        float32 masters — the JAX package keeps f32 params and casts at
        compute (flax ``param_dtype``), and so does the port — and create
        the optimizer state beside them (or place the given
        ``opt_state``). ``params`` and ``opt_state`` come in the original
        full layout (a checkpoint's). The state owns copies: the step
        updates them in place and the caller's tensors never move. With
        more than one replica, every replica takes rank 0's params and
        optimizer state and keeps its own shard of each partitioned
        variable and of its optimizer slots. The host-PS variables and
        their slots go to the store (every rank's mirror takes rank 0's),
        and out of the device state; a fused carry is dropped. A
        ZeRO-sharded variable's slots
        live in ``sync_state['zero']``, this rank's flat shard of them
        (from a given ``opt_state`` when the ``sync_state`` has none).
        Each replica takes its own compressor state: row r of a given
        ``sync_state`` (the gathered ``[N, ...]`` tree a checkpoint
        holds, :meth:`gather_sync_state`) for rank r, or a fresh one. A
        ``sync_state`` whose tree does not fit this plan is replaced by a
        fresh one, with a warning."""
        if self.model_item.step_fn is not None:
            return self._init_user_state(params)
        missing = set(self.model_item.var_infos) - set(params)
        if missing:
            raise ValueError("init params lack variables %s"
                             % sorted(missing))
        placed = {}
        for name, value in params.items():
            t = torch.as_tensor(value)
            placed[name] = t.to(self.device,
                                torch.float32 if t.is_floating_point()
                                else t.dtype, copy=True).contiguous()
        if self.num_replicas > 1:
            self._broadcast(placed)
        if opt_state is not None:
            opt_state = pytree.tree_map(
                lambda t: (t.to(self.device, copy=True)
                           if isinstance(t, torch.Tensor) else t), opt_state)
            if self.num_replicas > 1:
                self._broadcast(opt_state)
        if self.ps_store is not None:
            # the store's contents are replaced: a staged pull is stale
            self.invalidate_ps()
            self.ps_store.init_params(placed)
            for n in self.ps_names:
                del placed[n]
            if opt_state is not None:
                self.ps_store.load_opt_from_full(opt_state)
                opt_state = dict(opt_state)
                for slot in self._slots():
                    opt_state[slot] = {n: t for n, t in opt_state[slot].items()
                                       if n not in self.ps_names}
        zero_full = {}
        if opt_state is not None and self.zero_syncs:
            # a ZeRO variable has no slot in the device optimizer tree
            opt_state = dict(opt_state)
            for slot in self._slots():
                opt_state[slot] = dict(opt_state[slot])
                for n in self.zero_syncs:
                    zero_full.setdefault(n, {})[slot] = \
                        opt_state[slot].pop(n)
        if opt_state is None and self.optimizer is not None:
            opt_state = self.optimizer.init(
                {n: t for n, t in placed.items() if n not in self.zero_syncs})
            if "count" in opt_state:
                # the count lives on the device even when every variable
                # is host-resident
                opt_state["count"] = opt_state["count"].to(self.device)
        # a partitioned variable keeps its data index's shard
        rank, N = self.data_rank, self.n_data
        for n, lay in self.layouts.items():
            placed[n] = lay.local(placed[n], rank, N)
            for slot in self._slots():
                if opt_state is not None and n in opt_state.get(slot, {}):
                    opt_state[slot][n] = lay.local(opt_state[slot][n],
                                                   rank, N)
        # each model-parallel variable keeps this rank's slice of the
        # host-global value, and so do its slots (the JAX package's
        # make_array_from_callback over the same global value)
        for n, lay in self.mp_layouts.items():
            placed[n] = lay.mp_local(placed[n], self.mesh)
            for slot in self._slots():
                if opt_state is not None and n in opt_state.get(slot, {}):
                    opt_state[slot][n] = lay.mp_local(opt_state[slot][n],
                                                      self.mesh)
        sync = self._sync_state_init()
        own = None
        if sync_state is not None:
            own = self._own_row(sync_state, sync)
        if own is not None:
            sync = own
        if zero_full:
            # the full moments re-shard exactly, whatever mesh the saved
            # rows were laid out on (a plain checkpoint does not say)
            for n, zs in self.zero_syncs.items():
                little = sync["zero"][n]
                if "count" in little:
                    little["count"].copy_(opt_state["count"])
                for slot in self._slots():
                    little[slot]["v"].copy_(zs.local_shard(zero_full[n][slot]))
        return TrainState(step=0, params=placed, opt_state=opt_state,
                          sync_state=sync)

    def _init_user_state(self, state) -> TrainState:
        """step_fn mode: the user's state tree on the device, each leaf a
        copy in its own dtype (the opaque step owns its optimizer, so
        there is no optimizer or compressor state beside it)."""
        from autodist_tpu_torch.model_item import flatten_state, unflatten_state
        want = [n for n, _ in flatten_state(self.model_item.params)]
        leaves = dict(flatten_state(state))
        if sorted(leaves) != sorted(want):
            raise ValueError("init state leaves %s do not match the state "
                             "template's %s" % (sorted(leaves), sorted(want)))
        placed = {n: torch.as_tensor(v).to(self.device, copy=True)
                  for n, v in leaves.items()}
        return TrainState(step=0, params=unflatten_state(
            self.model_item.params, placed), opt_state={}, sync_state={})

    def _own_row(self, gathered, fresh):
        """This rank's row of a gathered ``[N, ...]`` sync-state tree, on
        the device; None when the tree does not fit this plan (other
        buckets or synchronizers, another replica count). A ZeRO
        variable's shards saved at another replica count are re-laid for
        this one, the saved rows taken as data shards
        (``relayout_zero_sync_leaf``; :meth:`init_state` re-shards the
        full moments instead where it has them)."""
        from autodist_tpu_torch.kernel.synchronization.zero_synchronizer \
            import relayout_zero_sync_leaf
        if "sentinel" in fresh or "sentinel" in gathered:
            # the sentinel's scale is judged apart from the compressor
            # and ZeRO state: a checkpoint of an unguarded run keeps its
            # ZeRO shards under a guarded one (the scale starts at 1)
            rest = self._own_row(
                {k: v for k, v in gathered.items() if k != "sentinel"},
                {k: v for k, v in fresh.items() if k != "sentinel"})
            if rest is None:
                return None
            if "sentinel" in fresh:
                rest["sentinel"] = fresh["sentinel"]
                scale = gathered.get("sentinel", {}).get("lr_scale")
                if scale is not None:
                    fresh["sentinel"]["lr_scale"].fill_(
                        float(torch.as_tensor(scale).reshape(-1)[0]))
            return rest
        got, want = _named_leaves(gathered), _named_leaves(fresh)
        N = self.num_replicas
        if got.keys() == want.keys():
            for k, w in want.items():
                n_old = int(got[k].shape[0]) if got[k].dim() else 0
                if not k.startswith("zero/") or n_old in (0, N):
                    continue
                zs = self.zero_syncs[k.split("/")[1]]
                laid = relayout_zero_sync_leaf(got[k].cpu().numpy(), n_old,
                                               zs, N)
                if laid is not None:
                    got[k] = torch.from_numpy(laid)
        fits = got.keys() == want.keys() and all(
            tuple(got[k].shape) == (N,) + tuple(w.shape)
            for k, w in want.items())
        if not fits:
            logging.warning(
                "sync state in checkpoint incompatible with the current "
                "strategy (%d replicas, buckets %s); reinitializing",
                N, sorted(fresh.get("bucket", {})))
            return None
        rank = self.rank
        return _map_named(lambda k, w: got[k][rank].to(
            self.device, w.dtype, copy=True), fresh)

    def _full_params(self, params, group=None, mesh=None) -> dict:
        """The params with each partitioned variable all-gathered whole
        (its storage holds its data index's shard) over the data axis's
        group (:meth:`_data_group` of ``mesh`` and ``group``)."""
        if not self.layouts:
            return params
        full = dict(params)
        data = self._data_group(mesh, group)
        for n, lay in self.layouts.items():
            full[n] = lay.gather_full(params[n], data, self.n_data)
        return full

    def _loss(self, params, batch, grad: bool = False):
        if self.model_item.loss_fn is None:
            raise ValueError("this runner lowers an opaque step_fn, which "
                             "has no loss to evaluate: use loss_fn mode "
                             "(AutoDist.build)")
        out = (self._loss_grad if grad else self._loss_cd)(params, batch)
        if self.model_item.has_aux:
            return out
        return out, None

    def _metrics(self, loss, aux):
        """``{"loss": ..., "aux": ...}``; with more than one replica the
        mean over the replicas (floats; the max for integers), as the
        JAX step's pmean/pmax, so every rank returns the same values."""
        def reduce(a):
            if not isinstance(a, torch.Tensor):
                return a
            a = a.detach()
            if self.num_replicas == 1:
                return a
            if a.is_floating_point():
                return (self._psum(a.reshape(-1)) / self.num_replicas
                        ).reshape(a.shape)
            out = a.reshape(-1).clone()
            dist.all_reduce(out, op=dist.ReduceOp.MAX)
            return out.reshape(a.shape)
        metrics = {"loss": reduce(loss)}
        if aux is not None:
            metrics["aux"] = pytree.tree_map(reduce, aux)
        return metrics

    def _launch_unit(self, unit: str, grads, bucket_state, var_state,
                     async_op: bool = False):
        """Issue one sync unit's collective (``bucket:<key>``,
        ``var:<name>`` or ``zero:<name>``): a ``collectives.Pending`` of
        (its synced gradients by name, its new compressor state as
        ``(kind, key, state)`` or None). The epilogue waits on each
        launch at once; the overlapped schedule launches from backward
        hooks and waits before the apply — the same arithmetic either
        way."""
        kind, _, name = unit.partition(":")
        if kind == "bucket":
            b = self._bucket_by_key[name]
            out, nst = collectives.bucket_reduce(
                b, grads, bucket_state.get(b.key), self._bucket_psum(b),
                self.num_replicas, ring_axes=self._ring_axes)
            return collectives.done((out, ("bucket", b.key, nst)))
        if kind == "zero":
            pending = self.zero_syncs[name].reduce_scatter_launch(
                grads[name], async_op)
            return collectives.Pending((), lambda: (
                {name: pending.wait()}, None))
        pending = self.syncs[name].launch(grads[name], var_state.get(name),
                                          async_op)

        def finish():
            synced, nst = pending.wait()
            return {name: synced}, ("var", name, nst)
        return collectives.Pending((), finish)

    def _mp_sync(self, name, grad):
        """A model-parallel variable's gradient sync (the JAX lowering's):
        the sum over the groups of the mesh axes it is not sharded over,
        divided by N, every process. Its backward summed the cotangents
        over the model axis (``parallel/tensor.py``) and the pipe axis
        (``parallel/pipeline.py``'s broadcast of the last stage), so the
        /N over all devices, not over the data replicas, gives the
        mean."""
        sharded = set(self.mp_layouts[name].mp_axis_names)
        for axis, size in self.mesh.axes.items():
            if axis not in sharded and size > 1:
                grad = all_reduce_sum(grad, self.mesh.group(axis))
        return grad / self.num_replicas

    def _sync_grads(self, grads, sync_state, pairs, overlap=None):
        """The JAX ``local_step`` gradient sync over N > 1 replicas: the
        sync units (:meth:`_launch_unit`) — launched here one after the
        other as the epilogue, or already launched by the overlapped
        schedule (``overlap``, an :class:`_OverlapRun`), then waited on
        in order — and the AllReduce sparse-wire tables' gathered
        ``pairs`` scatter-added into their gradient; returns the synced
        gradients (a partitioned or ZeRO variable's: this rank's shard)
        and the new ``sync_state``."""
        N = self.num_replicas
        new_state = {"bucket": dict(sync_state.get("bucket", {})),
                     "var": dict(sync_state.get("var", {}))}
        if overlap is not None:
            launched = overlap.finish(grads)
        else:
            launched = [self._launch_unit(u, grads, new_state["bucket"],
                                          new_state["var"])
                        for u in self._epilogue_units()]
        synced = {}
        for pending in launched:
            out, nst = pending.wait()
            synced.update(out)
            if nst is not None and nst[2] is not None:
                new_state[nst[0]][nst[1]] = nst[2]
        for n in sorted(self.mp_layouts):
            if n in grads:
                synced[n] = self._mp_sync(n, grads[n])
        # the AllReduce sparse-wire tables: their gathered (ids, values)
        # pairs densified after the wire
        infos = self.model_item.var_infos
        for n in sorted(self.sparse_wire - self.ps_names):
            ids, vals = pairs[n]
            synced[n] = embedding.scatter_add_dense(
                ids, vals, int(infos[n].shape[0]),
                tuple(infos[n].shape[1:]))
        new_sync = dict(sync_state)
        for key, value in new_state.items():
            if value:
                new_sync[key] = value
        return synced, new_sync

    def _step(self, state: TrainState, batch, carry=None):
        """One microstep on ``state``, with no span and no dispatch count:
        ``(new_state, metrics)`` (:meth:`_train`). With host-PS variables,
        ``carry`` is the fused supersteps' ``(values, optimizer states)``
        on the device, which the microstep reads through the emulated
        wire and updates in place (:meth:`_ps_carry_microstep`). In
        step_fn mode the user's ``step_fn(state, batch) -> (new_state,
        metrics)`` as given (its metrics detached). Nothing here reads a
        value back to the host, so a CUDA graph can hold it
        (:mod:`~autodist_tpu_torch.kernel.superstep`)."""
        if carry is not None:
            return self._ps_carry_microstep(state, batch, *carry)
        item = self.model_item
        if item.step_fn is not None:
            self.writes_begun = True  # the opaque step writes where it will
            with torch.enable_grad():
                new_user, metrics = _step_fn_output(
                    item.step_fn(state.params, batch), item.params)
            return TrainState(step=state.step + 1, params=new_user,
                              opt_state=state.opt_state,
                              sync_state=state.sync_state), \
                pytree.tree_map(_detach, metrics)
        new_state, _, metrics = self._train(state, batch, {})
        return new_state, metrics

    def _train(self, state: TrainState, batch, ps_vals):
        """One loss_fn-mode microstep: ``(new_state, ps_grads, metrics)``.
        The loss (under the compute tier and remat) on the full params —
        the device state's with the pulled host-PS values ``ps_vals`` —
        and the gradients: dense ones of the trainable variables, and,
        for the sparse-wire tables, those of the lookups' taps, flattened
        into (ids, values) pairs (all-gathered over the ranks at N > 1,
        divided by N). With more than one replica the device gradients'
        sync (:meth:`_sync_grads`); the optimizer apply on the device
        variables, in place on ``state``'s tensors. ``ps_grads`` holds
        each host-PS variable's mean gradient for the store: its pairs, or
        the dense gradient (all-reduced at N > 1), in the int8 wire
        container where the plan says so."""
        item = self.model_item
        N = self.num_replicas
        trainable = item.trainable_var_names
        full = dict(self._full_params(state.params))
        full.update(self._ps_dewire(ps_vals))
        dense_wrt = [n for n in trainable if n not in self.sparse_wire]
        for n in dense_wrt:
            full[n] = full[n].detach().requires_grad_()
        sync_state = state.sync_state
        overlap = None
        if self.schedule is not None:
            overlap = _OverlapRun(self, full,
                                  dict(sync_state.get("bucket", {})),
                                  dict(sync_state.get("var", {})))
        wire = sorted(self.sparse_wire)
        try:
            # the model-parallel axes are bound while the loss and its
            # backward run (the JAX step's shard_map scope)
            with torch.enable_grad(), mesh_lib.bind(self.mesh):
                with embedding.capture(wire) as cap:
                    loss, aux = self._loss(full, batch, grad=True)
                inputs = [full[n] for n in dense_wrt] + \
                    embedding.make_taps(cap, wire)
                out = torch.autograd.grad(loss, inputs, allow_unused=True) \
                    if inputs else ()
        finally:
            if overlap is not None:
                overlap.disarm()
                self.overlap_log = overlap.log
        grads = {n: (g if g is not None else torch.zeros_like(full[n]))
                 for n, g in zip(dense_wrt, out)}
        if self._step_t is not None:
            # chaos: the LOCAL gradients corrupted before the sync, so NaN
            # spreads through the all-reduce as a real fault would
            grads = faultinject.apply_grad_faults(self._grad_plan,
                                                  self._step_t, grads)
        tap_grads = list(out[len(dense_wrt):])
        pairs = {}
        with torch.no_grad():
            for n in wire:
                k = len(cap.taps.get(n, []))
                got = [g if g is not None else torch.zeros_like(t)
                       for g, t in zip(tap_grads[:k], cap.taps.get(n, []))]
                del tap_grads[:k]
                ids, vals = embedding.flatten_pairs(cap.ids.get(n, []), got)
                if N > 1:
                    ids, vals = embedding.gather_pairs(ids, vals, N)
                pairs[n] = (ids, vals / N)
            ps_grads = {}
            quant = set(self.ps_store.wire_quant) if self.ps_store else set()
            for n in sorted(self.ps_names):
                if n in pairs:
                    ps_grads[n] = pairs[n]
                elif N == 1:
                    ps_grads[n] = grads[n]
                else:
                    ps_grads[n] = self._psum(grads[n]) / N
                if n in quant:
                    # quantized on the device, in the JAX element order:
                    # the push's copy carries int8 and scales, dequantized
                    # at the store
                    ps_grads[n] = collectives.quant_wire(to_jax_layout(
                        ps_grads[n], item.var_infos[n].collective_name))
            device_grads = {n: g for n, g in grads.items()
                            if n not in self.ps_names}
            old_sync = state.sync_state
            if N > 1:
                with tel.span("dstep.grad_sync", "dstep",
                              overlap=overlap is not None):
                    device_grads, sync_state = self._sync_grads(
                        device_grads, sync_state, pairs, overlap)
            metrics = self._metrics(loss, aux)
            scale = snap = None
            if self.guard:
                # the update writes in place: keep the values it may have
                # to give back (the compressor states are new tensors)
                scale = sync_state["sentinel"]["lr_scale"]
                snap = _clone((state.params, state.opt_state,
                               sync_state.get("zero", {})))
            # every collective before this point left the state as it was
            self.writes_begun = True
            opt_state = self.optimizer.update(
                {n: g for n, g in device_grads.items()
                 if n not in self.zero_syncs},
                state.opt_state, state.params, scale=scale)
            if self.zero_syncs:
                self._zero_apply(device_grads, state.params, sync_state,
                                 scale)
            if self.guard:
                verdict = self._health_verdict(device_grads, ps_grads,
                                               state.params, metrics["loss"])
                metrics["sentinel"] = verdict
                # a bad verdict discards the whole update, on the device
                okb = verdict["ok"].bool()
                _select(okb, state.params, snap[0])
                _select(okb, opt_state, snap[1])
                _select(okb, sync_state.get("zero", {}), snap[2])
                for key in ("bucket", "var"):
                    _select(okb, sync_state.get(key, {}),
                            old_sync.get(key, {}))
            if self._step_t is not None:
                self._step_t.add_(1)
        return TrainState(step=state.step + 1, params=state.params,
                          opt_state=opt_state, sync_state=sync_state), \
            ps_grads, metrics

    def _health_verdict(self, synced, ps_grads, new_params, loss):
        """The sentinel's verdict on one microstep (the JAX
        ``_health_verdict``): ``{"ok", "grad_norm", "bad_grads",
        "bad_params"}`` as 0-d tensors on the device. Replicated gradients
        are already global on every rank; sharded ones (partitioned, ZeRO,
        model-parallel) add ``local * S/N`` through ONE stacked all-reduce,
        so a plan with no sharded storage pays no collective. Every input
        is the same on every rank, so every rank takes the same
        branch."""
        infos = self.model_item.var_infos
        frac = self._shard_frac
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        local_g, shared_g, shared_p = [], {}, {}
        for n in sorted(synced):
            v = synced[n]
            if not v.is_floating_point():
                continue
            f = frac.get(n)
            (local_g if f is None else shared_g.setdefault(f, [])).append(v)
        for n in sorted(ps_grads):
            gv = ps_grads[n]
            if isinstance(gv, dict):
                # the wire-quantized gradient judged by its dequantized
                # image (what the store applies); a NaN poisons its block
                # scales, so the count still fires
                gv = collectives.dequant_wire(gv, (infos[n].num_elements,))
            elif isinstance(gv, tuple):
                gv = gv[1]
            local_g.append(gv)
        local_p = []
        for n in sorted(new_params):
            t = new_params[n]
            if not t.is_floating_point():
                continue
            f = frac.get(n)
            (local_p if f is None else shared_p.setdefault(f, [])).append(t)
        sq, bad_g = _health_stats(local_g)
        _, bad_p = _health_stats(local_p)
        sq = zero if sq is None else sq
        bad_g = zero if bad_g is None else bad_g
        bad_p = zero if bad_p is None else bad_p
        if shared_g or shared_p:
            red = [zero, zero, zero]
            for f, ts in shared_g.items():
                s_sq, s_bad = _health_stats(ts)
                red[0] = red[0] + s_sq * f
                red[1] = red[1] + s_bad * f
            for f, ts in shared_p.items():
                red[2] = red[2] + _health_stats(ts)[1] * f
            red = torch.stack(red)
            if self.num_replicas > 1:
                red = self._psum(red)
            sq, bad_g, bad_p = sq + red[0], bad_g + red[1], bad_p + red[2]
        grad_norm = sq.sqrt()
        loss = torch.as_tensor(loss, device=self.device)
        ok = ((bad_g == 0) & (bad_p == 0) & torch.isfinite(loss).all()
              & torch.isfinite(grad_norm))
        if self._grad_norm_limit is not None:
            ok = ok & (grad_norm <= float(self._grad_norm_limit))
        return {"ok": ok.to(torch.int32), "grad_norm": grad_norm,
                "bad_grads": bad_g, "bad_params": bad_p}

    def _ps_carry_microstep(self, state: TrainState, batch, vals, opts):
        """One fused microstep with the host-PS variables in the device
        carry (the JAX scan body): the int8-wire variables' values go
        through the codec in the JAX element order before the loss (the
        pull's wire), the step runs as per step, and each PS variable's
        gradient — the wire container dequantized, an (ids, values) pair
        densified on the device — is applied by the optimizer to the
        full variable in the carry, in place (the push and the store's
        apply, per full variable)."""
        infos = self.model_item.var_infos
        quant = set(self.ps_store.wire_quant)
        wire_vals = {n: (collectives.quant_wire(to_jax_layout(
            v, infos[n].collective_name)) if n in quant else v)
            for n, v in vals.items()}
        new_state, ps_grads, metrics = self._train(state, batch, wire_vals)
        with torch.no_grad():
            scale = snap = None
            if self.guard:
                # the microstep's verdict gates the carry's apply as it
                # gates the per-step push: a bad microstep's PS update is
                # discarded and the carry flows on unchanged
                scale = state.sync_state["sentinel"]["lr_scale"]
                snap = _clone((vals, opts))
            for n in sorted(vals):
                g, info = ps_grads[n], infos[n]
                if isinstance(g, dict):
                    g = from_jax_layout(collectives.dequant_wire(
                        g, (info.num_elements,)), info.shape,
                        info.collective_name)
                elif isinstance(g, tuple):
                    g = embedding.scatter_add_dense(
                        g[0], g[1], int(info.shape[0]),
                        tuple(info.shape[1:]))
                self.optimizer.update({"v": g}, opts[n], {"v": vals[n]},
                                      scale=scale)
            if self.guard:
                okb = metrics["sentinel"]["ok"].bool()
                _select(okb, vals, snap[0])
                _select(okb, opts, snap[1])
        return new_state, metrics

    def _zero_apply(self, grads, params, sync_state, scale=None):
        """The sharded weight update: the optimizer on each ZeRO
        variable's owned flat shard (a little ``{"v": shard}`` tree
        against its state in ``sync_state['zero']``, advanced in place),
        then the update delta — scaled by the sentinel's ``scale`` before
        the gather, as the JAX lowering scales it — all-gathered and
        added to the replicated f32 param on every rank."""
        for n in sorted(self.zero_syncs):
            zs = self.zero_syncs[n]
            # the optimizer's params are this rank's shard of the
            # variable, as the JAX lowering passes them
            shard = ({"v": zs.local_shard(params[n])}
                     if self.optimizer.reads_params else {})
            delta = self.optimizer.delta({"v": grads[n]},
                                         sync_state["zero"][n], shard)["v"]
            if scale is not None:
                delta = delta * scale
            params[n].add_(zs.gather_update(delta))

    def _count_wire(self, microsteps: int = 1):
        if self._zero_rs_step or self._zero_ag_step:
            tel.counter_add("zero.rs_bytes", self._zero_rs_step * microsteps)
            tel.counter_add("zero.ag_bytes", self._zero_ag_step * microsteps)

    def _check_trainable(self):
        if self.optimizer is None and self.model_item.step_fn is None:
            raise ValueError("this runner was built without an optimizer: "
                             "pass one to AutoDist.build to train")

    def __call__(self, state: TrainState, batch, donate: bool = True):
        """One training step on this rank's shard of the batch, already on
        the device (:meth:`_step`): ``(new_state, metrics)``.
        Non-trainable variables get no update, so they and their
        optimizer slots never move (the JAX step's zero gradients and
        masked updates, exactly: a zero slot and a zero gradient give a
        zero update, with no weight decay).
        ``donate=True`` updates ``state``'s tensors in place (the JAX
        program donates them); ``donate=False`` leaves them as they
        were."""
        self._check_trainable()
        self.writes_begun = False
        if not donate:
            state = _clone_state(state)
        with tel.span("dstep.dispatch", "dstep", fused=False):
            if self.model_item.step_fn is not None:
                out = self._step(state, batch)
            else:
                ps_vals = {}
                if self.ps_store is not None:
                    ps_vals, version = self._pull_versioned()
                    self.ps_read_lags.append(self._ps_pushes - version)
                self._set_step(state.step)
                new_state, ps_grads, metrics = self._train(state, batch,
                                                           ps_vals)
                # a guarded step's verdict gates the push (the one update
                # the host applies), read with the push's own copy
                self._push_ps(ps_grads, metrics.get("sentinel", {}).get(
                    "ok"))
                out = new_state, metrics
        self.dispatches += 1
        tel.counter_add("dstep.dispatches")
        self._count_wire()
        return out

    def multi_step(self, k: int, donate: bool = True) -> Callable:
        """The fused k-microstep program (the JAX ``multi_step``): returns
        ``fused(state, ps_vals, ps_opt, stacked_batch) -> (new_state,
        new_ps_vals, new_ps_opt, stacked_metrics)`` over a stacked ``[k,
        ...]`` batch on the device, with the metrics stacked ``[k, ...]``
        and left on the device. ``ps_vals`` and ``ps_opt`` are the
        host-PS carry: each PS variable's full float32 value and its full
        little optimizer state on the device (``{}`` without host-PS
        variables), updated by every microstep (:meth:`_step`). The
        store's wire and apply are emulated against the superstep-start
        values, which is exact for a synchronous store only: one with
        staleness or ``sync=False`` is refused with the JAX package's
        ``ValueError``, and a partitioned one warns that the carry applies
        the optimizer per full variable where the store applies it per
        shard (a clip's norm differs).

        On ``cuda`` a call replays ONE CUDA graph that holds the k
        microsteps, the carry among its static tensors, captured at the
        first call for each (k, feed structure, shapes and dtypes) — the
        JAX package's per-shape compile (:class:`~autodist_tpu_torch.
        kernel.superstep.GraphedSuperstep`); a capture that fails raises.
        On the CPU it is the plain k-step loop in one call, the per-step
        :meth:`_step` k times. ``donate=False`` leaves ``state`` and the
        carry as they were. Most callers want :meth:`run_multi`, which
        manages the carry and counts the dispatch."""
        if k < 1:
            raise ValueError("multi_step needs k >= 1, got %d" % k)
        self._check_trainable()
        self._check_fused_ps()
        if self.device.type == "cuda" and self.num_replicas > 1:
            raise NotImplementedError(
                "fused supersteps with %d replicas on cuda: a CUDA graph "
                "cannot hold gloo's host-staged collectives, and NCCL "
                "capture waits for a machine with more than one card "
                "(ROADMAP A item 12)" % self.num_replicas)

        def fused(state, ps_vals, ps_opt, stacked_batch):
            lead = _lead_dims(stacked_batch)
            if lead and lead != {k}:
                raise ValueError(
                    "multi_step(k=%d) fed a stacked batch with leading "
                    "dim(s) %s" % (k, sorted(lead)))
            carry = None
            if self.ps_store is not None:
                carry = (ps_vals, ps_opt)
            if self.device.type == "cuda":
                new_state, carry, metrics = self._graphed(
                    state, stacked_batch, k, donate, carry)
            else:
                self._set_step(state.step)
                if not donate:
                    state, carry = _clone_state(state), _clone(carry)
                new_state, metrics = self._loop(state, stacked_batch, k,
                                                carry)
            vals, opts = carry if carry is not None else ({}, {})
            return new_state, vals, opts, metrics
        return fused

    def _check_fused_ps(self):
        """The JAX ``_fused_fn``'s refusal and warning for host-PS
        variables in fused supersteps."""
        store = self.ps_store
        if store is None:
            return
        if store.any_async() or store.max_staleness() > 0:
            raise ValueError(
                "fused multi-step requires synchronous host-PS: async "
                "serving / staleness>0 let peers' applies land BETWEEN "
                "microsteps, which a scan compiled around a superstep-"
                "start snapshot cannot observe. Run per-step, or use "
                "sync=True staleness=0 PS (or an AllReduce strategy).")
        if not self._warned_partitioned_carry and any(
                p.partitioned for p in store.plans.values()):
            self._warned_partitioned_carry = True
            logging.warning(
                "fused multi-step with a PARTITIONED host-PS store: the "
                "device emulation applies the optimizer per full variable "
                "while the per-step host path applies it per shard — "
                "identical for elementwise optimizers, but norm-based "
                "transforms (e.g. clip_by_global_norm) may differ from "
                "the per-step loop; verify parity for your optimizer")

    def _loop(self, state: TrainState, stacked_batch, k: int, carry=None):
        """k microsteps of :meth:`_step` over the rows of a stacked feed;
        ``(new_state, metrics stacked [k, ...])``."""
        per_step = []
        for i in range(k):
            with lowering.microstep(i):
                state, metrics = self._step(
                    state, pytree.tree_map(lambda t, i=i: t[i],
                                           stacked_batch), carry)
            per_step.append(metrics)
        return state, pytree.tree_map(_stack, *per_step)

    def _graphed(self, state, stacked_batch, k, donate, carry=None):
        from autodist_tpu_torch.kernel.superstep import GraphedSuperstep
        leaves, spec = pytree.tree_flatten(stacked_batch)
        # donate is not in the key: the captured body is the same, and
        # only the replay differs (superstep.py)
        key = (k, str(spec), tuple((tuple(t.shape), t.dtype)
                                   for t in leaves))
        graph = self._graphs.get(key)
        if graph is None:
            graph = GraphedSuperstep(self, state, stacked_batch, k, carry)
            self._graphs[key] = graph
            self.warmup_microsteps += graph.warmup_microsteps
        # after a capture's warm-up, which advanced the device step
        self._set_step(state.step)
        return graph.replay(state, stacked_batch, donate, carry)

    def run_multi(self, state: TrainState, stacked_batch,
                  donate: bool = True):
        """Run one superstep (k = the stacked batch's leading dim) as ONE
        dispatch (:meth:`multi_step`) and manage the host-PS carry (the
        JAX ``run_multi``): loaded onto the device before the first
        superstep after a flush, kept there across supersteps, written
        back to the store only at the next read of it
        (:meth:`flush_ps`). Returns ``(new_state, stacked_metrics)`` with
        the metrics still on the device — the caller decides when to pay
        the readback."""
        lead = _lead_dims(stacked_batch)
        if len(lead) > 1:
            raise ValueError(
                "stacked batch has mismatched leading (microstep) dims %s"
                % sorted(lead))
        k = next(iter(lead), 1)
        fn = self.multi_step(k, donate)   # refuses before any carry pull
        self.writes_begun = False
        with tel.span("dstep.dispatch", "dstep", fused=True):
            vals, opts = self._ensure_ps_carry()
            new_state, vals, opts, metrics = fn(state, vals, opts,
                                                stacked_batch)
            if self.ps_store is not None:
                self._ps_carry = (vals, opts)
                self._ps_carry_dirty = True
        self.dispatches += 1
        tel.counter_add("dstep.dispatches")
        self._count_wire(k)
        return new_state, metrics

    def _ensure_ps_carry(self):
        """The device carry for the fused supersteps (the JAX
        ``_ensure_fused_ps_carry``): at the first superstep after a flush,
        land the in-flight per-step push, then pull the full values (raw
        float32, not the wire form: the microsteps apply the codec) and
        each variable's full little optimizer state onto the device, once
        for the whole run of supersteps."""
        if self.ps_store is None:
            return {}, {}
        if self._ps_carry is None:
            with tel.span("dstep.pull_ps", "dstep", fused=True):
                tel.counter_add("dstep.ps_pulls")
                self.flush_ps()
                vals, _ = self.ps_store.pull(wire=False)
                self._ps_carry = (vals, self.ps_store.pull_little_opts())
        return self._ps_carry

    def _flush_ps_carry(self) -> None:
        """Write the fused carry back to the store (values and per-shard
        optimizer states, ``PSStore.absorb_device_state``) and drop it:
        the store is authoritative again. The pipeline's staged pull
        predates the write-back, so it is dropped too."""
        if not self._ps_carry_dirty:
            return
        vals, opts = self._ps_carry
        self._ps_carry, self._ps_carry_dirty = None, False
        self.ps_store.absorb_device_state(vals, opts)
        self._ps_pushes += 1
        pipe = getattr(self, "_ps_pipe_obj", None)
        if pipe is not None:
            pipe.invalidate()

    def evaluate(self, state: TrainState, batch, ps_vals=None):
        """Forward-only metrics under the compute tier: no grads, no
        optimizer. ``ps_vals`` (a :meth:`pull_ps` snapshot) lets an eval
        loop pull the host-PS values once for all its batches; without it
        this call pulls."""
        if ps_vals is None:
            ps_vals = self.pull_ps()
        with torch.no_grad(), tel.span("dstep.evaluate", "dstep"), \
                mesh_lib.bind(self.mesh):
            full = dict(self._full_params(state.params))
            full.update(self._ps_dewire(ps_vals))
            return self._metrics(*self._loss(full, batch))

    def lowered_text(self, state: TrainState, batch, fuse_steps: int = 1,
                     program: str = "train", donate: bool = False,
                     rank: Optional[int] = None) -> str:
        """The program text of the step (the JAX ``lowered_text``): the
        step run once on fake tensors and recorded op by op
        (``kernel/lowering.py``), the input of the analyses in
        ``analysis/program.py``, ``memory.py``, ``lowered.py`` and
        ``numerics.py``. Nothing runs on the device and nothing changes:
        the host-PS values enter as fakes, as the JAX package enters them
        as avals. ``batch`` is this rank's placed feed.
        ``program="eval"`` records the forward-only :meth:`evaluate`;
        ``fuse_steps=k > 1`` the fused superstep of k microsteps (the
        microstep feed ``batch`` stacked k times); ``donate=True`` the
        variant that updates the state in place, the one that runs in
        steady state; ``rank`` the program of another rank of the mesh
        (ADT407)."""
        return lowering.record_step(self, state, batch, fuse_steps=fuse_steps,
                                    program=program, donate=donate,
                                    rank=rank)

    def snapshot_lowered(self, state: TrainState, batch):
        """Write the transformed program's text as snapshot stage
        ``3-transformed-program`` (the JAX ``3-transformed-stablehlo``,
        the reference's '3-transformed' TensorBoard snapshot); returns its
        path, None when it could not be written."""
        from autodist_tpu_torch.utils import visualization_util
        try:
            text = self.lowered_text(state, batch)
            return visualization_util.log_program("3-transformed-program",
                                                  text, force=True)
        except Exception as e:  # noqa: BLE001 — diagnostics must not break runs
            logging.warning("snapshot_lowered failed: %s", e)
            return None

    def gather_params(self, state: TrainState) -> dict:
        """The full params in their original names and layout: this
        replica's, which equal every other's, with each partitioned
        variable all-gathered and unpadded and each model-parallel one
        all-gathered over its mesh axes (collectives every rank must
        join), and each host-PS variable from the store (after the
        in-flight push has landed), on the device; in step_fn mode the
        user's state tree itself."""
        if self.model_item.step_fn is not None:
            return state.params
        full = dict(self._full_params(state.params))
        for n, lay in self.mp_layouts.items():
            full[n] = lay.mp_gather(full[n], self.mesh)
        if self.ps_store is None:
            return full
        self.flush_ps()
        for n, t in self.ps_store.full_values().items():
            full[n] = t.to(self.device)
        return {n: full[n] for n in self.model_item.params}

    def gather_opt_state(self, state: TrainState):
        """The optimizer state in the original names and full layout:
        each partitioned variable's slots all-gathered and unpadded, each
        model-parallel variable's all-gathered over its mesh axes, each
        ZeRO-sharded variable's rebuilt from the ranks' shards in
        ``sync_state['zero']`` and each host-PS variable's from the
        store's shards (the JAX ``gather_opt_state``). With partitioned
        or ZeRO variables it is a collective every rank must join;
        otherwise the state's own tensors, on the device."""
        opt = state.opt_state
        if not (self.layouts or self.mp_layouts or self.zero_syncs
                or self.ps_store) or not opt:
            return opt
        n_data, data = self.n_data, self._data_group()
        if self.ps_store is not None:
            self.flush_ps()
        out = dict(opt)
        for slot in self._slots():
            out[slot] = dict(opt[slot])
            for n, lay in self.layouts.items():
                out[slot][n] = lay.gather_full(opt[slot][n], data, n_data)
            for n, lay in self.mp_layouts.items():
                out[slot][n] = lay.mp_gather(opt[slot][n], self.mesh)
            for n, zs in sorted(self.zero_syncs.items()):
                shard = state.sync_state["zero"][n][slot]["v"]
                out[slot][n] = zs.unshard(
                    [collectives.all_gather_flat(shard, data, n_data)])
            for n in self.ps_store.var_names if self.ps_store else ():
                out[slot][n] = self.ps_store.full_opt_leaf(
                    slot, n).to(self.device)
        return out

    def gather_sync_state(self, state: TrainState):
        """Every replica's compressor state and ZeRO optimizer-state
        shards, each leaf ``[N, ...]`` with row r rank r's (the JAX
        package keeps this leading device axis in its checkpoints): an
        ``all_gather`` a leaf with more than one replica, which every
        rank must join; the state itself with a leading axis of 1 with
        one replica."""
        def gather(t):
            if self.num_replicas == 1:
                return t[None]
            parts = [torch.empty_like(t) for _ in range(self.num_replicas)]
            dist.all_gather(parts, t.contiguous())
            return torch.stack(parts)
        return pytree.tree_map(gather, state.sync_state)

    def close(self):
        """Drop the captured supersteps and their memory; land the
        in-flight push and stop the PS pipeline and the store's apply
        pool."""
        self._graphs.clear()
        if self.ps_store is not None:
            self.close_ps()
            self.ps_store.close()

    # ---------------------------------------------------------- host PS

    @property
    def _ps_pipe(self) -> Optional[ps_lib.PSPipeline]:
        """The PSPipeline, made at the first step that pulls (None with
        no store, or with ``ADT_PS_OVERLAP=0``: the serial path)."""
        if not hasattr(self, "_ps_pipe_obj"):
            self._ps_pipe_obj = None
            if self.ps_store is not None and const.ENV.ADT_PS_OVERLAP.val:
                self._ps_pipe_obj = ps_lib.PSPipeline(
                    self.ps_store, self.ps_store.max_staleness() >= 1
                    or self.ps_store.any_async())
        return self._ps_pipe_obj

    def _pull_versioned(self):
        """(the host-PS values on the device, the store version they
        are), after the fused carry, if any, is written back."""
        with tel.span("dstep.pull_ps", "dstep"):
            tel.counter_add("dstep.ps_pulls")
            self._flush_ps_carry()
            pipe = self._ps_pipe
            return (pipe.values() if pipe is not None
                    else self.ps_store.pull())

    def pull_ps(self) -> dict:
        """The current host-PS values on the device (the per-step read
        from the PS; ``{}`` with no host-resident variable). Public: an
        eval loop pulls once and reuses the snapshot
        (``Runner.evaluate``)."""
        if self.ps_store is None:
            return {}
        return self._pull_versioned()[0]

    def _ps_dewire(self, ps_vals) -> dict:
        """The pulled values with each int8-wire variable's ``{"q", "s"}``
        container (blocks in the JAX element order) dequantized on the
        device (the device half of the store's codec)."""
        if not self.ps_store or not self.ps_store.wire_quant:
            return ps_vals
        out = dict(ps_vals)
        for n in self.ps_store.wire_quant:
            info = self.model_item.var_infos[n]
            out[n] = from_jax_layout(collectives.dequant_wire(
                out[n], (info.num_elements,)), info.shape,
                info.collective_name)
        return out

    def _push_ps(self, ps_grads: dict, ok=None) -> None:
        """Hand a step's PS gradients to the store: pipelined, or at once
        (``ADT_PS_OVERLAP=0``). On ``cuda`` the copy waits on an event
        recorded here, after the step's kernels. ``ok`` is the sentinel's
        verdict (a device scalar, or None unguarded): it crosses with the
        gradients, and a bad one suppresses the push at the store."""
        if self.ps_store is None or not ps_grads:
            return
        self._ps_pushes += 1
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()
        if self._ps_pipe is not None:
            self._ps_pipe.submit(ps_grads, ready, ok=ok)
        else:
            self.ps_store.push(ps_grads, ready, ok=ok)

    def flush_ps(self) -> None:
        """Wait for the in-flight push and write the fused carry back:
        every read of the store (a checkpoint, a gather, a digest) must
        see every submitted gradient and every microstep applied."""
        if self.ps_store is None:
            return
        with tel.span("dstep.flush_ps", "dstep"):
            tel.counter_add("dstep.ps_flushes")
            pipe = getattr(self, "_ps_pipe_obj", None)
            if pipe is not None:
                pipe.flush()
            self._flush_ps_carry()

    def invalidate_ps(self) -> None:
        """Drop the fused carry without writing it back, then flush and
        drop the pipeline's staged pull: the store's contents were
        replaced (a restore, a re-init), and the store, not the carry, is
        authoritative."""
        self._ps_carry, self._ps_carry_dirty = None, False
        pipe = getattr(self, "_ps_pipe_obj", None)
        if pipe is not None:
            pipe.invalidate()

    def close_ps(self) -> None:
        """Flush the pipeline and stop its threads, then land the fused
        carry (a close right after supersteps must not drop their PS
        updates); a new pipeline is made if stepping resumes."""
        pipe = getattr(self, "_ps_pipe_obj", None)
        if pipe is not None:
            pipe.close()
            del self._ps_pipe_obj
        self._flush_ps_carry()

    def _serving_groups(self, group=None, mesh=None):
        """``(mesh, rows_group, rows_world)`` of a serving program: the
        mesh whose axes its calls bind (``mesh``, a serving plane's copy
        of this plan's whose full group is ``group``, or this plan's), and
        the group of this rank's block of the batch axes, over which its
        rows gather, with its size B (``group`` without a mesh)."""
        mesh = mesh if mesh is not None else self.mesh
        if mesh is None:
            return None, group, self.num_replicas
        B = self.replica_info.num_replicas
        rows = mesh.group_of(self.replica_info.batch_axes) if B > 1 else None
        return mesh, rows, B

    def local_slots(self, slots: int) -> int:
        """This rank's share of a decode engine's ``slots`` (the slot dim
        shards over the B batch replicas, the rank at batch index b
        holding slots ``[b*S/B, (b+1)*S/B)``); the JAX lowering's
        ``ValueError`` when ``slots`` does not divide."""
        n = self.replica_info.num_replicas
        if slots % n:
            raise ValueError(
                "decode slot count %d is not divisible by the batch-axes "
                "mesh extent %d — pick slots as a multiple of the "
                "data-parallel degree" % (slots, n))
        return slots // n

    def _run(self, fn, state, ps_vals, payload, group=None, mesh=None):
        """``fn(full params, payload)`` with ``mesh``'s model-parallel
        axes bound (the JAX ``shard_map`` scope): each partitioned
        variable gathered over the data axis, each model-parallel one
        left as this rank's slice, the host-PS values filled in."""
        with torch.inference_mode(), tel.span("dstep.dispatch", "dstep",
                                              fused=False), \
                mesh_lib.bind(mesh):
            params = self._full_params(state.params, group, mesh)
            if ps_vals:
                params = dict(params)
                params.update(self._ps_dewire(ps_vals))
            out = fn(params, payload)
        tel.counter_add("dstep.dispatches")
        return out

    def predict_program(self, serve_fn: Callable,
                        donate_batch: bool = True,
                        example_batch=None, group=None,
                        keep_local=(), mesh=None) -> ForwardProgram:
        """The forward-only FETCH program behind the serving engine:
        ``serve_fn(full_params, batch)`` with no grads, the host-PS
        variables from ``ps_vals`` (a :meth:`pull_ps` snapshot). Returns
        ``fn(state, ps_vals, batch) -> outputs`` with outputs left on the
        device.

        With N replicas the call is SPMD: ``batch`` is this rank's rows
        (the remapper's split of the global batch over the batch axes:
        the ranks of one model, pipe or seq line take the same rows),
        each rank runs them on its params (partitioned variables
        all-gathered over the data axis, model-parallel ones as this
        rank's slices, the mesh's axes bound, as the JAX program's
        ``shard_map`` binds them) plus the PS values, and the
        per-example outputs come back as the global batch on every rank,
        gathered over the batch axes' group; the others reduce like eval
        metrics over every rank. Its status and reductions run on
        ``group`` (the default group when None; a serving engine passes
        its plane's) and its axes on ``mesh``'s groups (this plan's mesh
        when None; a serving engine passes its plane's copy), and
        ``keep_local`` names top-level fetch keys whose per-example
        leaves stay on their rank.

        ``example_batch`` fixes the feed structure and classifies the
        outputs: an output leaf whose leading dim equals this rank's row
        count of the example is per-example, judged on the example's own
        outputs (the JAX lowering judges the same rule on abstract local
        shapes; a large example makes the leading dim distinctive).
        ``donate_batch`` is accepted for signature parity: eager programs
        free a request's buffers when the caller drops them."""
        del donate_batch
        if example_batch is None:
            example_batch = self.model_item.example_batch
        _, spec = pytree.tree_flatten(example_batch)
        key = (serve_fn, str(spec), id(group), tuple(sorted(keep_local)),
               id(mesh))
        if key not in self._predict_progs:
            from autodist_tpu_torch.remapper import Remapper
            remapper = Remapper(self.device, self.replica_info)
            rows = _leading_rows(remapper.shard_host(example_batch))
            bound, rows_group, rows_world = self._serving_groups(group,
                                                                 mesh)

            def run(state, ps_vals, batch):
                return self._run(serve_fn, state, ps_vals, batch, group,
                                 bound)

            def classify(state, ps_vals, batch, out):
                if _leading_rows(batch) != rows:
                    out = run(state, ps_vals,
                              remapper.remap_feed(example_batch))
                return _classify(out, rows)
            self._predict_progs[key] = ForwardProgram(
                run, classify, group=group, world=self.num_replicas,
                device=self.device, keep_local=keep_local,
                rows_group=rows_group, rows_world=rows_world)
        return self._predict_progs[key]

    def decode_program(self, decode_fn: Callable, example_dstate,
                       slots: Optional[int] = None,
                       group=None, mesh=None) -> ForwardProgram:
        """The decode-STEP program behind continuous batching:
        ``decode_fn(full_params, dstate)`` where ``dstate`` carries the
        slot-major KV caches and per-slot token/cursor/alive. The caches
        are updated IN PLACE (the JAX program donates them and returns
        new buffers; eager PyTorch writes the new rows into the same
        storage, so steady-state decode holds one cache allocation).
        Output leaves whose leading dim is this rank's slot count are
        per-slot.

        ``example_dstate`` is this rank's state: ``slots`` (the engine's
        whole slot count; the example's with one replica) shards over the
        B batch replicas, batch index b holding slots ``[b*S/B,
        (b+1)*S/B)`` (the ranks of one model line hold the same slots),
        and an indivisible count raises the JAX ``ValueError``. With N
        replicas the per-slot outputs come back whole on every rank
        (all-gathered over the batch axes' group in its order) but the
        caches (the remapper's ``CACHE_KEYS``), which stay on their rank;
        the rest reduces like eval metrics over ``group``; the mesh's axes
        are bound as in :meth:`predict_program`."""
        local = _leading_rows(example_dstate)
        if slots is not None and self.local_slots(int(slots)) != local:
            raise ValueError(
                "decode state holds %d slots; this rank's share of %d "
                "slots is %d" % (local, slots, self.local_slots(slots)))
        _, spec = pytree.tree_flatten(example_dstate)
        key = (decode_fn, str(spec), id(group), id(mesh))
        if key not in self._decode_progs:
            bound, rows_group, rows_world = self._serving_groups(group,
                                                                 mesh)
            self._decode_progs[key] = ForwardProgram(
                lambda state, ps_vals, dstate: self._run(
                    decode_fn, state, ps_vals, dstate, group, bound),
                lambda state, ps_vals, dstate, out: _classify(out, local),
                group=group, world=self.num_replicas, device=self.device,
                keep_local=CACHE_KEYS, rows_group=rows_group,
                rows_world=rows_world)
        return self._decode_progs[key]


class GraphTransformer:
    """Builds the :class:`DistributedStep` for a compiled strategy on this
    process's device (the JAX ``GraphTransformer.transform``).
    ``replica_info`` gives the replica count (the default process group's
    world size) and this process's rank; the plan must name as many
    replicas, except under async PS, where each process trains at one
    replica of its own and ``replica_info`` must say one."""

    def __init__(self, compiled_strategy: Strategy, model_item, device,
                 replica_info: Optional[ReplicaInfo] = None,
                 sentinel=None):
        self._strategy = compiled_strategy
        self._item = model_item
        self._device = device
        self._replicas = replica_info or ReplicaInfo()
        # the resolved health-sentinel policy (runtime/sentinel.py): its
        # guards are built into the step; None builds none
        self._sentinel = sentinel

    def _refuse_unported(self):
        """Plan features the port has not reached raise, naming the
        ROADMAP item that ports them; none is ignored. With more than one
        process: a mesh axis other than data, model, pipe, seq and expert
        (the JAX package has no other either)."""
        gc = self._strategy.graph_config
        N = self._replicas.num_processes

        def refuse(what, item):
            raise NotImplementedError(
                "%s with %d replicas is not ported yet (ROADMAP A item %d)"
                % (what, N, item))
        if N <= 1:
            return
        mesh = dict(gc.mesh_shape or {})
        other = sorted(set(mesh) - {const.DATA_AXIS} -
                       set(mesh_lib.MODEL_PARALLEL_AXES))
        if other:
            refuse("the mesh axes %s" % other, 9)

    def _check_step_fn(self, replicas: int):
        """step_fn mode (the JAX ``_transform_step_fn``'s refusals): the
        opaque step hides the gradients that host-PS intercepts (refused)
        and compressors act on (warned and ignored); with more than one
        replica the port cannot see the gradients to sync them at all —
        the JAX lowering leaves that to GSPMD's batch sharding, which has
        no eager counterpart — so that is refused by name. The step's
        output structure is checked on a trace over fake tensors."""
        if replicas > 1:
            raise NotImplementedError(
                "build_step (an opaque step_fn) with %d replicas: the port "
                "cannot see the step's gradients to sync them over the "
                "replicas (ROADMAP A item 13); use loss_fn mode "
                "(AutoDist.build)" % replicas)
        ps = sorted(n.var_name for n in self._strategy.node_config
                    if n.synchronizer is not None
                    and n.synchronizer.kind == "PS")
        if ps:
            raise ValueError(
                "step_fn capture mode cannot lower host-PS strategies "
                "(vars %s): the opaque step hides the gradients the PS "
                "path intercepts. Use loss_fn mode, or an AllReduce "
                "strategy." % ps)
        for node in self._strategy.node_config:
            comp = getattr(node.synchronizer, "compressor", None)
            if comp and comp != "NoneCompressor":
                logging.warning(
                    "step_fn mode ignores compressor %s on %s — no "
                    "gradient interception on the opaque path", comp,
                    node.var_name)
        from autodist_tpu_torch.model_item import trace_step_fn
        item = self._item
        try:
            out = trace_step_fn(item.step_fn, item.params, item.example_batch)
        except Exception as e:  # noqa: BLE001 — the check runs every step
            logging.warning("step_fn could not be traced on fake tensors "
                            "(%s: %s); its output is checked at the first "
                            "step", type(e).__name__, e)
            return
        _step_fn_output(out, item.params)

    def _snapshot_loss(self):
        """Stage ``0-original-loss`` under ``ADT_SNAPSHOT``: the aten op
        listing of the item's one fake-tensor run (the JAX lowering logs
        the loss's jaxpr here; the reference writes its ``0-original``
        TensorBoard graph)."""
        from autodist_tpu_torch.utils import visualization_util
        costs = self._item.trace_costs
        if not visualization_util.enabled():
            return
        if costs is None or costs.listing is None:
            logging.warning("snapshot 0-original-loss: the item's trace ran "
                            "without the op listing (ADT_SNAPSHOT was off "
                            "at prepare, or the trace failed)")
            return
        visualization_util.log_program("0-original-loss", costs.listing)

    def transform(self) -> DistributedStep:
        replicas = len(self._strategy.graph_config.replicas)
        if self._item.step_fn is None and any(
                not p.sync for p in ps_lib.plan_host_ps(
                    self._strategy, self._item.var_infos).values()):
            # async PS: each process trains at one replica of its own (the
            # reference's between-graph replication), coupled to its peers
            # only through the parameter service
            replicas = 1
        if replicas != self._replicas.num_processes:
            raise ValueError(
                "the plan has %d replicas but the process group has %d "
                "ranks: describe one replica a rank in the resource spec "
                "(two ranks sharing one card list its index twice)"
                % (replicas, self._replicas.num_processes))
        if self._item.step_fn is not None:
            self._check_step_fn(replicas)
        else:
            self._refuse_unported()
            self._snapshot_loss()
        gc = self._strategy.graph_config
        mesh_shape = gc.mesh_shape
        if gc.seq_axis and gc.seq_axis not in (mesh_shape or {}):
            raise ValueError("strategy seq_axis %r not in mesh axes %s"
                             % (gc.seq_axis, tuple(mesh_shape or ())))
        if mesh_shape:
            # the plan's mesh over the processes: the batch axes split the
            # batch, the seq axis a sequence leaf's dim 1, the model-
            # parallel axes shard the mp variables' storage
            self._replicas = self._replicas.with_mesh(
                mesh_lib.ProcessMesh(mesh_shape,
                                     self._replicas.process_rank),
                seq_axis=gc.seq_axis, seq_keys=gc.seq_feed_keys,
                batch_axes=gc.batch_axes)
        if self._sentinel is not None and self._item.step_fn is not None:
            # the opaque step hides the gradients the guards judge: the
            # Runner's sentinel degrades to loss-only monitoring (ADT420)
            logging.warning(
                "sentinel requested but step_fn capture mode builds no "
                "health guards into the step: the sentinel watches the "
                "loss only (ADT420)")
        return DistributedStep(strategy=self._strategy,
                               model_item=self._item, device=self._device,
                               metadata={"replicas": replicas},
                               replica_info=self._replicas,
                               sentinel=self._sentinel)
