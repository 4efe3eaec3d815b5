"""GraphTransformer — turns a compiled Strategy into the programs a Runner
executes.

PyTorch counterpart of ``autodist_tpu/kernel/graph_transformer.py``. JAX
lowers the plan to jitted SPMD programs over a device mesh; the port runs
eagerly, one process a replica (the ranks of the ``torch.distributed``
group the caller created, ``kernel/replicator.py``), so a "program" here
is a Python callable with the signature the JAX program has.
:class:`DistributedStep` carries:

- the training step (``__call__``): the JAX ``local_step`` — loss and
  grads of this rank's shard of the batch, then, with more than one
  replica, the epilogue gradient sync: the concatenated buckets of
  compressed variables (``parallel/collectives.py``), then the
  per-variable synchronizers, each a mean over the replicas; frozen
  variables held still; the optimizer apply; ``{"loss": ...}`` metrics
  averaged over the replicas. One replica issues no collective;
- the fused superstep (:meth:`DistributedStep.multi_step`,
  :meth:`DistributedStep.run_multi`): k microsteps in one dispatch, on
  ``cuda`` one replay of a CUDA graph (``kernel/superstep.py``), on the
  CPU the k-step loop;
- in step_fn mode (``AutoDist.build_step``) the user's opaque
  ``step_fn(state, batch) -> (new_state, metrics)`` in place of the
  loss, grads and optimizer, on one replica;
- :meth:`DistributedStep.evaluate`: forward-only metrics;
- the serving programs (:meth:`DistributedStep.predict_program`,
  :meth:`DistributedStep.decode_program`), run under
  ``torch.inference_mode()``, on one replica.

Lookup-indexed tables that the JAX package would sync over its sparse
(ids, values) wire are synced dense here, outside the buckets, as that
wire leaves them (ROADMAP A item 8). With more than one replica the
transform refuses, by name, the plan features the port has not reached.
"""
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from autodist_tpu_torch.kernel.replicator import ReplicaInfo
from autodist_tpu_torch.kernel.synchronization.all_reduce_synchronizer \
    import AllReduceSynchronizer
from autodist_tpu_torch.kernel.synchronization.synchronizer import \
    all_reduce_sum
from autodist_tpu_torch.parallel import collectives
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


class ForwardProgram:
    """A forward-only fetch program plus its per-leaf batch classification
    (the JAX ``ForwardProgram``).

    ``batch_mask`` mirrors the fetch tree with one bool per leaf: True for
    per-example rows, False for anything else. Serving's padded-row
    masking and per-request fan-out consult it instead of comparing
    shapes at each call. JAX classifies from abstract shapes at lowering
    time; the eager port classifies at the first call (``classify``)."""

    def __init__(self, fn: Callable, classify: Callable):
        self.fn = fn
        self._classify = classify
        self._mask = None

    def __call__(self, state, ps_vals, batch):
        out = self.fn(state, ps_vals, batch)
        if self._mask is None:
            self._mask = self._classify(state, ps_vals, batch, out)
        return out

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


def sparse_wire_vars(item, replicas: ReplicaInfo) -> set:
    """The tables the JAX lowering would sync over its sparse (ids,
    values) wire at ``replicas.num_replicas`` > 1
    (``autodist_tpu/kernel/graph_transformer.py:1140-1262``): trainable
    lookup-indexed variables with no other differentiable use, whose
    gathered pairs — ids looked up per replica x replicas x (features +
    1) — undercut the dense gradient (rows x features). The lookups are
    traced against one replica's shard of the example batch."""
    from autodist_tpu_torch.model_item import trace_lookups
    candidates = {n for n, v in item.var_infos.items()
                  if v.sparse and v.trainable}
    if not candidates or item.example_batch is None:
        return set()
    loss = item.loss_fn
    if item.has_aux:
        loss = lambda p, b: item.loss_fn(p, b)[0]  # noqa: E731

    def local(leaf):
        shape = np.shape(leaf)
        if not shape:
            return leaf
        return leaf[:replicas.local_shape(shape)[0]]
    try:
        lookups, dense_uses = trace_lookups(
            loss, item.params, pytree.tree_map(local, item.example_batch))
    except Exception as e:  # noqa: BLE001 — routing is best-effort
        logging.warning("sparse-wire discovery failed (%s); every table "
                        "syncs in the dense plan", e)
        return set()
    out = set()
    for n in sorted(candidates & set(lookups) - dense_uses):
        shape = item.var_infos[n].shape
        feat = max(1, int(np.prod(shape[1:] or (1,))))
        sparse_elems = sum(lookups[n]) * replicas.num_replicas * (feat + 1)
        if sparse_elems < int(shape[0]) * feat:
            out.add(n)
    return out


class DistributedStep:
    """The executable plan on this process's device: parameter state init,
    the training step with its gradient sync, evaluation and the serving
    programs built from user functions."""

    def __init__(self, *, strategy: Strategy, model_item, device,
                 metadata: Optional[dict] = None,
                 replica_info: Optional[ReplicaInfo] = None):
        self.strategy = strategy
        self.model_item = model_item
        self.optimizer = model_item.optimizer_spec
        self.device = torch.device(device)
        self.metadata = metadata or {}
        self.replica_info = replica_info or ReplicaInfo()
        self.num_replicas = self.replica_info.num_replicas
        # no host-resident parameter-server variables in this slice: the
        # serving engine's snapshot is always the empty mapping
        self.ps_store = None
        self._predict_progs: Dict[tuple, ForwardProgram] = {}
        self._decode_progs: Dict[tuple, ForwardProgram] = {}
        self.syncs: Dict[str, AllReduceSynchronizer] = {}
        # dispatches: a step, or a fused superstep of k microsteps
        self.dispatches = 0
        # the CUDA graphs of the fused supersteps, by (k, feed structure
        # and shapes), and the eager microsteps their captures ran first
        # to warm up
        self._graphs: Dict[tuple, object] = {}
        self.warmup_microsteps = 0
        self.buckets = []
        self.sparse_wire = frozenset()
        if self.num_replicas > 1:
            self._build_synchronizers()

    def _build_synchronizers(self):
        """Per-variable synchronizer kernels from the node configs, and
        the buckets of the concatable compressed ones (the JAX
        ``_build_synchronizers`` and ``make_buckets`` call). NoneCompressor
        variables all-reduce one by one; the sparse-wire tables keep out
        of both, as in the JAX lowering."""
        N, item = self.num_replicas, self.model_item
        self.sparse_wire = frozenset(sparse_wire_vars(item, self.replica_info))
        for node in self.strategy.node_config:
            info = item.var_infos.get(node.var_name)
            if (info is None or not info.trainable
                    or node.var_name in self.sparse_wire):
                continue
            self.syncs[node.var_name] = AllReduceSynchronizer(
                node.var_name, node.synchronizer, N,
                collective_name=info.collective_name)
        compressed = {n: s for n, s in self.syncs.items()
                      if s.compressor.name != "NoneCompressor"}
        self.buckets, _ = collectives.make_buckets(compressed,
                                                   item.var_infos)
        self._bucketed = {n for b in self.buckets for n in b.var_names}
        # one data axis: the default group, all N ranks
        self._ring_axes = ((None, N),)

    def _sync_state_init(self) -> dict:
        """Compressor states on the device, one copy per rank (the JAX
        ``sync_state_init`` without its leading device axis)."""
        st = {"bucket": {}, "var": {}}
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
        ``opt_state``). The state owns copies: the step updates them in
        place and the caller's tensors never move. With more than one
        replica, every replica takes rank 0's params and optimizer state
        and its own compressor state: row r of a given ``sync_state``
        (the gathered ``[N, ...]`` tree a checkpoint holds,
        :meth:`gather_sync_state`) for rank r, or a fresh one. A
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
        if opt_state is not None:
            opt_state = pytree.tree_map(
                lambda t: (t.to(self.device, copy=True)
                           if isinstance(t, torch.Tensor) else t), opt_state)
        elif self.optimizer is not None:
            opt_state = self.optimizer.init(placed)
        sync = self._sync_state_init() if self.num_replicas > 1 else {}
        if sync_state is not None:
            sync = self._own_row(sync_state, sync)
        if self.num_replicas > 1:
            self._broadcast(placed)
            self._broadcast(opt_state)
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
        """This rank's row of a gathered ``[N, ...]`` compressor-state
        tree, on the device; ``fresh`` when the tree does not fit this
        plan (other buckets or synchronizers, another replica count)."""
        got, want = _named_leaves(gathered), _named_leaves(fresh)
        fits = got.keys() == want.keys() and all(
            tuple(got[k].shape) == (self.num_replicas,) + tuple(w.shape)
            for k, w in want.items())
        if not fits:
            logging.warning(
                "sync state in checkpoint incompatible with the current "
                "strategy (%d replicas, buckets %s); reinitializing",
                self.num_replicas, sorted(fresh.get("bucket", {})))
            return fresh
        rank = self.replica_info.rank
        return _map_named(lambda k, w: got[k][rank].to(
            self.device, w.dtype, copy=True), fresh)

    def _loss(self, params, batch):
        if self.model_item.loss_fn is None:
            raise ValueError("this runner lowers an opaque step_fn, which "
                             "has no loss to evaluate: use loss_fn mode "
                             "(AutoDist.build)")
        out = self.model_item.loss_fn(params, batch)
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

    def _sync_grads(self, grads, sync_state):
        """The JAX ``local_step`` epilogue over N > 1 replicas: the
        sparse-wire tables' dense mean, the buckets, then the per-variable
        synchronizers, each a mean over the replicas; returns the synced
        gradients and the new ``sync_state``."""
        N = self.num_replicas
        new_bucket = dict(sync_state.get("bucket", {}))
        new_var = dict(sync_state.get("var", {}))
        synced = {}
        # the JAX lowering ships these as (ids, values) pairs; the port
        # sends the dense gradient (ROADMAP A item 8), the same mean
        for n in sorted(self.sparse_wire):
            synced[n] = self._psum(grads[n]) / N
        for b in self.buckets:
            out, nst = collectives.bucket_reduce(
                b, grads, new_bucket.get(b.key), self._psum, N,
                ring_axes=self._ring_axes)
            synced.update(out)
            if nst is not None:
                new_bucket[b.key] = nst
        for n, s in self.syncs.items():
            if n in self._bucketed or n in synced:
                continue
            synced[n], nst = s.sync(grads[n], new_var.get(n))
            if nst is not None:
                new_var[n] = nst
        new_sync = dict(sync_state)
        for key, value in (("bucket", new_bucket), ("var", new_var)):
            if value:
                new_sync[key] = value
        return synced, new_sync

    def _step(self, state: TrainState, batch):
        """One microstep on ``state``, with no span and no dispatch count:
        ``(new_state, metrics)``. In loss_fn mode the loss and grads of
        the trainable variables, with more than one replica their sync
        (:meth:`_sync_grads`), and the optimizer apply, in place on
        ``state``'s tensors. In step_fn mode the user's ``step_fn(state,
        batch) -> (new_state, metrics)`` as given (its metrics detached).
        Nothing here reads a value back to the host, so a CUDA graph can
        hold it (:mod:`~autodist_tpu_torch.kernel.superstep`)."""
        item = self.model_item
        if item.step_fn is not None:
            with torch.enable_grad():
                new_user, metrics = _step_fn_output(
                    item.step_fn(state.params, batch), item.params)
            return TrainState(step=state.step + 1, params=new_user,
                              opt_state=state.opt_state,
                              sync_state=state.sync_state), \
                pytree.tree_map(_detach, metrics)
        trainable = item.trainable_var_names
        full = dict(state.params)
        for n in trainable:
            full[n] = state.params[n].detach().requires_grad_()
        with torch.enable_grad():
            loss, aux = self._loss(full, batch)
            grads = torch.autograd.grad(
                loss, [full[n] for n in trainable], allow_unused=True) \
                if trainable else ()
        grads = {n: (g if g is not None
                     else torch.zeros_like(state.params[n]))
                 for n, g in zip(trainable, grads)}
        sync_state = state.sync_state
        with torch.no_grad():
            if self.num_replicas > 1:
                with tel.span("dstep.grad_sync", "dstep"):
                    grads, sync_state = self._sync_grads(grads, sync_state)
            opt_state = self.optimizer.update(grads, state.opt_state,
                                              state.params)
        return TrainState(step=state.step + 1, params=state.params,
                          opt_state=opt_state,
                          sync_state=sync_state), self._metrics(loss, aux)

    def _check_trainable(self):
        if self.optimizer is None and self.model_item.step_fn is None:
            raise ValueError("this runner was built without an optimizer: "
                             "pass one to AutoDist.build to train")

    def __call__(self, state: TrainState, batch, donate: bool = True):
        """One training step on this rank's shard of the batch, already on
        the device (:meth:`_step`): ``(new_state, metrics)``.
        Non-trainable variables get no update, so they and their optimizer
        moments never move (the JAX step's zero gradients and masked
        updates, exactly: a zero Adam moment gives a zero update).
        ``donate=True`` updates ``state``'s tensors in place (the JAX
        program donates them); ``donate=False`` leaves them as they
        were."""
        self._check_trainable()
        if not donate:
            state = _clone_state(state)
        with tel.span("dstep.dispatch", "dstep", fused=False):
            out = self._step(state, batch)
        self.dispatches += 1
        tel.counter_add("dstep.dispatches")
        return out

    def multi_step(self, k: int, donate: bool = True) -> Callable:
        """The fused k-microstep program (the JAX ``multi_step``): returns
        ``fused(state, ps_vals, ps_opt, stacked_batch) -> (new_state,
        new_ps_vals, new_ps_opt, stacked_metrics)`` over a stacked ``[k,
        ...]`` batch on the device, with the metrics stacked ``[k, ...]``
        and left on the device. The port has no host-PS, so ``ps_vals``
        and ``ps_opt`` are ``{}`` in and out.

        On ``cuda`` a call replays ONE CUDA graph that holds the k
        microsteps, captured at the first call for each (k, feed
        structure, shapes and dtypes) — the JAX package's
        per-shape compile (:class:`~autodist_tpu_torch.kernel.superstep.
        GraphedSuperstep`); a capture that fails raises. On the CPU it is
        the plain k-step loop in one call, the per-step :meth:`_step` k
        times. ``donate=False`` leaves ``state`` as it was. Most callers
        want :meth:`run_multi`, which counts the dispatch."""
        if k < 1:
            raise ValueError("multi_step needs k >= 1, got %d" % k)
        self._check_trainable()
        if self.device.type == "cuda" and self.num_replicas > 1:
            raise NotImplementedError(
                "fused supersteps with %d replicas on cuda: a CUDA graph "
                "cannot hold gloo's host-staged collectives, and NCCL "
                "capture waits for a machine with more than one card "
                "(ROADMAP A item 12)" % self.num_replicas)

        def fused(state, ps_vals, ps_opt, stacked_batch):
            del ps_vals, ps_opt  # no host-PS in the port
            lead = _lead_dims(stacked_batch)
            if lead and lead != {k}:
                raise ValueError(
                    "multi_step(k=%d) fed a stacked batch with leading "
                    "dim(s) %s" % (k, sorted(lead)))
            if self.device.type == "cuda":
                new_state, metrics = self._graphed(
                    state, stacked_batch, k, donate)
            else:
                if not donate:
                    state = _clone_state(state)
                new_state, metrics = self._loop(state, stacked_batch, k)
            return new_state, {}, {}, metrics
        return fused

    def _loop(self, state: TrainState, stacked_batch, k: int):
        """k microsteps of :meth:`_step` over the rows of a stacked feed;
        ``(new_state, metrics stacked [k, ...])``."""
        per_step = []
        for i in range(k):
            state, metrics = self._step(
                state, pytree.tree_map(lambda t, i=i: t[i], stacked_batch))
            per_step.append(metrics)
        return state, pytree.tree_map(_stack, *per_step)

    def _graphed(self, state, stacked_batch, k, donate):
        from autodist_tpu_torch.kernel.superstep import GraphedSuperstep
        leaves, spec = pytree.tree_flatten(stacked_batch)
        # donate is not in the key: the captured body is the same, and
        # only the replay differs (superstep.py)
        key = (k, str(spec), tuple((tuple(t.shape), t.dtype)
                                   for t in leaves))
        graph = self._graphs.get(key)
        if graph is None:
            graph = GraphedSuperstep(self, state, stacked_batch, k)
            self._graphs[key] = graph
            self.warmup_microsteps += graph.warmup_microsteps
        return graph.replay(state, stacked_batch, donate)

    def run_multi(self, state: TrainState, stacked_batch,
                  donate: bool = True):
        """Run one superstep (k = the stacked batch's leading dim) as ONE
        dispatch (:meth:`multi_step`); returns ``(new_state,
        stacked_metrics)`` with the metrics still on the device — the
        caller decides when to pay the readback."""
        lead = _lead_dims(stacked_batch)
        if len(lead) > 1:
            raise ValueError(
                "stacked batch has mismatched leading (microstep) dims %s"
                % sorted(lead))
        k = next(iter(lead), 1)
        fn = self.multi_step(k, donate)
        with tel.span("dstep.dispatch", "dstep", fused=True):
            new_state, _, _, metrics = fn(state, {}, {}, stacked_batch)
        self.dispatches += 1
        tel.counter_add("dstep.dispatches")
        return new_state, metrics

    def evaluate(self, state: TrainState, batch):
        """Forward-only metrics: no grads, no optimizer."""
        with torch.no_grad(), tel.span("dstep.evaluate", "dstep"):
            return self._metrics(*self._loss(state.params, batch))

    def gather_params(self, state: TrainState) -> dict:
        """The full params in their original names: this replica's, which
        equal every other's (each device holds them whole, so this is the
        state's own mapping, copied shallowly); in step_fn mode the user's
        state tree itself."""
        if self.model_item.step_fn is not None:
            return state.params
        return dict(state.params)

    def gather_opt_state(self, state: TrainState):
        """The optimizer state in the original names and layout: this
        replica's, which equals every other's (the state's own tensors,
        on the device)."""
        return state.opt_state

    def gather_sync_state(self, state: TrainState):
        """Every replica's compressor state, each leaf ``[N, ...]`` with
        row r rank r's (the JAX package keeps this leading device axis in
        its checkpoints): an ``all_gather`` a leaf with more than one
        replica, which every rank must join; the state itself with a
        leading axis of 1 with one replica."""
        def gather(t):
            if self.num_replicas == 1:
                return t[None]
            parts = [torch.empty_like(t) for _ in range(self.num_replicas)]
            dist.all_gather(parts, t.contiguous())
            return torch.stack(parts)
        return pytree.tree_map(gather, state.sync_state)

    def close(self):
        """Drop the captured supersteps and their memory."""
        self._graphs.clear()

    def pull_ps(self) -> dict:
        """Current host-PS values: none in this slice."""
        return {}

    def _one_replica(self, what: str):
        if self.num_replicas > 1:
            raise NotImplementedError(
                "%s with %d replicas: the port serves on one replica so far "
                "(ROADMAP A item 10)" % (what, self.num_replicas))

    def _run(self, fn, state, payload):
        with torch.inference_mode(), tel.span("dstep.dispatch", "dstep",
                                              fused=False):
            out = fn(state.params, payload)
        tel.counter_add("dstep.dispatches")
        return out

    def predict_program(self, serve_fn: Callable,
                        donate_batch: bool = True,
                        example_batch=None) -> ForwardProgram:
        """The forward-only FETCH program behind the serving engine:
        ``serve_fn(full_params, batch)`` with no grads. Returns
        ``fn(state, ps_vals, batch) -> outputs`` with outputs left on the
        device.

        ``example_batch`` fixes the feed structure and classifies the
        outputs: an output leaf whose leading dim equals the example's
        row count is per-example, judged on the example's own outputs
        (the JAX lowering judges the same rule on abstract shapes; a
        large example makes the leading dim distinctive). ``donate_batch``
        is accepted for signature parity: eager programs free a request's
        buffers when the caller drops them."""
        del donate_batch
        self._one_replica("predict_program")
        if example_batch is None:
            example_batch = self.model_item.example_batch
        _, spec = pytree.tree_flatten(example_batch)
        key = (serve_fn, str(spec))
        if key not in self._predict_progs:
            rows = _leading_rows(example_batch)

            def run(state, ps_vals, batch):
                return self._run(serve_fn, state, batch)

            def classify(state, ps_vals, batch, out):
                if _leading_rows(batch) != rows:
                    from autodist_tpu_torch.remapper import Remapper
                    out = run(state, ps_vals,
                              Remapper(self.device).remap_feed(example_batch))
                return _classify(out, rows)
            self._predict_progs[key] = ForwardProgram(run, classify)
        return self._predict_progs[key]

    def decode_program(self, decode_fn: Callable,
                       example_dstate) -> ForwardProgram:
        """The decode-STEP program behind continuous batching:
        ``decode_fn(full_params, dstate)`` where ``dstate`` carries the
        slot-major KV caches and per-slot token/cursor/alive. The caches
        are updated IN PLACE (the JAX program donates them and returns
        new buffers; eager PyTorch writes the new rows into the same
        storage, so steady-state decode holds one cache allocation).
        Output leaves whose leading dim is the slot count are per-slot."""
        self._one_replica("decode_program")
        _, spec = pytree.tree_flatten(example_dstate)
        key = (decode_fn, str(spec))
        if key not in self._decode_progs:
            slots = _leading_rows(example_dstate)
            self._decode_progs[key] = ForwardProgram(
                lambda state, ps_vals, dstate: self._run(decode_fn, state,
                                                         dstate),
                lambda state, ps_vals, dstate, out: _classify(out, slots))
        return self._decode_progs[key]


class GraphTransformer:
    """Builds the :class:`DistributedStep` for a compiled strategy on this
    process's device (the JAX ``GraphTransformer.transform``).
    ``replica_info`` gives the replica count (the default process group's
    world size) and this process's rank; the plan must name as many
    replicas."""

    def __init__(self, compiled_strategy: Strategy, model_item, device,
                 replica_info: Optional[ReplicaInfo] = None):
        self._strategy = compiled_strategy
        self._item = model_item
        self._device = device
        self._replicas = replica_info or ReplicaInfo()

    def _refuse_unported(self):
        """Plan features whose N > 1 lowering the port has not reached
        raise, naming the ROADMAP item that ports them; none is ignored."""
        gc = self._strategy.graph_config

        def refuse(what, item):
            raise NotImplementedError(
                "%s with %d replicas is not ported yet (ROADMAP A item %d)"
                % (what, self._replicas.num_replicas, item))
        if gc.overlap:
            refuse("overlap=True (the overlapped gradient-sync schedule)", 7)
        if (gc.compute_dtype or "f32") != "f32":
            refuse("compute_dtype=%r" % gc.compute_dtype, 7)
        if gc.mesh_shape or gc.seq_axis or gc.batch_axes:
            refuse("a mesh beyond the data axis (mesh_shape/seq_axis/"
                   "batch_axes)", 9)
        hosts = {r.split(":")[0] for r in gc.replicas}
        for node in self._strategy.node_config:
            if node.partitioner or node.part_configs:
                refuse("the partitioned layout of %s" % node.var_name, 7)
            cfg = node.synchronizer
            if cfg is None or cfg.kind == "PS":
                refuse("the PS synchronizer of %s" % node.var_name, 8)
            if cfg.kind != "AllReduce":
                refuse("the %s synchronizer of %s" % (cfg.kind,
                                                      node.var_name), 7)
            if cfg.schedule == "rhd":
                refuse("schedule='rhd' on %s" % node.var_name, 7)
            if (cfg.schedule == "hier" or cfg.spec == "DCN") and \
                    len(hosts) > 1:
                refuse("the hierarchical psum (schedule='hier' or "
                       "spec='DCN' across hosts) on %s" % node.var_name, 7)

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

    def transform(self) -> DistributedStep:
        replicas = len(self._strategy.graph_config.replicas)
        if replicas != self._replicas.num_replicas:
            raise ValueError(
                "the plan has %d replicas but the process group has %d "
                "ranks: describe one replica a rank in the resource spec "
                "(two ranks sharing one card list its index twice)"
                % (replicas, self._replicas.num_replicas))
        if self._item.step_fn is not None:
            self._check_step_fn(replicas)
        elif replicas > 1:
            self._refuse_unported()
        return DistributedStep(strategy=self._strategy,
                               model_item=self._item, device=self._device,
                               metadata={"replicas": replicas},
                               replica_info=self._replicas)
