"""Rule-based static analysis over ``(Strategy, ModelItem, ResourceSpec)``:
the port's copy of ``autodist_tpu/analysis/rules.py``.

The verifier proves a Strategy well-formed *before* the lowering sees it,
so bad plans surface as typed :class:`Diagnostic` lists instead of
``ValueError`` tracebacks deep in ``kernel/partitioner.py`` or collective
deadlocks at run time.

Layout:

- each ``@rule`` function inspects one aspect and yields Diagnostics;
- :func:`verify` runs them all and returns the sorted findings
  (``AutoDist(validate=...)`` runs it before every build, the simulator
  before it prices a candidate);
- the *shared* check functions (``check_partitioner_node``,
  ``check_mp_axes_node``, ``missing_trainable_configs``) are the ones the
  compile path raises from (``strategy/base.py``,
  ``kernel/partitioner.py``), so lint time and compile time agree;
- the lints the runtime calls on its own: ``verify_numerics``
  (ADT601-604), ``verify_sentinel`` (ADT420/421), ``verify_elastic``
  (ADT430/431), ``verify_preemption`` (ADT432), ``verify_autoscale``
  (ADT440/441) and ``verify_decode`` (ADT442).

Where the port lays a variable out otherwise than flax does (a
DenseGeneral kernel the port holds 2-D, a bias it holds 1-D), each rule
reads the layout the code it guards acts on: the partitioner checks read
``VarInfo.flax_shape`` (the partitioned builders and the partitioner
split the JAX layout), the compressor checks read ``VarInfo.shape`` (the
port's compressors act on the port's tensors).

``model_item`` may be a full ``ModelItem`` or anything exposing
``var_infos`` (name -> ``VarInfo``); rules stay pure and cheap — the
auto-strategy search calls :func:`verify` once per candidate to prune
un-compilable plans without building them.
"""
from typing import Dict, Iterable, List, Optional, Tuple

from autodist_tpu_torch import const
from autodist_tpu_torch.analysis import partition as partition_lib
from autodist_tpu_torch.analysis.diagnostics import (Diagnostic,
                                                     DiagnosticError, error,
                                                     info, sort_diagnostics,
                                                     warning)
from autodist_tpu_torch.analysis.memory import GIB

# Axis names the framework's meshes understand (parallel/mesh.py builds
# meshes from these; an unknown name silently materializes nothing).
KNOWN_MESH_AXES = (const.DATA_AXIS, const.MODEL_AXIS, const.PIPELINE_AXIS,
                   const.SEQUENCE_AXIS, const.EXPERT_AXIS)

_PIPELINE_SCHEDULES = ("gpipe", "1f1b", "interleaved")


# ------------------------------------------------------------------ context


class Context:
    """Everything the rules need, computed once per :func:`verify` call."""

    def __init__(self, strategy, model_item, resource_spec):
        self.strategy = strategy
        self.spec = resource_spec
        self.var_infos = dict(getattr(model_item, "var_infos", None)
                              or (model_item if isinstance(model_item, dict)
                                  else {}))
        self.trainable = {n for n, v in self.var_infos.items()
                          if getattr(v, "trainable", True)}
        gc = strategy.graph_config
        self.replicas = list(gc.replicas)
        self.mesh_shape = dict(gc.mesh_shape or {})
        # device universe, canonicalized like kernel/device/resolver.py
        from autodist_tpu_torch.resource_spec import DeviceSpec
        self.device_names = set()
        self.cpu_names = set()
        if resource_spec is not None:
            self.device_names = {d.name_string()
                                 for d in resource_spec.devices}
            self.cpu_names = {d.name_string()
                              for d in resource_spec.cpu_devices}
        self._canon = DeviceSpec.from_string

    def canonical(self, name: str) -> Optional[str]:
        """Canonical ``host:TYPE:index`` or None when unparseable."""
        try:
            return self._canon(name).name_string()
        except (ValueError, KeyError, IndexError):
            return None

    def synchronizers(self, node) -> List[Tuple[str, object]]:
        """(owning var name, synchronizer) pairs for one strategy node —
        the node's own synchronizer, or its shards'."""
        out = []
        if node.synchronizer is not None:
            out.append((node.var_name, node.synchronizer))
        for part in node.part_configs:
            if part.synchronizer is not None:
                out.append((part.var_name or node.var_name,
                            part.synchronizer))
        return out

    def mesh_axis_sizes(self) -> Dict[str, int]:
        """mesh_shape, or the implicit data-only mesh of a DP strategy."""
        if self.mesh_shape:
            return dict(self.mesh_shape)
        return {const.DATA_AXIS: max(len(self.replicas), 1)}


# ----------------------------------------------------------- rule registry

_RULES = []


def rule(fn):
    _RULES.append(fn)
    return fn


def verify(strategy, model_item, resource_spec) -> List[Diagnostic]:
    """Run every rule; returns diagnostics sorted most-severe-first.

    Pure and trace-free: safe to call per candidate in the auto-strategy
    search, from the CLI, or from ``AutoDist(validate=...)`` before the
    kernels ever see the plan.
    """
    ctx = Context(strategy, model_item, resource_spec)
    out: List[Diagnostic] = []
    for r in _RULES:
        out.extend(r(ctx))
    return sort_diagnostics(out)


# ------------------------------------------------- shared check functions
# (imported by strategy/base.py and kernel/partitioner.py — the compile
# path raises DiagnosticError from the FIRST error these return)


def missing_trainable_configs(strategy, trainable_names) -> List[str]:
    """Trainable variables the strategy has no node for (ADT101).

    The single implementation behind both the linter rule and
    ``StrategyCompiler.compile``'s hard failure."""
    have = {n.var_name for n in strategy.node_config}
    return sorted(set(trainable_names) - have)


def check_partitioner_node(node, shape) -> List[Diagnostic]:
    """ADT2xx checks for one node's ``partitioner`` string against the
    variable's shape (``shape`` may be None when unknown)."""
    out: List[Diagnostic] = []
    if not node.partitioner:
        return out
    try:
        counts = partition_lib.parse_partitioner(node.partitioner,
                                                 node.var_name)
    except DiagnosticError as e:
        return [e.diagnostic]
    split_axes = partition_lib.split_axes_of(counts)
    if len(split_axes) > 1:
        out.append(error(
            "ADT204",
            "partitioner %r splits %d axes; the lowering supports exactly "
            "one split axis" % (node.partitioner, len(split_axes)),
            var=node.var_name,
            fixit="keep one count > 1, e.g. %r"
                  % ",".join(str(c) if i == split_axes[0] else "1"
                             for i, c in enumerate(counts))))
    if shape is not None and len(counts) != max(len(shape), 1):
        out.append(error(
            "ADT202",
            "partitioner %r has %d axis counts but the variable has rank %d"
            % (node.partitioner, len(counts), len(shape)),
            var=node.var_name,
            fixit="emit one count per tensor axis (scalars use a single "
                  "count)"))
    num_shards = partition_lib.num_shards_of(counts)
    if node.part_configs and len(node.part_configs) != num_shards:
        out.append(error(
            "ADT109",
            "partitioner %r implies %d shards but the node carries %d "
            "part_configs" % (node.partitioner, num_shards,
                              len(node.part_configs)),
            var=node.var_name,
            fixit="emit exactly one part config per shard"))
    if (shape is not None and split_axes
            and not any(d.code == "ADT202" for d in out)):
        axis = split_axes[0]
        if axis < len(shape):
            dim = shape[axis]
            if dim < num_shards:
                out.append(warning(
                    "ADT203",
                    "split dim %d (size %d) has fewer rows than %d shards; "
                    "the partitioner will keep the variable replicated"
                    % (axis, dim, num_shards), var=node.var_name,
                    fixit="drop the partitioner or split a larger axis"))
            elif dim % num_shards != 0 and not node.shard_sizes:
                out.append(info(
                    "ADT209",
                    "split dim %d (size %d) is not divisible by %d shards; "
                    "device storage pads to the next multiple"
                    % (axis, dim, num_shards), var=node.var_name))
    if node.shard_sizes is not None and shape is not None and split_axes:
        axis = split_axes[0]
        dim = shape[axis] if axis < len(shape) else None
        if len(node.shard_sizes) != num_shards:
            out.append(error(
                "ADT208",
                "shard_sizes has %d entries for %d shards"
                % (len(node.shard_sizes), num_shards), var=node.var_name,
                fixit="emit one size per shard"))
        elif dim is not None and sum(node.shard_sizes) != dim:
            out.append(error(
                "ADT208",
                "shard_sizes %s sums to %d but split dim %d has size %d"
                % (list(node.shard_sizes), sum(node.shard_sizes), axis, dim),
                var=node.var_name,
                fixit="make the sizes sum to the split dimension"))
    return out


def check_mp_axes_node(var_name: str, mp_axes: Dict[int, str], shape,
                       mesh_axis_sizes: Dict[str, int]) -> List[Diagnostic]:
    """ADT205/206/207 for one node's model-parallel ``mp_axes`` spec.

    The function ``kernel/partitioner.VariablePartitioner`` raises from,
    so the lint table and the compile error agree."""
    out: List[Diagnostic] = []
    seen_axes: Dict[str, int] = {}
    for dim, ax_name in sorted(mp_axes.items()):
        size = mesh_axis_sizes.get(ax_name)
        if size is None:
            out.append(error(
                "ADT205",
                "mp axis %r not in mesh %s" % (ax_name, mesh_axis_sizes),
                var=var_name,
                fixit="add the axis to graph_config.mesh_shape or shard "
                      "over an existing axis"))
            continue
        if ax_name in seen_axes:
            out.append(error(
                "ADT207",
                "mesh axis %r shards both dim %d and dim %d of the same "
                "variable" % (ax_name, seen_axes[ax_name], dim),
                var=var_name,
                fixit="shard each mesh axis over at most one tensor dim"))
        seen_axes[ax_name] = dim
        if shape is not None and (dim >= len(shape)
                                  or shape[dim] % size != 0):
            out.append(error(
                "ADT206",
                "dim %d (shape %s) not divisible by mesh axis %r size %d"
                % (dim, tuple(shape), ax_name, size), var=var_name,
                fixit="model-parallel storage needs exact divisibility "
                      "(no padding): adjust the mesh axis size or the "
                      "model dimension"))
    return out


def check_compressor_name(name: str, var_name: str = "") -> List[Diagnostic]:
    """ADT305 for one compressor name (shared with the factory path)."""
    if not name:
        return []
    from autodist_tpu_torch.kernel.synchronization import \
        compressor as comp_lib
    try:
        comp_lib.validate_name(name)
    except ValueError as e:
        return [error("ADT305", str(e), var=var_name,
                      fixit="pick one of %s (PowerSGD takes a rank "
                            "suffix, e.g. 'PowerSGDCompressor:2')"
                            % sorted(comp_lib.known_names()))]
    return []


# ------------------------------------------------------------- ADT1xx rules


@rule
def _r_missing_configs(ctx: Context) -> Iterable[Diagnostic]:
    for name in missing_trainable_configs(ctx.strategy, ctx.trainable):
        yield error(
            "ADT101", "trainable variable has no strategy node", var=name,
            fixit="emit a VarConfig for every trainable variable (or mark "
                  "it frozen via trainable_filter)")


@rule
def _r_unknown_and_duplicate(ctx: Context) -> Iterable[Diagnostic]:
    seen = set()
    for node in ctx.strategy.node_config:
        if node.var_name in seen:
            yield error("ADT103",
                        "duplicate strategy node for one variable",
                        var=node.var_name,
                        fixit="emit exactly one VarConfig per variable")
        seen.add(node.var_name)
        if ctx.var_infos and node.var_name not in ctx.var_infos:
            yield warning(
                "ADT102",
                "strategy node references a variable the model does not "
                "have (the compiler will prune it)", var=node.var_name)


@rule
def _r_replicas(ctx: Context) -> Iterable[Diagnostic]:
    if not ctx.replicas:
        yield error("ADT104", "strategy has no replica devices",
                    fixit="set graph_config.replicas to the compute "
                          "devices of the resource spec")
        return
    if ctx.spec is None:
        return
    for name in ctx.replicas:
        canon = ctx.canonical(name)
        if canon is None or (canon not in ctx.device_names
                             and canon not in ctx.cpu_names):
            yield error(
                "ADT105",
                "replica device %r is not in the resource spec (has %d "
                "devices)" % (name, len(ctx.device_names)), var="",
                fixit="build replicas from resource_spec.devices")


@rule
def _r_mesh_shape(ctx: Context) -> Iterable[Diagnostic]:
    if not ctx.mesh_shape:
        return
    product = 1
    for ax, size in ctx.mesh_shape.items():
        if ax not in KNOWN_MESH_AXES:
            yield warning(
                "ADT107",
                "mesh axis %r is not one the framework materializes %s"
                % (ax, list(KNOWN_MESH_AXES)))
        if int(size) < 1:
            yield error("ADT106", "mesh axis %r has size %d < 1" % (ax, size))
            return
        product *= int(size)
    n = len(ctx.replicas)
    if n and product != n:
        yield error(
            "ADT106",
            "mesh shape %s multiplies out to %d devices but the strategy "
            "has %d replicas" % (ctx.mesh_shape, product, n),
            fixit="make the mesh axis sizes factor the replica count")
    gc = ctx.strategy.graph_config
    if gc.seq_axis and gc.seq_axis not in ctx.mesh_axis_sizes():
        yield error(
            "ADT110",
            "seq_axis %r is not in the mesh %s"
            % (gc.seq_axis, ctx.mesh_axis_sizes()),
            fixit="add the sequence axis to mesh_shape")
    for ax in (gc.batch_axes or []):
        if ax not in ctx.mesh_axis_sizes():
            yield error(
                "ADT110",
                "batch axis %r is not in the mesh %s"
                % (ax, ctx.mesh_axis_sizes()),
                fixit="batch_axes may only name mesh axes")


@rule
def _r_node_shape(ctx: Context) -> Iterable[Diagnostic]:
    for node in ctx.strategy.node_config:
        info_ = ctx.var_infos.get(node.var_name)
        trainable = (node.var_name in ctx.trainable) if ctx.var_infos else True
        if (trainable and node.synchronizer is None and not node.part_configs
                and not node.mp_axes):
            yield error(
                "ADT108",
                "trainable node carries no synchronizer, shards, or "
                "mp_axes — the lowering cannot synchronize its gradient",
                var=node.var_name,
                fixit="attach an AllReduceSynchronizer or PSSynchronizer")
        shape = tuple(info_.shape) if info_ is not None else None
        # partitioner strings count the JAX layout's axes (flax's shape),
        # which the partitioned builders and the partitioner split
        flax_shape = (tuple(getattr(info_, "flax_shape", None) or shape)
                      if info_ is not None else None)
        for d in check_partitioner_node(node, flax_shape):
            yield d
        if node.mp_axes:
            for d in check_mp_axes_node(node.var_name, node.mp_axes, shape,
                                        ctx.mesh_axis_sizes()):
                yield d
            if node.partitioner:
                yield warning(
                    "ADT207",
                    "mp_axes and partitioner both set; mp_axes wins "
                    "(ZeRO+MP on one variable is unsupported)",
                    var=node.var_name,
                    fixit="drop the partitioner on model-parallel "
                          "variables")


# ------------------------------------------------------------- ADT3xx rules


def _is_ps(sync) -> bool:
    return getattr(sync, "kind", "") == "PS"


def _is_ar(sync) -> bool:
    return getattr(sync, "kind", "") == "AllReduce"


def _is_zero(sync) -> bool:
    return getattr(sync, "kind", "") == "ZeroSharded"


@rule
def _r_synchronizers(ctx: Context) -> Iterable[Diagnostic]:
    for node in ctx.strategy.node_config:
        info_ = ctx.var_infos.get(node.var_name)
        trainable = (node.var_name in ctx.trainable) if ctx.var_infos else True
        for owner, sync in ctx.synchronizers(node):
            if _is_ps(sync):
                if not sync.reduction_destination:
                    sev = error if trainable else warning
                    yield sev(
                        "ADT302",
                        "PS reduction_destination is empty — no device "
                        "owns this variable's update", var=owner,
                        fixit="set it to a host device, e.g. "
                              "'%s:CPU:0'" % (ctx.spec.chief if ctx.spec
                                              else "<chief>"))
                elif ctx.spec is not None:
                    canon = ctx.canonical(sync.reduction_destination)
                    if canon is None or (canon not in ctx.device_names
                                         and canon not in ctx.cpu_names):
                        yield error(
                            "ADT303",
                            "PS reduction_destination %r is not a device "
                            "of the resource spec"
                            % sync.reduction_destination, var=owner,
                            fixit="use a node address from the spec "
                                  "(host CPUs are valid PS destinations)")
                if sync.staleness < 0:
                    yield error("ADT304",
                                "staleness %d < 0" % sync.staleness,
                                var=owner)
                if sync.staleness > 0 and not sync.sync:
                    yield error(
                        "ADT304",
                        "staleness is a SYNC-training window; async PS "
                        "always reads the latest published version",
                        var=owner, fixit="drop staleness or set sync=True")
            comp = getattr(sync, "compressor", "") or ""
            comp_diags = check_compressor_name(comp, owner)
            for d in comp_diags:
                yield d
            if comp and comp != "NoneCompressor" and not comp_diags:
                if node.partitioner:
                    yield warning(
                        "ADT306",
                        "compressor %s is ignored — partitioned variables "
                        "sync via reduce-scatter" % comp, var=owner,
                        fixit="drop the compressor or the partitioner")
                elif node.mp_axes:
                    yield warning(
                        "ADT306",
                        "compressor %s is ignored — model-parallel "
                        "gradients reduce uncompressed over the "
                        "complement axes" % comp, var=owner)
                elif info_ is not None and getattr(info_, "sparse", False):
                    yield warning(
                        "ADT306",
                        "compressor %s is ignored — sparse-wire gradients "
                        "ship as (ids, values) pairs, already batch-sized"
                        % comp, var=owner)
                elif comp.split(":")[0] == "PowerSGDCompressor" and (
                        info_ is not None and len(info_.shape) < 2):
                    yield warning(
                        "ADT308",
                        "PowerSGD on a rank-%d tensor passes through "
                        "uncompressed" % len(info_.shape), var=owner)
                elif info_ is not None and not str(
                        getattr(info_, "dtype", "float32")).startswith(
                            ("float", "bfloat")):
                    yield warning(
                        "ADT306",
                        "compressor %s has no effect on dtype %s — the "
                        "reduced-precision cast only applies to float "
                        "gradients" % (comp, info_.dtype), var=owner)


@rule
def _r_async_all_or_nothing(ctx: Context) -> Iterable[Diagnostic]:
    """Mirror of ``AutoDist._validate_async``: async PS must be PURE
    host-PS — every trainable variable on the no-proxy PS path, no
    model-parallel mesh (collectives are lockstep)."""
    all_syncs = []
    for node in ctx.strategy.node_config:
        trainable = (node.var_name in ctx.trainable) if ctx.var_infos else True
        if not trainable:
            continue
        for owner, sync in ctx.synchronizers(node):
            all_syncs.append((node, owner, sync))
    is_async = any(_is_ps(s) and not s.sync for _, _, s in all_syncs)
    if not is_async:
        return
    for node, owner, sync in all_syncs:
        if _is_ar(sync) or _is_zero(sync):
            yield error(
                "ADT307",
                "async PS is all-or-nothing: this variable rides %s "
                "while others are async"
                % ("ZeroSharded" if _is_zero(sync) else "AllReduce"),
                var=owner,
                fixit="route every trainable variable through "
                      "PS(sync=False)")
        elif _is_ps(sync) and sync.sync:
            yield error(
                "ADT307",
                "async PS is all-or-nothing: this variable requests "
                "sync=True", var=owner,
                fixit="set sync=False on every variable or none")
        elif _is_ps(sync) and sync.local_replication:
            yield error(
                "ADT307",
                "async PS cannot use proxy (local_replication) variables "
                "— they are not host-resident", var=owner,
                fixit="set local_replication=False for async training")
    if ctx.mesh_shape:
        yield error(
            "ADT307",
            "async PS cannot combine with model-parallel mesh axes "
            "(collectives are lockstep); mesh %s" % ctx.mesh_shape,
            fixit="drop mesh_shape or train synchronously")


@rule
def _r_sparse_dense_path(ctx: Context) -> Iterable[Diagnostic]:
    """Sparse (embedding) variables on dense-only sync paths: their
    gradient is batch-row-sized, and a partitioned reduce-scatter (ZeRO)
    densifies it to the full table every step."""
    require = bool(ctx.strategy.graph_config.require_sparse)
    for node in ctx.strategy.node_config:
        info_ = ctx.var_infos.get(node.var_name)
        if info_ is None or not getattr(info_, "sparse", False):
            continue
        if not getattr(info_, "trainable", True):
            continue
        syncs = [s for _, s in ctx.synchronizers(node)]
        dense_partitioned = node.partitioner and any(_is_ar(s) for s in syncs)
        if dense_partitioned:
            sev = error if require else warning
            yield sev(
                "ADT309",
                "sparse (gather-indexed) variable is partitioned with "
                "AllReduce sync — the reduce-scatter densifies its "
                "row-sparse gradient to the full table every step",
                var=node.var_name,
                fixit="route embeddings to PS (Parallax) or keep them "
                      "unpartitioned so the (ids, values) sparse wire "
                      "engages")


@rule
def _r_wire_dtype(ctx: Context) -> Iterable[Diagnostic]:
    """Quantized-wire (``wire_dtype="int8"``) validity: the blockwise
    int8 codec only exists for dense float payloads on wires the lowering
    actually quantizes — sparse (ids, values) pairs have no absmax
    blocks, integer values no scale, and the partitioned / proxied /
    model-parallel paths never cross the quantized wire. A variable
    smaller than one scale block pays more sidecar than it saves
    (ADT311)."""
    from autodist_tpu_torch.parallel.collectives import wire_block_size
    block = wire_block_size()
    for node in ctx.strategy.node_config:
        info_ = ctx.var_infos.get(node.var_name)
        for owner, sync in ctx.synchronizers(node):
            wd = getattr(sync, "wire_dtype", "fp32") or "fp32"
            if wd == "fp32":
                continue
            if wd != "int8":
                yield error(
                    "ADT310",
                    "unknown wire_dtype %r (allowed: fp32, int8)" % wd,
                    var=owner, fixit="use wire_dtype='int8' or drop it")
                continue
            if info_ is not None and getattr(info_, "sparse", False):
                yield error(
                    "ADT310",
                    "wire_dtype=int8 on a sparse variable — its gradient "
                    "ships as (ids, values) pairs, which the blockwise "
                    "codec cannot quantize", var=owner,
                    fixit="drop wire_dtype; the sparse wire is already "
                          "batch-sized")
                continue
            if info_ is not None and not str(
                    getattr(info_, "dtype", "float32")).startswith(
                        ("float", "bfloat")):
                yield error(
                    "ADT310",
                    "wire_dtype=int8 on dtype %s — absmax scaling only "
                    "exists for float payloads" % info_.dtype, var=owner,
                    fixit="drop wire_dtype on integer variables")
                continue
            comp = getattr(sync, "compressor", "") or ""
            if _is_ar(sync) and comp and comp != "NoneCompressor":
                yield error(
                    "ADT310",
                    "wire_dtype=int8 conflicts with compressor %s — the "
                    "wire codec and the gradient compressor both own the "
                    "payload transform" % comp, var=owner,
                    fixit="keep one: wire_dtype='int8' (blockwise wire "
                          "codec) or the compressor")
                continue
            if _is_ar(sync) and node.partitioner:
                yield warning(
                    "ADT310",
                    "wire_dtype=int8 is ignored — partitioned variables "
                    "sync via reduce-scatter, which the wire codec does "
                    "not cover", var=owner,
                    fixit="drop the partitioner or the wire_dtype")
                continue
            if node.mp_axes:
                yield warning(
                    "ADT310",
                    "wire_dtype=int8 is ignored — model-parallel "
                    "gradients reduce uncompressed over the complement "
                    "axes", var=owner)
                continue
            if _is_ps(sync) and sync.local_replication:
                yield warning(
                    "ADT310",
                    "wire_dtype=int8 is ignored — a proxied PS variable "
                    "is device-resident, no host wire exists", var=owner,
                    fixit="set local_replication=False for the host wire")
                continue
            if info_ is not None and info_.num_elements < block:
                yield warning(
                    "ADT311",
                    "quantizing a %d-element variable with %d-element "
                    "scale blocks: the padded block + f32 sidecar "
                    "outweighs the int8 saving"
                    % (info_.num_elements, block), var=owner,
                    fixit="keep variables smaller than one block "
                          "(ADT_WIRE_BLOCK=%d) on the fp32 wire" % block)


@rule
def _r_zero_sharded(ctx: Context) -> Iterable[Diagnostic]:
    """ZeRO-sharded update (``ZeroShardedSynchronizer``) validity.

    - ``ADT312`` (error): combinations the sharded update cannot lower —
      sparse variables (the reduce-scatter densifies the batch-row-sized
      gradient to the full table), ``mp_axes``/``partitioner`` storage on
      the same variable (the flat shard math owns the whole value), and
      mixing ZeroSharded with stale/async PS variables (the rs+ag pair
      is a lockstep collective every step; decoupled peers deadlock or
      apply against drifted params).
    - ``ADT313`` (warning): a variable smaller than one per-replica
      shard — the padding and two collective launches exceed the
      opt-state saving; keep it on plain AllReduce."""
    from autodist_tpu_torch.strategy.zero_sharded_strategy import \
        zero_shardable
    n_data = int(ctx.mesh_axis_sizes().get(const.DATA_AXIS,
                                           max(len(ctx.replicas), 1)))
    zero_owners = []
    decoupled_ps = []
    for node in ctx.strategy.node_config:
        info_ = ctx.var_infos.get(node.var_name)
        for owner, sync in ctx.synchronizers(node):
            if _is_ps(sync) and (not sync.sync or sync.staleness > 0):
                decoupled_ps.append(owner)
            if not _is_zero(sync):
                continue
            zero_owners.append(owner)
            if info_ is not None and getattr(info_, "sparse", False):
                yield error(
                    "ADT312",
                    "ZeroSharded on a sparse (gather-indexed) variable — "
                    "the reduce-scatter densifies its batch-row-sized "
                    "gradient to the full table every step", var=owner,
                    fixit="route embeddings to PS (Parallax) or plain "
                          "AllReduce so the (ids, values) sparse wire "
                          "engages")
            if node.mp_axes:
                yield error(
                    "ADT312",
                    "ZeroSharded cannot combine with mp_axes storage — "
                    "the sharded update owns the whole flat variable",
                    var=owner,
                    fixit="drop one: model-parallel storage or the "
                          "sharded update")
            if node.partitioner:
                yield error(
                    "ADT312",
                    "ZeroSharded cannot combine with a partitioner — "
                    "partitioned storage already shards the update "
                    "(reduce-scatter path)", var=owner,
                    fixit="drop the partitioner (ZeroSharded shards the "
                          "flat variable itself)")
            if (info_ is not None and not node.mp_axes
                    and not node.partitioner
                    and not getattr(info_, "sparse", False)
                    and not zero_shardable(info_, n_data)):
                yield warning(
                    "ADT313",
                    "ZeroSharded on a %d-element variable with %d "
                    "replicas: each shard is smaller than one element — "
                    "the padding + rs/ag launches outweigh the opt-state "
                    "saving" % (getattr(info_, "num_elements", 0), n_data),
                    var=owner,
                    fixit="keep variables smaller than one per-replica "
                          "shard on plain AllReduce")
    if zero_owners and decoupled_ps:
        yield error(
            "ADT312",
            "ZeroSharded vars %s mix with stale/async PS vars %s: the "
            "sharded update's rs+ag pair is a lockstep collective every "
            "step, but a stale/async PS window lets peers run decoupled "
            "steps" % (sorted(set(zero_owners))[:3],
                       sorted(set(decoupled_ps))[:3]),
            var=zero_owners[0],
            fixit="use sync staleness=0 PS beside ZeroSharded, or keep "
                  "the whole plan on one discipline")


# ----------------------------------------------------- ADT6xx numerics rules

_COMPUTE_DTYPES = ("f32", "bf16")


def _stored_half(info_) -> bool:
    """Is this variable's RESIDENT storage half precision? (``VarInfo``
    dtypes stringify as numpy names: ``bfloat16`` / ``float16``.)"""
    dt = str(getattr(info_, "dtype", "float32"))
    return "bfloat16" in dt or "float16" in dt


@rule
def _r_numerics(ctx: Context) -> Iterable[Diagnostic]:
    """ADT601/ADT602 at plan level — the f32-master discipline, provable
    before any trace (docs/performance.md):

    - a trainable variable STORED in bf16/f16 accumulates its gradient in
      that dtype (psum / PS-sum of half words — ADT601) *and* has no
      authoritative f32 copy to update (ADT602). ``ZeroSharded`` is
      exempt from both: its flat-shard math runs in f32 (``_pad_flat``
      casts up before the reduce-scatter) and the sharded optimizer step
      owns an f32 view — the arXiv 2004.13336 contract.
    - the managed bf16 tier (``compute_dtype="bf16"``) keeps params f32
      and casts a COPY down inside the loss, so it trips neither; an
      unknown tier is an ADT602 error because the lowering can guarantee
      nothing about it.
    """
    gc = ctx.strategy.graph_config
    cd = getattr(gc, "compute_dtype", "f32") or "f32"
    if cd not in _COMPUTE_DTYPES:
        yield error(
            "ADT602",
            "unknown compute_dtype %r (allowed: %s) — the lowering "
            "cannot guarantee an f32 master for an unknown compute tier"
            % (cd, "/".join(_COMPUTE_DTYPES)),
            fixit="use compute_dtype='bf16' (f32 master, bf16 compute) "
                  "or leave it 'f32'")
    for node in ctx.strategy.node_config:
        info_ = ctx.var_infos.get(node.var_name)
        if info_ is None or node.var_name not in ctx.trainable:
            continue
        if not _stored_half(info_):
            continue
        syncs = [s for _, s in ctx.synchronizers(node)]
        if syncs and all(_is_zero(s) for s in syncs):
            continue  # f32 shard math + f32 opt state: master survives
        dt = str(getattr(info_, "dtype", ""))
        yield error(
            "ADT601",
            "trainable %r is stored in %s: its gradient accumulates in "
            "half precision (every psum/PS-sum hop rounds the running "
            "sum)" % (node.var_name, dt), var=node.var_name,
            fixit="store params in f32 and set compute_dtype='bf16' "
                  "(the lowering casts a copy down for compute), or "
                  "sync via ZeroSharded (f32 shard accumulation)")
        yield error(
            "ADT602",
            "trainable %r is stored in %s with no f32 master copy — "
            "every optimizer apply rounds into the only copy of the "
            "weights" % (node.var_name, dt), var=node.var_name,
            fixit="keep the resident params f32 (compute_dtype='bf16' "
                  "gives the speed without losing the master), or use "
                  "ZeroSharded for an f32-sharded update")


def verify_numerics(strategy, model_item=None, resource_spec=None,
                    sentinel_policy=None, metadata=None) -> List[Diagnostic]:
    """ADT6xx — full plan-level numerics verdict for one strategy, no
    trace/lower/compile (the ADT501 pattern). Runs the registered
    ADT601/602 rule plus the two checks that need context :func:`verify`
    does not carry:

    - ``ADT603`` (warning): half-stored params WITHOUT the managed bf16
      tier — the loss inherits the compute dtype, so the value the
      divergence sentinel's EWMA judges is rounded before it is seen.
      (The managed tier casts the loss to f32 by construction, so
      ``compute_dtype="bf16"`` alone never trips this.)
    - ``ADT604`` (warning): half-precision compute armed with no enabled
      sentinel policy — aggressive precision with no skip/rollback net.

    ``metadata`` (a lowered ``DistributedStep.metadata``) is optional; it
    only sharpens messages, never gates a finding.
    """
    ctx = Context(strategy, model_item, resource_spec)
    out = list(_r_numerics(ctx))
    gc = strategy.graph_config
    cd = getattr(gc, "compute_dtype", "f32") or "f32"
    half_vars = sorted(
        n.var_name for n in strategy.node_config
        if n.var_name in ctx.trainable
        and _stored_half(ctx.var_infos.get(n.var_name)))
    half_armed = cd == "bf16" or bool(half_vars)
    if half_vars and cd != "bf16":
        out.append(warning(
            "ADT603",
            "loss/verdict will be computed in half precision: trainable "
            "%s stored in bf16/f16 without the managed compute tier — "
            "the sentinel's EWMA judges rounded loss values"
            % (half_vars[:3],), var=half_vars[0],
            fixit="store params f32 with compute_dtype='bf16' (the "
                  "lowering keeps the loss f32)"))
    if half_armed and not getattr(sentinel_policy, "enabled", False):
        out.append(warning(
            "ADT604",
            "half-precision compute (%s) is armed without an enabled "
            "sentinel policy — a loss spike from precision loss has no "
            "skip/rollback net"
            % ("compute_dtype=bf16" if cd == "bf16"
               else "bf16/f16 params"),
            fixit="arm SentinelPolicy(enabled=True) (docs/sentinel.md) "
                  "when training in half precision"))
    return sort_diagnostics(out)


# ------------------------------------------------------------- ADT4xx rules


@rule
def _r_pipeline(ctx: Context) -> Iterable[Diagnostic]:
    gc = ctx.strategy.graph_config
    stages = int(ctx.mesh_shape.get(const.PIPELINE_AXIS, 1))
    sched = gc.pp_schedule
    m = int(gc.pp_microbatches or 0)
    if sched is not None and sched not in _PIPELINE_SCHEDULES:
        yield error(
            "ADT402",
            "unknown pipeline schedule %r (have %s)"
            % (sched, list(_PIPELINE_SCHEDULES)))
        return
    if sched and stages <= 1:
        yield warning(
            "ADT402",
            "pp_schedule=%r set but the mesh has no %r axis — the "
            "schedule never engages" % (sched, const.PIPELINE_AXIS),
            fixit="add the pipeline axis to mesh_shape or drop the "
                  "schedule")
    if stages > 1:
        if m < 1:
            yield warning(
                "ADT401",
                "%d pipeline stages with no pp_microbatches recorded — "
                "the cost model prices a full bubble" % stages,
                fixit="set graph_config.pp_microbatches")
        elif m < stages:
            bubble = (stages - 1) / (stages - 1 + m)
            yield warning(
                "ADT401",
                "%d microbatches over %d stages leaves a %.0f%% fill/"
                "drain bubble" % (m, stages, 100 * bubble),
                var="", fixit="use at least as many microbatches as "
                              "stages (ideally 4x)")
        if sched == "interleaved":
            if int(gc.pp_virtual or 0) < 2:
                yield error(
                    "ADT402",
                    "interleaved schedule needs pp_virtual >= 2 (got %r)"
                    % gc.pp_virtual)
            if m and m % stages != 0:
                yield error(
                    "ADT402",
                    "interleaved schedule needs pp_microbatches (%d) "
                    "divisible by the stage count (%d)" % (m, stages))


@rule
def _r_ps_load_balance(ctx: Context) -> Iterable[Diagnostic]:
    load: Dict[str, float] = {}
    for node in ctx.strategy.node_config:
        info_ = ctx.var_infos.get(node.var_name)
        if info_ is None:
            continue
        syncs = [s for _, s in ctx.synchronizers(node)]
        ps = [s for s in syncs if _is_ps(s) and s.reduction_destination]
        for s in ps:
            host = str(s.reduction_destination).split(":")[0]
            load[host] = load.get(host, 0.0) + (
                float(getattr(info_, "byte_size", 0)) / max(len(ps), 1))
    if len(load) >= 2:
        total = sum(load.values())
        worst_host, worst = max(load.items(), key=lambda kv: kv[1])
        # with k hosts a balanced plan puts 1/k of the bytes on each; one
        # host carrying >75% of the total will bottleneck the push/pull
        # phase no matter how many peers idle beside it
        if total > 0 and worst / total > 0.75:
            yield warning(
                "ADT403",
                "PS host %s carries %.0f%% of the parameter bytes across "
                "%d PS hosts — it will bottleneck the push/pull phase"
                % (worst_host, 100.0 * worst / total, len(load)),
                fixit="use PSLoadBalancing or partition the heavy "
                      "variables")


def verify_sentinel(policy, metadata: dict) -> List[Diagnostic]:
    """ADT42x — health-sentinel configuration hazards, checked against a
    lowered step's metadata (``DistributedStep.metadata``); the Runner
    runs this whenever a policy is armed.

    - ``ADT420``: the policy is active but the step carries no health
      guards (step_fn capture mode) — NaN/Inf detection and the skip
      inside the step are unavailable; the sentinel degrades to host-side
      loss monitoring, which can only roll back, never skip.
    - ``ADT421``: a stale/async PS apply window larger than the
      sentinel's skip window — a peer's delayed push can land a poisoned
      gradient AFTER the window that judged those steps closed, so a bad
      update can slip past the skip budget's accounting.
    """
    out: List[Diagnostic] = []
    if policy is None or not getattr(policy, "enabled", False):
        return out
    metadata = metadata or {}
    if not metadata.get("sentinel_guards", False):
        out.append(warning(
            "ADT420",
            "sentinel policy is active but the lowered program has no "
            "in-graph health guards — gradient/param NaN detection and "
            "the in-graph skip are unavailable (loss-only monitoring)",
            fixit="build with loss_fn mode (AutoDist.build) so the "
                  "guards compile into the step"))
    window = int(metadata.get("staleness", 0) or 0)
    if metadata.get("async"):
        window = max(window, int(const.ENV.ADT_PS_MAX_LAG.val))
    if window > int(policy.window_steps):
        out.append(warning(
            "ADT421",
            "PS apply window (%d steps stale/async lag) exceeds the "
            "sentinel skip window (%d steps) — a delayed poisoned push "
            "can apply after its window's verdict accounting closed"
            % (window, policy.window_steps),
            fixit="raise SentinelPolicy.window_steps above the "
                  "staleness/lag bound, or tighten the PS window"))
    return out


def fail_fast_model_axes(strategy) -> dict:
    """The model-parallel mesh axes (of size > 1) that make a topology
    fail-fast for in-run shrink (ADT430): one predicate, so the lint and
    the coordinator's runtime shrink decision never disagree about what
    "fail-fast" means."""
    mesh_shape = strategy.graph_config.mesh_shape or {}
    return {ax: n for ax, n in mesh_shape.items()
            if ax != const.DATA_AXIS and int(n) > 1}


def verify_elastic(strategy, dead_worker: str = "") -> List[Diagnostic]:
    """ADT43x — can this job's topology survive an in-run elastic shrink
    (``runtime/elastic.py``)? Shared by the build-time lint and the
    coordinator's runtime shrink decision (``_shrink_unsound_reason``).

    - ``ADT430``: the strategy pins model-parallel mesh axes — the
      program spans the whole mesh, and removing a process removes
      shards no survivor replicates. Recovery goes through the whole-job
      checkpoint restart instead.
    - ``ADT431``: a PS group's ``reduction_destination`` lives on the dead
      worker — its host-resident state died with it, so the shrink is
      sound only with a committed checkpoint to fall back to.
    """
    out: List[Diagnostic] = []
    model_axes = fail_fast_model_axes(strategy)
    if model_axes:
        out.append(warning(
            "ADT430",
            "strategy partitions state over model-parallel mesh axes %s — "
            "removing a process removes shards no survivor replicates, so "
            "the job cannot shrink in-run" % (model_axes,),
            fixit="rely on the whole-job checkpoint restart "
                  "(ADT_ELASTIC_SYNC without ADT_ELASTIC_INRUN), or use a "
                  "data-parallel strategy for in-run elasticity"))
    dead_host = (dead_worker or "").split(":")[0]
    for node in strategy.node_config:
        for leaf in (node.part_configs or [node]):
            sync = leaf.synchronizer or node.synchronizer
            dest = getattr(sync, "reduction_destination", "") or ""
            if dead_host and dest.split(":")[0] == dead_host:
                out.append(warning(
                    "ADT431",
                    "PS group of %r is owned by dying worker %s — its "
                    "host-resident state has no live replica; the shrink "
                    "must re-shard that state from the last-good "
                    "checkpoint" % (node.var_name, dead_worker),
                    var=node.var_name,
                    fixit="keep PS destinations on the chief, or "
                          "checkpoint at least once per restart window"))
                break
    return out


def verify_preemption(strategy) -> List[Diagnostic]:
    """ADT432 — preemption handoff armed on a topology the elasticity
    matrix marks fail-fast. The planned-handoff path
    (``runtime/preemption.py``) rides the in-run elastic shrink, and a
    model-parallel strategy cannot shrink (ADT430): every announced
    departure then degrades to rescue-checkpoint + whole-job restart —
    legal, but the operator armed a graceful-handoff feature that can
    never actually hand off. Warned at BUILD time, not at the first
    eviction."""
    out: List[Diagnostic] = []
    model_axes = fail_fast_model_axes(strategy)
    if model_axes:
        out.append(warning(
            "ADT432",
            "preemption handoff is armed but the strategy partitions "
            "state over model-parallel mesh axes %s — the elasticity "
            "matrix marks this family fail-fast, so every planned "
            "departure degrades to rescue-checkpoint + whole-job "
            "restart instead of a live handoff" % (model_axes,),
            fixit="use a data-parallel strategy for live handoffs, or "
                  "accept the checkpoint-restart path and size "
                  "ADT_PREEMPT_DEADLINE_S to cover a full save"))
    return out


def verify_autoscale(policy, strategy=None,
                     max_queue: Optional[int] = None) -> List[Diagnostic]:
    """ADT44x — are a serving autoscaler's bounds sound for the strategy
    it will scale (``serving/autoscale.py``)? Run at controller
    construction, so an unsound clamp fails loudly at deploy time, not
    at the 3 a.m. shrink that would have fallen back to a checkpoint.

    - ``ADT440`` (error): the bounds arm a move the elasticity matrix
      forbids. A fail-fast model-parallel family (ADT430) cannot change
      replica count in-run at all, so any ``min_replicas <
      max_replicas`` would eventually command an impossible resize; a
      PS-backed family's floor is its distinct reduction-destination
      host count — shrinking below it retires a PS owner, and ADT431
      prices that as a checkpoint fallback, the exact thing the
      planned-departure contract promises to avoid.
    - ``ADT441`` (warning): thresholds that cannot fire or cannot
      settle — a grow trigger at/above ``max_queue`` (the tier sheds
      before the controller ever arms), or a zero sustain window with
      zero cooldowns (every sample may scale; the hysteresis band is
      the only flap guard left).
    """
    out: List[Diagnostic] = []
    if strategy is not None:
        model_axes = fail_fast_model_axes(strategy)
        if model_axes and policy.min_replicas < policy.max_replicas:
            out.append(error(
                "ADT440",
                "autoscale bounds [%d, %d] arm replica-count changes on "
                "a strategy that partitions state over model-parallel "
                "mesh axes %s — this family is fail-fast (ADT430): it "
                "can neither shrink nor grow in-run, so the first scale "
                "decision commands an impossible resize"
                % (policy.min_replicas, policy.max_replicas,
                   model_axes),
                fixit="pin min_replicas == max_replicas for this "
                      "family, or serve it from a data-parallel "
                      "strategy"))
        ps_hosts = set()
        for node in strategy.node_config:
            for leaf in (node.part_configs or [node]):
                sync = leaf.synchronizer or node.synchronizer
                dest = getattr(sync, "reduction_destination", "") or ""
                if dest:
                    ps_hosts.add(dest.split(":")[0])
        if ps_hosts and policy.min_replicas < len(ps_hosts):
            out.append(error(
                "ADT440",
                "min_replicas %d is below the PS-owner floor %d (distinct "
                "reduction-destination hosts %s) — an idle shrink would "
                "retire an owner and its authoritative host-resident "
                "state with it, forcing the checkpoint fallback (ADT431) "
                "the planned-departure path exists to avoid"
                % (policy.min_replicas, len(ps_hosts),
                   sorted(ps_hosts)),
                fixit="raise min_replicas to the PS-owner host count, "
                      "or concentrate reduction_destination on fewer "
                      "hosts"))
    if max_queue is not None and policy.queue_high >= max_queue:
        out.append(warning(
            "ADT441",
            "queue_high %.0f >= max_queue %d — submits shed at the "
            "queue bound before the grow trigger can ever arm, so the "
            "controller only ever observes a post-shed queue"
            % (policy.queue_high, max_queue),
            fixit="set queue_high well below max_queue (e.g. half) so "
                  "overload grows the fleet before it sheds clients"))
    if (policy.sustain_s == 0 and policy.grow_cooldown_s == 0
            and policy.shrink_cooldown_s == 0):
        out.append(warning(
            "ADT441",
            "sustain_s and both cooldowns are 0 — every poll may scale, "
            "leaving the hysteresis band as the only flap guard",
            fixit="give the policy a sustain window (seconds) or "
                  "non-zero per-direction cooldowns"))
    return out


def verify_decode(cache_bytes: float, param_bytes: float = 0.0,
                  slots: Optional[int] = None,
                  max_len: Optional[int] = None,
                  replicas: int = 1,
                  budget_bytes: Optional[float] = None,
                  resource_spec=None) -> List[Diagnostic]:
    """ADT442 — does a continuous-batching decode engine's armed KV
    cache (``max_len x slots``, both halves, ``serving/decode.py``) plus
    the full params the decode step holds fit the per-device memory
    budget? Run at engine construction, so an over-provisioned slot pool
    warns at deploy time instead of failing at the first full-occupancy
    step.

    ``cache_bytes`` is the GLOBAL cache allocation (k + v); the slot dim
    splits over ``replicas``, so the per-device share is
    ``cache_bytes / replicas``; params count whole. The budget comes from
    ``budget_bytes`` or ``resource_spec.chip_hbm_bytes()``; with neither
    there is nothing to project against and no diagnostic is emitted."""
    out: List[Diagnostic] = []
    budget = budget_bytes
    if budget is None and resource_spec is not None:
        budget = resource_spec.chip_hbm_bytes()
    if not budget or budget <= 0:
        return out
    per_device = cache_bytes / max(int(replicas), 1) + param_bytes
    if per_device > budget:
        geometry = ""
        if slots is not None and max_len is not None:
            geometry = " (%d slots x %d max_len)" % (slots, max_len)
        out.append(warning(
            "ADT442",
            "decode engine armed with %.2f GiB of KV cache%s + %.2f GiB "
            "params projects to %.2f GiB per device — past the %.2f GiB "
            "device memory budget: the first fully-occupied decode step "
            "runs out of memory, not the lint" % (
                cache_bytes / GIB, geometry, param_bytes / GIB,
                per_device / GIB, budget / GIB),
            fixit="shrink slots or max_len, serve a smaller model, or "
                  "spread the slot dim over more batch replicas"))
    return out


@rule
def _r_staleness_topology(ctx: Context) -> Iterable[Diagnostic]:
    if ctx.spec is None or not ctx.spec.is_single_node():
        return
    stale = sorted({owner for node in ctx.strategy.node_config
                    for owner, s in ctx.synchronizers(node)
                    if _is_ps(s) and s.sync and s.staleness > 0})
    if stale:
        yield info(
            "ADT404",
            "staleness window configured on a single-node spec — "
            "cross-process pacing is a no-op here (%d vars)" % len(stale))


@rule
def _r_topology_collectives(ctx: Context) -> Iterable[Diagnostic]:
    """ADT52x plan-level pass: delegated to analysis/topology.py and
    gated on the spec declaring a multi-level topology, so flat specs
    (the default — ``topology()`` is None) lint exactly as before."""
    if ctx.spec is None or not hasattr(ctx.spec, "topology"):
        return
    if ctx.spec.topology() is None:
        return
    from autodist_tpu_torch.analysis.topology import verify_topology
    for d in verify_topology(ctx.strategy, ctx.var_infos, ctx.spec):
        yield d
