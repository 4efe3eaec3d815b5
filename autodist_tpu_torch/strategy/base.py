"""Strategy intermediate representation + builder/compiler base classes.

A copy of ``autodist_tpu/strategy/base.py`` (the IR is framework-free; the
port carries its own copy so it never imports the JAX package). The text
below is the JAX module's, unchanged where the two agree.

Analog of reference ``autodist/strategy/base.py`` and the protobuf schemas
``proto/strategy.proto:31-69`` / ``proto/synchronizers.proto``. The Strategy
is the contract between the frontend (builders, pure functions of
(ModelItem, ResourceSpec)) and the backend lowering
(``autodist_tpu_torch/kernel/graph_transformer.py``): per-variable it says how to
synchronize gradients (PS or AllReduce, with partitioning, staleness,
compression, grouping), and per-graph which devices carry data-parallel
replicas.

Serialization is JSON on disk under ``<tmp>/autodist_tpu_torch/strategies/<id>``
(the reference serializes protobuf under ``/tmp/autodist/strategies``,
reference ``strategy/base.py:78-99``) so the chief can write a strategy and
every worker can load the identical bytes — all processes then lower the same
plan independently, exactly the reference's
"every node transforms its own graph" architecture
(reference ``docs/design/architecture.rst:43-47``).
"""
import dataclasses
import datetime
import json
import os
from abc import ABC, abstractmethod
from typing import Dict, List, Optional, Union

from autodist_tpu_torch import const
from autodist_tpu_torch.analysis import partition as partition_lib
from autodist_tpu_torch.analysis.diagnostics import DiagnosticError, error
from autodist_tpu_torch.utils import logging


# ------------------------------------------------------------- synchronizers


@dataclasses.dataclass
class PSSynchronizer:
    """Parameter-server sync config (reference ``synchronizers.proto:26-31``).

    On TPU, ``reduction_destination`` names the device that *owns* the
    variable's update computation; gradients are reduced to the owner and the
    updated value is re-broadcast (or cached via proxy, see
    ``parallel/ps.py``).

    ``wire_dtype`` ("fp32" | "int8") sets the host<->device wire format of
    the no-proxy (host-resident) PS path: "int8" ships values and pushed
    gradients as blockwise-scaled int8 + f32 scales
    (``parallel/collectives.py`` codec) with dequantization at the store
    boundary — dense float variables only (the linter's ADT310)."""
    reduction_destination: str = ""
    local_replication: bool = False
    sync: bool = True
    staleness: int = 0
    wire_dtype: str = "fp32"

    kind = "PS"

    def to_dict(self):
        return {"kind": self.kind, "reduction_destination": self.reduction_destination,
                "local_replication": self.local_replication, "sync": self.sync,
                "staleness": self.staleness, "wire_dtype": self.wire_dtype}


@dataclasses.dataclass
class AllReduceSynchronizer:
    """All-reduce sync config (reference ``synchronizers.proto:37-57``).

    ``spec`` is the communication hint: AUTO lets XLA choose; ICI pins the
    reduce to the intra-slice interconnect; DCN to the cross-slice network
    (the reference's AUTO/NCCL/RING map onto AUTO/ICI/ICI).
    ``compressor`` names a class in ``parallel/compression.py``. ``group``
    buckets small all-reduces together (the reference feeds this to the
    ScopedAllocator grappler pass, ``all_reduce_strategy.py:60-67``; we feed
    it to our own gradient bucketing in ``parallel/collectives.py``).

    ``wire_dtype`` ("fp32" | "int8") sets the collective's wire format:
    "int8" lowers the gradient all-reduce to the blockwise-scaled
    two-phase quantized shape (quantize -> reduce-scatter int8 -> local
    dequant-accumulate -> quantize -> all-gather; EQuARX, arXiv
    2506.17615) with error feedback. Dense float unpartitioned wires only,
    and mutually exclusive with ``compressor`` (the linter's ADT310).

    ``schedule`` picks the collective algorithm the reduce lowers to:
    "auto" resolves per topology (hierarchical when the replica set
    spans a declared multi-host topology's slow level, ring otherwise);
    "ring" pins the flat single-ring all-reduce; "rhd" the recursive
    halving/doubling shape (reduce-scatter + all-gather, fewer latency
    hops for small payloads); "hier" the two-level intra-host
    reduce-scatter / leader all-reduce / intra-host all-gather
    composition (arXiv 2110.10548). An explicit "hier" on a flat mesh is
    refused back to ring by the resolver; a pinned "ring" spanning hosts
    is the analyzer's ADT520."""
    spec: str = "AUTO"        # AUTO | ICI | DCN (NCCL/RING accepted as aliases)
    compressor: str = "NoneCompressor"
    group: int = 0
    wire_dtype: str = "fp32"
    schedule: str = "auto"    # auto | ring | rhd | hier

    kind = "AllReduce"

    _SPEC_ALIASES = {"NCCL": "ICI", "RING": "ICI"}

    def __post_init__(self):
        self.spec = self._SPEC_ALIASES.get(self.spec, self.spec)
        self.schedule = (self.schedule or "auto").lower()

    def to_dict(self):
        return {"kind": self.kind, "spec": self.spec,
                "compressor": self.compressor, "group": self.group,
                "wire_dtype": self.wire_dtype, "schedule": self.schedule}


@dataclasses.dataclass
class ZeroShardedSynchronizer:
    """ZeRO-style sharded weight update (arXiv 2004.13336, stage 1).

    Params stay stored FULL (replicated) — the forward pass never pays a
    gather — but the gradient is reduce-scattered across the data axis,
    each replica applies the optimizer update to its owned 1/P flat shard
    only (optimizer state is *created* sharded, never materialized
    whole), and the updated shard's delta is all-gathered back onto the
    replicated params. Wire bytes equal an all-reduce (rs + ag = the same
    2(P-1)/P ring factor); per-chip optimizer-state footprint drops by
    ~(P-1)/P.

    ``wire_dtype`` ("fp32" | "int8") quantizes both wire crossings
    through the blockwise codec (``parallel/collectives.py``): the
    reduce-scatter payload ships int8 + f32 scales (local accumulation
    stays f32) and the all-gathered UPDATE ships the same way — the
    delta, not the params, so replicated param copies accumulate in full
    precision and stay bit-identical across replicas. Dense float
    variables of at least one scale block only (the linter's
    ADT310/311); sparse / model-parallel / partitioned variables cannot
    zero-shard at all (ADT312)."""
    wire_dtype: str = "fp32"

    kind = "ZeroSharded"

    def to_dict(self):
        return {"kind": self.kind, "wire_dtype": self.wire_dtype}


Synchronizer = Union[PSSynchronizer, AllReduceSynchronizer,
                     ZeroShardedSynchronizer]


SYNCHRONIZER_KINDS = ("PS", "AllReduce", "ZeroSharded")


def synchronizer_from_dict(d: dict, var_name: str = "") -> Synchronizer:
    """Deserialize one synchronizer config.

    ``var_name`` names the owning strategy node in every failure message
    (a serialized plan has hundreds of nodes — "unknown kind" without the
    variable is unactionable). Raises :class:`DiagnosticError`
    (``ADT301``, a ``ValueError``) on an unknown kind or invalid fields.
    """
    d = dict(d)
    kind = d.pop("kind", None)
    ctor = {"PS": PSSynchronizer, "AllReduce": AllReduceSynchronizer,
            "ZeroSharded": ZeroShardedSynchronizer}.get(kind)
    if ctor is None:
        raise DiagnosticError(error(
            "ADT301",
            "unknown synchronizer kind %r (allowed kinds: %s)"
            % (kind, ", ".join(SYNCHRONIZER_KINDS)), var=var_name,
            fixit="serialize synchronizers through PSSynchronizer/"
                  "AllReduceSynchronizer/ZeroShardedSynchronizer"
                  ".to_dict()"))
    try:
        return ctor(**d)
    except TypeError as e:
        raise DiagnosticError(error(
            "ADT301",
            "invalid %s synchronizer fields %s (%s)"
            % (kind, sorted(d), e), var=var_name))


# ------------------------------------------------------------------- nodes


@dataclasses.dataclass
class VarConfig:
    """Per-variable strategy node (reference ``strategy.proto:36-49`` Node).

    ``partitioner`` is a comma-joined per-axis shard-count string like
    ``"4,1"`` (reference ``kernel/partitioner.py:38-150`` PartitionerConfig);
    when set, ``part_configs`` holds one VarConfig per shard. ``shard_sizes``
    supports uneven partitioning (sizes along the split axis).

    ``mp_axes`` (TPU-native extension beyond the reference, which is
    data-parallel only — reference ``docs/design/architecture.rst:46-48``)
    maps tensor dim -> mesh axis name for *model-parallel* storage: the
    variable is stored sharded over that mesh axis and the compute consumes
    the LOCAL shard directly (tensor/pipeline/expert parallelism), unlike
    ``partitioner`` sharding which all-gathers the full value for compute
    (ZeRO-style storage sharding)."""
    var_name: str
    synchronizer: Optional[Synchronizer] = None
    partitioner: Optional[str] = None
    part_configs: List["VarConfig"] = dataclasses.field(default_factory=list)
    shard_sizes: Optional[List[int]] = None
    mp_axes: Optional[Dict[int, str]] = None

    @property
    def partition_axis(self) -> Optional[int]:
        """First split axis; raises ``DiagnosticError`` (ADT201, a clean
        ``ValueError``) on a malformed partitioner like ``"4,"`` or
        ``"a,1"`` — the same diagnostic the linter reports."""
        if not self.partitioner:
            return None
        return partition_lib.partition_axis_of(
            partition_lib.parse_partitioner(self.partitioner, self.var_name))

    @property
    def num_shards(self) -> int:
        if not self.partitioner:
            return 1
        return partition_lib.num_shards_of(
            partition_lib.parse_partitioner(self.partitioner, self.var_name))

    def to_dict(self):
        return {
            "var_name": self.var_name,
            "synchronizer": self.synchronizer.to_dict() if self.synchronizer else None,
            "partitioner": self.partitioner,
            "part_configs": [p.to_dict() for p in self.part_configs],
            "shard_sizes": self.shard_sizes,
            "mp_axes": ({str(k): v for k, v in self.mp_axes.items()}
                        if self.mp_axes else None),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "VarConfig":
        return cls(
            var_name=d["var_name"],
            synchronizer=(synchronizer_from_dict(d["synchronizer"],
                                                 var_name=d["var_name"])
                          if d.get("synchronizer") else None),
            partitioner=d.get("partitioner"),
            part_configs=[cls.from_dict(p) for p in d.get("part_configs", [])],
            shard_sizes=d.get("shard_sizes"),
            mp_axes=({int(k): v for k, v in d["mp_axes"].items()}
                     if d.get("mp_axes") else None),
        )


@dataclasses.dataclass
class GraphConfig:
    """Graph-level config (reference ``strategy.proto:60-69``): the replica
    devices (data-parallel axis) plus TPU-native mesh extensions the
    reference anticipated but never grew (``strategy.proto:36-41``)."""
    replicas: List[str] = dataclasses.field(default_factory=list)
    # extension axes beyond the reference (tensor/pipeline/sequence/expert)
    mesh_shape: Optional[Dict[str, int]] = None
    # when set, batch leaves of rank >= 2 shard their dim 1 (the sequence
    # dim) over this mesh axis — set by sequence-parallel builders
    seq_axis: Optional[str] = None
    # mesh axes the batch dim (dim 0) shards over; None -> just the data
    # axis. Expert-parallel strategies set ['data', 'expert'] so every
    # device sees distinct tokens
    batch_axes: Optional[List[str]] = None
    # with seq_axis set: the batch-leaf names whose dim 1 really is the
    # sequence dim. None = every rank>=2 leaf (legacy behavior — fine
    # when the batch is all token arrays, silently WRONG for e.g. one-hot
    # label leaves whose dim 1 is classes; set this to the token keys)
    seq_feed_keys: Optional[List[str]] = None
    # gradient rematerialization: None (store all activations), "full"
    # (jax.checkpoint — recompute the forward in the backward, minimum
    # HBM), or "dots" (save matmul outputs only). A graph-level transform
    # the TF reference had no equivalent for; on TPU it is the standard
    # HBM-for-FLOPs trade that lets bigger batches/models fit
    remat: Optional[str] = None
    # GPipe microbatch count for pipeline strategies — recorded so the
    # cost model can price the pipeline bubble ((S-1+M)/M compute
    # inflation) from the serialized strategy alone
    pp_microbatches: Optional[int] = None
    # pipeline schedule: "gpipe" (all-M activation residency), "1f1b"
    # (residency bounded at S in-flight microbatches; the model must build
    # its loss through pipeline_loss_1f1b), or "interleaved" (V virtual
    # stage chunks per rank, bubble cut to (S-1)/(V*M) — model builds
    # through pipeline_apply_interleaved) — priced by the cost model
    pp_schedule: Optional[str] = None
    # virtual-stage chunks per rank for the interleaved schedule (V >= 2)
    pp_virtual: Optional[int] = None
    # strict sparse wire: a builder that PLANNED on (ids, values) gradient
    # shipping (DLRM/NCF embedding strategies) sets this so a silent
    # fallback to dense sync — a >10x wire regression — raises in the
    # lowering instead of logging a warning. ADT_IS_TESTING implies it.
    require_sparse: bool = False
    # compute tier: "f32" (default) or "bf16" — with "bf16" the lowering
    # casts params and float batch leaves to bfloat16 for the forward/
    # backward, while master params, optimizer state, gradient
    # accumulation (every psum/reduce-scatter) and the loss/sentinel
    # verdict stay f32 — the f32-master discipline the ADT60x numerics
    # rules certify (analysis/numerics.py, rules.verify_numerics)
    compute_dtype: str = "f32"
    # communication–computation overlap: lower gradient sync as an ordered
    # schedule of per-unit collectives chained through optimization_barrier
    # (reverse layer order) instead of one epilogue, so XLA's latency-
    # hiding scheduler can run each collective under the remaining
    # backward compute. Values are bit-identical to the epilogue lowering
    # (the barrier is an identity op); ignored at 1 replica.
    overlap: bool = False

    def to_dict(self):
        return {"replicas": list(self.replicas), "mesh_shape": self.mesh_shape,
                "seq_axis": self.seq_axis, "batch_axes": self.batch_axes,
                "seq_feed_keys": self.seq_feed_keys,
                "remat": self.remat, "pp_microbatches": self.pp_microbatches,
                "pp_schedule": self.pp_schedule,
                "pp_virtual": self.pp_virtual,
                "require_sparse": self.require_sparse,
                "compute_dtype": self.compute_dtype,
                "overlap": self.overlap}

    @classmethod
    def from_dict(cls, d):
        return cls(replicas=list(d.get("replicas", [])),
                   mesh_shape=d.get("mesh_shape"),
                   seq_axis=d.get("seq_axis"),
                   batch_axes=d.get("batch_axes"),
                   seq_feed_keys=d.get("seq_feed_keys"),
                   remat=d.get("remat"),
                   pp_microbatches=d.get("pp_microbatches"),
                   pp_schedule=d.get("pp_schedule"),
                   pp_virtual=d.get("pp_virtual"),
                   require_sparse=bool(d.get("require_sparse", False)),
                   compute_dtype=d.get("compute_dtype", "f32") or "f32",
                   overlap=bool(d.get("overlap", False)))


# ----------------------------------------------------------------- strategy


class Strategy:
    """The per-variable distribution plan (reference ``strategy/base.py:28-99``)."""

    def __init__(self, node_config: Optional[List[VarConfig]] = None,
                 graph_config: Optional[GraphConfig] = None,
                 strategy_id: Optional[str] = None):
        self.id = strategy_id or datetime.datetime.now(
            datetime.timezone.utc).strftime("%Y%m%dT%H%M%S%f")
        self.node_config: List[VarConfig] = node_config or []
        self.graph_config: GraphConfig = graph_config or GraphConfig()

    def to_dict(self) -> dict:
        return {"id": self.id,
                "node_config": [n.to_dict() for n in self.node_config],
                "graph_config": self.graph_config.to_dict()}

    @classmethod
    def from_dict(cls, d: dict) -> "Strategy":
        return cls(node_config=[VarConfig.from_dict(n) for n in d.get("node_config", [])],
                   graph_config=GraphConfig.from_dict(d.get("graph_config", {})),
                   strategy_id=d.get("id"))

    def serialize(self, path: Optional[str] = None) -> str:
        if path is None:
            os.makedirs(const.DEFAULT_SERIALIZATION_DIR, exist_ok=True)
            path = os.path.join(const.DEFAULT_SERIALIZATION_DIR, self.id)
        # write-then-rename: workers poll for this file and must never
        # observe a half-written strategy
        tmp = "%s.tmp.%d" % (path, os.getpid())
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f, sort_keys=True, indent=1)
        os.replace(tmp, path)
        return path

    @classmethod
    def deserialize(cls, strategy_id: Optional[str] = None, path: Optional[str] = None) -> "Strategy":
        if path is None:
            path = os.path.join(const.DEFAULT_SERIALIZATION_DIR, strategy_id)
        with open(path, "r") as f:
            return cls.from_dict(json.load(f))

    def find(self, var_name: str) -> Optional[VarConfig]:
        for n in self.node_config:
            if n.var_name == var_name:
                return n
        return None

    def __repr__(self):
        return "Strategy(id=%s, vars=%d, replicas=%d)" % (
            self.id, len(self.node_config), len(self.graph_config.replicas))

    def __str__(self):
        return json.dumps(self.to_dict(), indent=1, sort_keys=True)


# ------------------------------------------------------------------ builder


class StrategyBuilder(ABC):
    """ABC for strategy builders (reference ``strategy/base.py:102-117``).

    Builders are pure functions of (ModelItem, ResourceSpec) -> Strategy."""

    @abstractmethod
    def build(self, model_item, resource_spec) -> Strategy:
        ...


class StrategyCompiler:
    """Resolves a Strategy against concrete cluster devices
    (reference ``strategy/base.py:120-168`` + ``kernel/device/resolver.py``):
    prunes configs for variables that no longer exist, checks every trainable
    variable has one, and resolves device name strings. Frozen vars keep
    their configs — they may carry mp_axes storage layouts (their
    synchronizers are ignored by the lowering)."""

    def __init__(self, model_item, resource_spec):
        self._item = model_item
        self._spec = resource_spec

    def compile(self, strategy: Strategy) -> Strategy:
        from autodist_tpu_torch.kernel.device.resolver import DeviceResolver
        resolver = DeviceResolver(self._spec)
        # keep configs for every known var (frozen vars may carry mp_axes
        # storage layouts); only require one per *trainable* var below
        known = set(self._item.var_infos)
        trainable = set(self._item.trainable_var_names)
        pruned = []
        for node in strategy.node_config:
            if node.var_name not in known:
                logging.debug("StrategyCompiler: pruning config for unknown var %s", node.var_name)
                continue
            if isinstance(node.synchronizer, PSSynchronizer) and node.synchronizer.reduction_destination:
                node.synchronizer.reduction_destination = resolver.resolve(
                    node.synchronizer.reduction_destination)
            for part in node.part_configs:
                if isinstance(part.synchronizer, PSSynchronizer) and part.synchronizer.reduction_destination:
                    part.synchronizer.reduction_destination = resolver.resolve(
                        part.synchronizer.reduction_destination)
            pruned.append(node)
        strategy.node_config = pruned
        strategy.graph_config.replicas = [resolver.resolve(r) for r in strategy.graph_config.replicas]
        # same rule the linter reports as ADT101 (analysis/rules.py) — the
        # compile path raises where lint time merely lists
        from autodist_tpu_torch.analysis import rules as rules_lib
        missing = rules_lib.missing_trainable_configs(strategy, trainable)
        if missing:
            raise DiagnosticError(error(
                "ADT101",
                "strategy has no config for trainable vars: %s" % missing,
                var=missing[0],
                fixit="emit a VarConfig for every trainable variable"))
        return strategy
