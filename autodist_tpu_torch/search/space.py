"""Typed per-variable candidate space for the auto-strategy search.

The port's copy of ``autodist_tpu/search/space.py``.

The original AutoDist's AutoSync searched *per-variable* synchronizer
choices (reference ``docs/design/rationale.rst``); our zoo-ranking
``AutoStrategy`` only ever picked a whole-graph template. This module is
the missing dimension: a :class:`PlanSpec` assigns every trainable
variable its own :class:`VarChoice` (PS vs AllReduce, partition axis +
shard count, compressor) plus plan-level knobs (gradient bucketing
granularity, PS staleness window, remat policy), and a :class:`PlanSpace`
that

- enumerates **seed** plans mirroring the zoo families (plus best-effort
  conversions of actual zoo strategies via :meth:`PlanSpace.from_strategy`),
- applies **mutation operators** (deterministic under a caller-owned
  ``random.Random``) that by construction keep plans inside what the
  lowering supports — shard counts are divisors of the split dim, sparse
  variables never take the dense reduce-scatter path (ADT309), compressors
  only ride unpartitioned dense float AllReduce wires (ADT306/308) — so
  ``analysis.verify`` stays a cheap *gate*, not the search's inner loop,
- **materializes** a PlanSpec into a :class:`~autodist_tpu_torch.strategy.base.
  Strategy` using the exact node shapes the zoo builders emit (greedy
  least-loaded PS destination assignment, round-robined shard
  destinations), so a searched plan lowers through the same kernels.

Everything here is pure and trace-free: scoring happens in
``search/scoring.py`` through the calibrated cost model.
"""
import dataclasses
from typing import Dict, List, Optional, Tuple

from autodist_tpu_torch.strategy.base import (AllReduceSynchronizer,
                                              GraphConfig, PSSynchronizer,
                                              Strategy, VarConfig,
                                              ZeroShardedSynchronizer)
from autodist_tpu_torch.strategy.partitioned_ps_strategy import (
    make_partition_str, smallest_divisor_shards)
from autodist_tpu_torch.strategy.ps_lb_strategy import (byte_size_load_fn,
                                                        greedy_assign)
from autodist_tpu_torch.strategy.ps_strategy import (reduction_devices,
                                                     replica_devices)

# gradient-bucketing granularities the search may pick (vars per group,
# AllReduce family; one huge bucket minimizes per-collective launches,
# small buckets overlap earlier — the cost model prices the launch count)
CHUNK_SIZES = (8, 32, 128, 512)
# plan-level staleness windows for host-PS variables (sync training)
STALENESS_CHOICES = (0, 2)
# plan-level remat policies (None = store all activations)
REMAT_CHOICES = (None, "dots")
# compressors the search offers on dense float AllReduce wires; PowerSGD
# additionally requires rank >= 2 (ADT308). The int8 wire rides its own
# ``wire_dtype`` axis below (the blockwise codec is a property of the
# collective, not a gradient compressor), so it composes with PS too.
_DENSE_COMPRESSORS = ("NoneCompressor", "HorovodCompressor")
_MATRIX_COMPRESSORS = _DENSE_COMPRESSORS + ("PowerSGDCompressor:2",)
# wire formats the search offers per variable (dense float, >= one scale
# block — ADT310/311 are excluded BY CONSTRUCTION, never emitted)
WIRE_DTYPES = ("fp32", "int8")
# plan-level compute tiers (GraphConfig.compute_dtype): "bf16" lowers the
# forward/backward in bfloat16 while master params, optimizer state, the
# gradient collectives and the loss stay f32 — the only combination the
# ADT60x numerics rules accept, so the knob is a single safe bit and
# every invalid mixed-precision shape is excluded BY CONSTRUCTION
COMPUTE_DTYPES = ("f32", "bf16")


@dataclasses.dataclass(frozen=True)
class VarChoice:
    """One variable's synchronization decision.

    ``shards``/``axis`` describe partitioned storage (the ``partitioner``
    string of the strategy IR — params sharded, gathered per step);
    ``shards == 1`` means unpartitioned. ``zero`` selects the
    ZeRO-sharded weight update instead (``ZeroShardedSynchronizer``):
    params stay replicated, the gradient reduce-scatters, the optimizer
    applies on the owned 1/P shard (opt state created sharded) and the
    update all-gathers — the memory/speed trade axis for dense variables
    of at least one element per replica (ADT312/313 by construction);
    mutually exclusive with ``shards > 1``, PS, and ``compressor``.
    ``compressor`` only applies to unpartitioned dense AllReduce wires;
    ``ps_proxy`` only to PS. ``wire_dtype`` ("fp32" | "int8") selects
    the blockwise-quantized collective/PS/zero wire — dense float
    variables of at least one scale block, mutually exclusive with
    ``compressor`` (canon resolves conflicts compressor-first).
    ``schedule`` ("auto" | "ring" | "rhd" | "hier") picks the collective
    algorithm for the plain AllReduce wire (strategy/base.py docs):
    "hier" is only in the sub-space when the resource spec declares a
    multi-host topology the replica set spans — on a flat mesh canon
    clamps it back to "auto" (which resolves to the ring), the
    analyzer's refusal semantics."""
    sync: str = "AllReduce"               # "AllReduce" | "PS"
    compressor: str = "NoneCompressor"
    shards: int = 1
    axis: int = 0
    ps_proxy: bool = False
    wire_dtype: str = "fp32"
    zero: bool = False
    schedule: str = "auto"                # auto | ring | rhd | hier


@dataclasses.dataclass(frozen=True)
class PlanSpec:
    """A full per-variable plan: hashable, order-stable, mutation-friendly.

    ``choices`` pairs every trainable variable (in ``ModelItem`` order)
    with its :class:`VarChoice`; the remaining fields are plan-level
    knobs. Frozen so drivers can dedup visited candidates by the spec
    itself."""
    choices: Tuple[Tuple[str, VarChoice], ...]
    chunk_size: int = 128
    staleness: int = 0
    remat: Optional[str] = None
    compute_dtype: str = "f32"
    # lower the gradient sync as a bucketed overlap schedule (reverse
    # layer order, barrier-chained) instead of one epilogue; chunk_size
    # doubles as the bucket-size knob for how many stages it splits into
    overlap: bool = False

    def choice_map(self) -> Dict[str, VarChoice]:
        return dict(self.choices)

    def replace_choice(self, name: str, choice: VarChoice) -> "PlanSpec":
        return dataclasses.replace(self, choices=tuple(
            (n, choice if n == name else c) for n, c in self.choices))

    def describe(self) -> str:
        """Compact human label: sync-family counts + plan knobs."""
        ar = sum(1 for _, c in self.choices if c.sync == "AllReduce")
        ps = len(self.choices) - ar
        comp = sum(1 for _, c in self.choices
                   if c.compressor != "NoneCompressor")
        sharded = sum(1 for _, c in self.choices if c.shards > 1)
        wired = sum(1 for _, c in self.choices if c.wire_dtype == "int8")
        zeroed = sum(1 for _, c in self.choices if c.zero)
        scheds = sorted({c.schedule for _, c in self.choices
                         if c.schedule != "auto"})
        bits = ["ar=%d" % ar, "ps=%d" % ps]
        if comp:
            bits.append("comp=%d" % comp)
        for s in scheds:
            bits.append("sched:%s=%d" % (
                s, sum(1 for _, c in self.choices if c.schedule == s)))
        if wired:
            bits.append("int8w=%d" % wired)
        if sharded:
            bits.append("sharded=%d" % sharded)
        if zeroed:
            bits.append("zero=%d" % zeroed)
        bits.append("chunk=%d" % self.chunk_size)
        if self.staleness:
            bits.append("stale=%d" % self.staleness)
        if self.remat:
            bits.append("remat=%s" % self.remat)
        if self.compute_dtype != "f32":
            bits.append("compute=%s" % self.compute_dtype)
        if self.overlap:
            bits.append("overlap")
        return "plan[%s]" % ",".join(bits)


def _flax_shape(info) -> Tuple[int, ...]:
    """The JAX layout's shape of a variable (``VarInfo.flax_shape``): the
    axes a partitioner string counts and the partitioned builders split
    (a DenseGeneral kernel the port holds 2-D is 3-D here)."""
    return tuple(getattr(info, "flax_shape", None) or info.shape)


def _partition_options(shape, cap: int) -> List[Tuple[int, int]]:
    """(axis, shards) pairs that split one axis into an exact divisor
    count — the only partitionings the lowering stores unpadded and the
    linter leaves un-flagged. At most 4 counts per axis (smallest,
    largest, powers of two between) keeps the branching factor bounded."""
    out: List[Tuple[int, int]] = []
    for axis, dim in enumerate(shape or ()):
        divisors = [k for k in range(2, min(int(dim), cap) + 1)
                    if dim % k == 0]
        if not divisors:
            continue
        keep = {divisors[0], divisors[-1]}
        keep.update(k for k in divisors if k & (k - 1) == 0)
        out.extend((axis, k) for k in sorted(keep)[:4])
    return out


class PlanSpace:
    """The candidate space for one (ModelItem, ResourceSpec) pair."""

    def __init__(self, model_item, resource_spec):
        self._item = model_item
        self._spec = resource_spec
        self.var_names: List[str] = list(model_item.trainable_var_names)
        self.infos = {n: model_item.var_infos[n] for n in self.var_names}
        self.destinations = reduction_devices(resource_spec)
        self.replicas = replica_devices(resource_spec)
        self.n_replicas = max(len(self.replicas), 1)
        cap = max(self.n_replicas, len(self.destinations), 2)
        self.partition_options: Dict[str, List[Tuple[int, int]]] = {
            n: _partition_options(_flax_shape(self.infos[n]), cap)
            for n in self.var_names}
        self.compressor_options: Dict[str, Tuple[str, ...]] = {}
        self.wire_options: Dict[str, Tuple[str, ...]] = {}
        # ZeRO-sharded update eligibility (the builder's gate, shared so
        # ADT312/313 are excluded from the space by construction)
        from autodist_tpu_torch.strategy.zero_sharded_strategy import (
            zero_shardable)
        self.zero_ok: Dict[str, bool] = {
            n: zero_shardable(self.infos[n], self.n_replicas)
            for n in self.var_names}
        from autodist_tpu_torch.parallel.collectives import wire_quantizable
        for n in self.var_names:
            info = self.infos[n]
            dtype = str(getattr(info, "dtype", "float32"))
            if info.sparse or not dtype.startswith(("float", "bfloat")):
                # ADT306: compression is dead weight on sparse or
                # non-float wires — not part of this variable's space
                self.compressor_options[n] = ("NoneCompressor",)
            elif len(info.shape) >= 2:
                self.compressor_options[n] = _MATRIX_COMPRESSORS
            else:
                self.compressor_options[n] = _DENSE_COMPRESSORS
            # int8 wire: dense float, at least one scale block (ADT310 /
            # ADT311 excluded from the space by construction)
            self.wire_options[n] = (
                WIRE_DTYPES if wire_quantizable(info, min_block=True)
                else ("fp32",))
        # collective-schedule axis: "hier" only exists when the spec
        # declares a multi-host topology the replica set actually spans
        # (with >= 2 chips per host there is a payload to shrink) — on a
        # flat mesh the space refuses it by construction, so the searcher
        # can never "pick hierarchical" where the analyzer would lint it
        topo = (resource_spec.topology()
                if hasattr(resource_spec, "topology") else None)
        if (topo is not None and topo.hosts > 1
                and topo.inter_level is not None
                and self.n_replicas > topo.chips_per_host
                and topo.chips_per_host > 1):
            self.schedule_options: Tuple[str, ...] = ("auto", "ring",
                                                      "rhd", "hier")
        else:
            self.schedule_options = ("auto", "rhd")

    # ------------------------------------------------------------- validity

    def canon(self, choice: VarChoice, name: str) -> VarChoice:
        """Clamp a choice to this variable's valid sub-space (the single
        place mutation results are normalized, so operators stay simple)."""
        info = self.infos[name]
        sync = choice.sync if choice.sync in ("PS", "AllReduce") else "AllReduce"
        shards, axis = choice.shards, choice.axis
        if shards > 1 and (axis, shards) not in self.partition_options[name]:
            shards, axis = 1, 0
        if sync == "AllReduce" and info.sparse and shards > 1:
            # ADT309: a partitioned reduce-scatter densifies the
            # row-sparse gradient to the full table every step
            shards, axis = 1, 0
        # ZeRO-sharded update: AllReduce family only, no partitioner on
        # top (ADT312), dense vars of >= one element per replica
        # (ADT313) — the same gate the ZeroSharded builder applies
        zero = (bool(choice.zero) and sync == "AllReduce"
                and shards <= 1 and self.zero_ok[name])
        compressor = choice.compressor
        if (sync != "AllReduce" or shards > 1 or zero
                or compressor not in self.compressor_options[name]):
            # the sharded update owns the payload end to end — a gradient
            # compressor cannot ride it (mirror of the partitioned path)
            compressor = "NoneCompressor"
        proxy = bool(choice.ps_proxy) if sync == "PS" else False
        # wire codec: dense float >= one block only (ADT310/311), never on
        # the AR reduce-scatter path (shards > 1), never on a proxied PS
        # var (no host wire), and compressor-first on conflicts; the
        # ZeroSharded rs/ag wire quantizes like the PS wire
        wire = choice.wire_dtype if choice.wire_dtype in WIRE_DTYPES else "fp32"
        if wire == "int8":
            if ("int8" not in self.wire_options[name]
                    or compressor != "NoneCompressor"
                    or (sync == "AllReduce" and shards > 1)
                    or (sync == "PS" and proxy)):
                wire = "fp32"
        # collective schedule: plain AllReduce wire only (the ZeRO and
        # partitioned paths already ARE scatter/gather compositions), and
        # only algorithms this spec's topology can realize
        sched = (choice.schedule or "auto").lower()
        if (sync != "AllReduce" or zero or shards > 1
                or sched not in self.schedule_options):
            sched = "auto"
        if wire == "int8" and zero:
            # the zero kernel rounds each shard to whole scale blocks:
            # below P x block elements the padded int8 wire is WORSE
            # than fp32 (and the cost model prices the padded truth)
            from autodist_tpu_torch.strategy.zero_sharded_strategy import (
                zero_wire_quantizable)
            if not zero_wire_quantizable(info, self.n_replicas):
                wire = "fp32"
        return VarChoice(sync=sync, compressor=compressor, shards=shards,
                         axis=axis, ps_proxy=proxy, wire_dtype=wire,
                         zero=zero, schedule=sched)

    def make_plan(self, choices: Dict[str, VarChoice], chunk_size: int = 128,
                  staleness: int = 0, remat: Optional[str] = None,
                  compute_dtype: str = "f32",
                  overlap: bool = False) -> PlanSpec:
        canon = tuple((n, self.canon(choices.get(n, VarChoice()), n))
                      for n in self.var_names)
        if any(c.zero for _, c in canon):
            # ADT312 by construction: the ZeRO rs+ag pair is lockstep
            # every step, so a staleness window cannot coexist — drop it
            # in the SPEC (not just at materialization) so describe(),
            # dedup, and the built strategy all agree
            staleness = 0
        if compute_dtype not in COMPUTE_DTYPES:
            # ADT602 by construction: an unknown compute tier has no
            # f32-master guarantee — clamp rather than emit an invalid
            # plan (only the managed tiers exist in this space)
            compute_dtype = "f32"
        # overlap by construction: the schedule sequences SYNC gradient
        # collectives behind the backward pass — a staleness window (the
        # lowering would disarm it with a warning) or fewer than two
        # AllReduce-family sync units (nothing to overlap: one stage is
        # the epilogue) drop the bit in the SPEC so describe()/dedup and
        # the built strategy agree
        ar_units = sum(1 for _, c in canon if c.sync == "AllReduce")
        overlap = bool(overlap) and staleness == 0 and ar_units >= 2
        return PlanSpec(choices=canon, chunk_size=chunk_size,
                        staleness=staleness, remat=remat,
                        compute_dtype=compute_dtype, overlap=overlap)

    # ---------------------------------------------------------------- seeds

    def seeds(self) -> List[Tuple[str, PlanSpec]]:
        """Per-variable re-expressions of the zoo families — the search
        starts where the hand-written builders already are and only moves
        when the cost model says a deviation pays."""
        def compressed(comp, base=None):
            """All-AllReduce (or ``base``) with ``comp`` on every variable
            whose sub-space allows it (canon strips the rest) — the
            analog of the zoo's whole-graph compressor variants."""
            base = base or {}
            return {n: base.get(n) or VarChoice(compressor=comp)
                    for n in self.var_names}

        ar = {n: VarChoice() for n in self.var_names}
        host_ps = {n: VarChoice(sync="PS") for n in self.var_names}
        proxy_ps = {n: VarChoice(sync="PS", ps_proxy=True)
                    for n in self.var_names}
        sparse_ps = {n: VarChoice(sync="PS") for n in self.var_names
                     if self.infos[n].sparse}
        parallax = {n: sparse_ps.get(n) or VarChoice()
                    for n in self.var_names}
        cap = max(len(self.destinations), 2)
        part_ps = {}
        for n in self.var_names:
            shape = _flax_shape(self.infos[n])
            dim0 = shape[0] if shape else 0
            k = smallest_divisor_shards(dim0, cap) if dim0 > 1 else 1
            part_ps[n] = (VarChoice(sync="PS", shards=k, axis=0)
                          if k > 1 else VarChoice(sync="PS"))
        part_ar = {}
        for n in self.var_names:
            shape = _flax_shape(self.infos[n])
            dim0 = shape[0] if shape else 0
            k = (smallest_divisor_shards(dim0, self.n_replicas)
                 if dim0 > 1 and not self.infos[n].sparse else 1)
            part_ar[n] = (VarChoice(shards=k, axis=0) if k > 1
                          else VarChoice())
        # the ZeRO-sharded update families: canon strips ineligible vars
        # (sparse, sub-replica-sized) back to plain AllReduce
        zero = {n: VarChoice(zero=True) for n in self.var_names}
        zero_int8 = {n: VarChoice(zero=True, wire_dtype="int8")
                     for n in self.var_names}
        def wired(base=None, sync="AllReduce"):
            """``base`` (or all-``sync``) with the int8 wire on every
            variable whose sub-space allows it (canon strips the rest) —
            the quantized-wire analog of the compressor seed families."""
            base = base or {}
            return {n: base.get(n) or VarChoice(sync=sync,
                                                wire_dtype="int8")
                    for n in self.var_names}

        out = [
            ("seed:ar", self.make_plan(ar)),
            ("seed:ar512", self.make_plan(ar, chunk_size=512)),
            ("seed:ar-bf16", self.make_plan(
                compressed("HorovodCompressor"))),
            ("seed:ar-int8w", self.make_plan(wired())),
            ("seed:ar-psgd2", self.make_plan(
                compressed("PowerSGDCompressor:2"))),
            ("seed:host-ps", self.make_plan(host_ps)),
            ("seed:ps-int8w", self.make_plan(wired(sync="PS"))),
            ("seed:ps-stale2", self.make_plan(host_ps, staleness=2)),
            ("seed:proxy-ps", self.make_plan(proxy_ps)),
            ("seed:parallax", self.make_plan(parallax)),
            ("seed:parallax-bf16", self.make_plan(
                compressed("HorovodCompressor", base=sparse_ps))),
            ("seed:parallax-int8w", self.make_plan(wired(base=sparse_ps))),
            ("seed:part-ps", self.make_plan(part_ps)),
            ("seed:part-ar", self.make_plan(part_ar)),
            ("seed:zero", self.make_plan(zero)),
            ("seed:zero-int8w", self.make_plan(zero_int8)),
            ("seed:ar-remat", self.make_plan(ar, chunk_size=512,
                                             remat="dots")),
            # the managed bf16 compute tier (f32 master — ADT60x-clean by
            # construction), alone and beside the ZeRO f32-sharded update
            ("seed:ar-bf16c", self.make_plan(ar, compute_dtype="bf16")),
            ("seed:zero-bf16c", self.make_plan(zero,
                                               compute_dtype="bf16")),
            # the overlapped bucketed schedule: small chunks split the
            # backward into more stages (earlier launches, more hiding);
            # make_plan drops the bit on single-sync-unit models
            ("seed:ar-overlap", self.make_plan(ar, chunk_size=8,
                                               overlap=True)),
            ("seed:zero-overlap", self.make_plan(zero, chunk_size=8,
                                                 overlap=True)),
        ]
        if "hier" in self.schedule_options:
            # the two-level schedule exists in this space (multi-host
            # topology spanned): start one family there so the searcher
            # does not have to discover it by mutation alone
            hier = {n: VarChoice(schedule="hier") for n in self.var_names}
            out.append(("seed:ar-hier", self.make_plan(hier)))
        return out

    def from_strategy(self, strategy: Strategy) -> Optional[PlanSpec]:
        """Best-effort conversion of a built (zoo) strategy into a
        PlanSpec seed; ``None`` when the plan uses dimensions outside
        this space (model-parallel ``mp_axes``, uneven ``shard_sizes``,
        async PS, unknown variables)."""
        gc = strategy.graph_config
        if gc.mesh_shape or gc.seq_axis or gc.pp_schedule:
            return None
        choices: Dict[str, VarChoice] = {}
        staleness = 0
        for name in self.var_names:
            node = strategy.find(name)
            if node is None or node.mp_axes or node.shard_sizes is not None:
                return None
            syncs = ([node.synchronizer] if node.synchronizer else
                     [p.synchronizer for p in node.part_configs])
            syncs = [s for s in syncs if s is not None]
            if not syncs:
                return None
            first = syncs[0]
            shards = node.num_shards if node.partitioner else 1
            axis = (node.partition_axis or 0) if node.partitioner else 0
            if isinstance(first, ZeroShardedSynchronizer):
                if node.partitioner:
                    return None  # ADT312 combination: outside the space
                choice = VarChoice(zero=True,
                                   wire_dtype=first.wire_dtype or "fp32")
                canon = self.canon(choice, name)
                if not canon.zero:
                    return None  # ineligible var: not expressible here
                choices[name] = canon
                continue
            if isinstance(first, AllReduceSynchronizer):
                comp = first.compressor or "NoneCompressor"
                wire = first.wire_dtype or "fp32"
                if comp.split(":")[0] in ("Int8Compressor",
                                          "Int8CompressorEF"):
                    # the compressor axis no longer carries int8 (the
                    # wire axis owns it, and the kernels are identical):
                    # convert instead of silently stripping the ~4x
                    # compression the zoo strategy configured
                    comp, wire = "NoneCompressor", "int8"
                choice = VarChoice(compressor=comp, shards=shards,
                                   axis=axis, wire_dtype=wire,
                                   schedule=(getattr(first, "schedule",
                                                     "auto") or "auto"))
            elif isinstance(first, PSSynchronizer):
                if not first.sync:
                    return None  # async PS is outside the search space
                staleness = max(staleness, int(first.staleness or 0))
                choice = VarChoice(sync="PS", shards=shards, axis=axis,
                                   ps_proxy=bool(first.local_replication),
                                   wire_dtype=first.wire_dtype or "fp32")
            else:
                return None
            canon = self.canon(choice, name)
            if canon.shards != choice.shards:
                return None  # partitioning this space cannot express
            choices[name] = canon
        cd = getattr(gc, "compute_dtype", "f32") or "f32"
        if cd not in COMPUTE_DTYPES:
            return None  # an unmanaged compute tier: outside the space
        return self.make_plan(choices, staleness=staleness, remat=gc.remat,
                              compute_dtype=cd,
                              overlap=bool(getattr(gc, "overlap", False)))

    # ------------------------------------------------------------ mutations

    def mutate(self, plan: PlanSpec, rng) -> Optional[Tuple[PlanSpec, str]]:
        """One random plan mutation: ``(new_plan, op_description)`` or
        ``None`` when no operator applies. Deterministic given ``rng``
        state; the result is canonicalized, so it always materializes to
        a strategy the verifier accepts."""
        ops = []
        names = self.var_names
        cm = plan.choice_map()

        def pick_var():
            return names[rng.randrange(len(names))]

        def flip_sync():
            n = pick_var()
            c = cm[n]
            target = "PS" if c.sync == "AllReduce" else "AllReduce"
            new = self.canon(dataclasses.replace(c, sync=target), n)
            return plan.replace_choice(n, new), "sync[%s]=%s" % (n, target)

        ops.append(flip_sync)

        comp_vars = [n for n in names
                     if cm[n].sync == "AllReduce" and cm[n].shards == 1
                     and len(self.compressor_options[n]) > 1]
        if comp_vars:
            def set_compressor():
                n = comp_vars[rng.randrange(len(comp_vars))]
                opts = [o for o in self.compressor_options[n]
                        if o != cm[n].compressor]
                comp = opts[rng.randrange(len(opts))]
                new = self.canon(
                    dataclasses.replace(cm[n], compressor=comp), n)
                return (plan.replace_choice(n, new),
                        "compressor[%s]=%s" % (n, comp))
            ops.append(set_compressor)

        wire_vars = [n for n in names
                     if len(self.wire_options[n]) > 1
                     and not (cm[n].sync == "AllReduce"
                              and cm[n].shards > 1)
                     and not (cm[n].sync == "PS" and cm[n].ps_proxy)]
        if wire_vars:
            def set_wire_dtype():
                n = wire_vars[rng.randrange(len(wire_vars))]
                target = "int8" if cm[n].wire_dtype == "fp32" else "fp32"
                # setting the wire codec clears any compressor (they are
                # mutually exclusive — ADT310; canon resolves
                # compressor-first, so the operator states its intent)
                new = self.canon(dataclasses.replace(
                    cm[n], wire_dtype=target,
                    compressor=("NoneCompressor" if target == "int8"
                                else cm[n].compressor)), n)
                return (plan.replace_choice(n, new),
                        "wire[%s]=%s" % (n, target))
            ops.append(set_wire_dtype)

        zero_vars = [n for n in names if self.zero_ok[n]]
        if zero_vars:
            def set_zero():
                n = zero_vars[rng.randrange(len(zero_vars))]
                target = not cm[n].zero
                # arming the sharded update clears partitioning, the
                # compressor, AND any plan-level staleness window
                # (ADT312; canon would strip zero otherwise — the
                # operator states its intent, mirroring set_wire)
                new = self.canon(dataclasses.replace(
                    cm[n], zero=target,
                    sync="AllReduce" if target else cm[n].sync,
                    shards=1 if target else cm[n].shards,
                    axis=0 if target else cm[n].axis,
                    compressor=("NoneCompressor" if target
                                else cm[n].compressor)), n)
                out = plan.replace_choice(n, new)
                if new.zero and out.staleness:
                    out = dataclasses.replace(out, staleness=0)
                return out, "zero[%s]=%s" % (n, target)
            ops.append(set_zero)

        ps_vars = [n for n in names if cm[n].sync == "PS"]
        if ps_vars:
            def toggle_proxy():
                n = ps_vars[rng.randrange(len(ps_vars))]
                target = not cm[n].ps_proxy
                new = self.canon(
                    dataclasses.replace(cm[n], ps_proxy=target), n)
                return (plan.replace_choice(n, new),
                        "proxy[%s]=%s" % (n, target))
            ops.append(toggle_proxy)

        sched_vars = [n for n in names
                      if cm[n].sync == "AllReduce" and cm[n].shards == 1
                      and not cm[n].zero]
        if sched_vars and len(self.schedule_options) > 1:
            def set_schedule():
                n = sched_vars[rng.randrange(len(sched_vars))]
                opts = [s for s in self.schedule_options
                        if s != cm[n].schedule]
                s = opts[rng.randrange(len(opts))]
                new = self.canon(
                    dataclasses.replace(cm[n], schedule=s), n)
                return (plan.replace_choice(n, new),
                        "schedule[%s]=%s" % (n, s))
            ops.append(set_schedule)

        part_vars = [n for n in names if self.partition_options[n]
                     and not (self.infos[n].sparse
                              and cm[n].sync == "AllReduce")]
        if part_vars:
            def set_shards():
                n = part_vars[rng.randrange(len(part_vars))]
                opts = [(0, 1)] + self.partition_options[n]
                opts = [o for o in opts if o != (cm[n].axis, cm[n].shards)]
                axis, k = opts[rng.randrange(len(opts))]
                new = self.canon(
                    dataclasses.replace(cm[n], shards=k, axis=axis), n)
                return (plan.replace_choice(n, new),
                        "shards[%s]=%dx@%d" % (n, k, axis))
            ops.append(set_shards)

        def set_chunk():
            opts = [c for c in CHUNK_SIZES if c != plan.chunk_size]
            c = opts[rng.randrange(len(opts))]
            return dataclasses.replace(plan, chunk_size=c), "chunk=%d" % c

        ops.append(set_chunk)

        host_ps = [n for n in names
                   if cm[n].sync == "PS" and not cm[n].ps_proxy]
        # the staleness window is a lockstep conflict with the ZeRO
        # rs+ag pair (ADT312): not offered while any zero var is armed
        if host_ps and not any(cm[n].zero for n in names):
            def set_staleness():
                opts = [s for s in STALENESS_CHOICES if s != plan.staleness]
                s = opts[rng.randrange(len(opts))]
                # arming a staleness window disarms the overlap schedule
                # (the lowering would only warn and fall back — the spec
                # states the truth so dedup/describe agree)
                return (dataclasses.replace(
                    plan, staleness=s,
                    overlap=plan.overlap and s == 0), "stale=%d" % s)
            ops.append(set_staleness)

        # the overlap schedule needs >= 2 AllReduce-family sync units
        # (else one stage IS the epilogue) and no staleness window
        ar_units = sum(1 for n in names if cm[n].sync == "AllReduce")
        if ar_units >= 2 and (plan.overlap or plan.staleness == 0):
            def toggle_overlap():
                target = not plan.overlap
                return (dataclasses.replace(plan, overlap=target),
                        "overlap=%s" % target)
            ops.append(toggle_overlap)

        def set_remat():
            opts = [r for r in REMAT_CHOICES if r != plan.remat]
            r = opts[rng.randrange(len(opts))]
            return dataclasses.replace(plan, remat=r), "remat=%s" % r

        ops.append(set_remat)

        def set_compute_dtype():
            opts = [d for d in COMPUTE_DTYPES if d != plan.compute_dtype]
            d = opts[rng.randrange(len(opts))]
            return (dataclasses.replace(plan, compute_dtype=d),
                    "compute=%s" % d)

        ops.append(set_compute_dtype)

        if not ops:
            return None
        op = ops[rng.randrange(len(ops))]
        new_plan, desc = op()
        if new_plan.overlap:
            # a var-level mutation (flip_sync) may have dropped the plan
            # below two AllReduce-family units — re-apply the plan-level
            # canon so overlap never survives on a spec make_plan would
            # refuse to mint
            new_ar = sum(1 for _, c in new_plan.choices
                         if c.sync == "AllReduce")
            if new_ar < 2 or new_plan.staleness:
                new_plan = dataclasses.replace(new_plan, overlap=False)
        if new_plan == plan:
            return None
        return new_plan, desc

    # -------------------------------------------------------- materialize

    def build(self, plan: PlanSpec) -> Strategy:
        """Materialize a PlanSpec into the strategy IR, emitting the same
        node shapes the zoo builders do so the searched plan lowers
        through the exact same kernels."""
        cm = plan.choice_map()
        n_ps = len(self.destinations)
        # greedy least-loaded destination for single-dest host/proxy PS
        # vars (PSLoadBalancing's assignment, deterministic)
        ps_infos = [self.infos[n] for n in self.var_names
                    if cm[n].sync == "PS" and cm[n].shards <= 1]
        assignment = greedy_assign(ps_infos, self.destinations,
                                   byte_size_load_fn)
        # validity by construction (ADT312): the ZeRO-sharded rs+ag pair
        # is lockstep every step, so a plan mixing zero vars with a
        # staleness window materializes with the window dropped — the
        # per-var choices stay free to mutate independently of the
        # plan-level knob
        plan_staleness = (0 if any(c.zero for c in cm.values())
                          else plan.staleness)
        nodes: List[VarConfig] = []
        ar_index = 0   # bucket index over AllReduce-synced vars
        rr = 0         # round-robin pointer for partitioned-PS shards
        for name in self.var_names:
            c = cm[name]
            info = self.infos[name]
            rank = len(_flax_shape(info))
            if c.zero:
                nodes.append(VarConfig(
                    var_name=name,
                    synchronizer=ZeroShardedSynchronizer(
                        wire_dtype=c.wire_dtype)))
                continue
            if c.sync == "AllReduce":
                group = ar_index // max(plan.chunk_size, 1)
                ar_index += 1
                if c.shards > 1:
                    parts = [VarConfig(
                        var_name="%s/part_%d" % (name, i),
                        synchronizer=AllReduceSynchronizer(group=group))
                        for i in range(c.shards)]
                    nodes.append(VarConfig(
                        var_name=name,
                        partitioner=make_partition_str(rank, c.axis,
                                                       c.shards),
                        part_configs=parts))
                else:
                    nodes.append(VarConfig(
                        var_name=name,
                        synchronizer=AllReduceSynchronizer(
                            compressor=c.compressor, group=group,
                            wire_dtype=c.wire_dtype,
                            schedule=c.schedule)))
                continue
            staleness = 0 if c.ps_proxy else plan_staleness
            if c.shards > 1:
                parts = []
                for i in range(c.shards):
                    parts.append(VarConfig(
                        var_name="%s/part_%d" % (name, i),
                        synchronizer=PSSynchronizer(
                            reduction_destination=self.destinations[
                                rr % n_ps],
                            local_replication=c.ps_proxy,
                            sync=True, staleness=staleness,
                            wire_dtype=c.wire_dtype)))
                    rr += 1
                nodes.append(VarConfig(
                    var_name=name,
                    partitioner=make_partition_str(rank, c.axis, c.shards),
                    part_configs=parts))
            else:
                nodes.append(VarConfig(
                    var_name=name,
                    synchronizer=PSSynchronizer(
                        reduction_destination=assignment[name],
                        local_replication=c.ps_proxy,
                        sync=True, staleness=staleness,
                        wire_dtype=c.wire_dtype)))
        return Strategy(node_config=nodes,
                        graph_config=GraphConfig(
                            replicas=list(self.replicas), remat=plan.remat,
                            compute_dtype=plan.compute_dtype,
                            overlap=plan.overlap))
