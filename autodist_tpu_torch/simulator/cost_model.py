"""Analytic strategy cost model: the port's copy of
``autodist_tpu/simulator/cost_model.py``.

An analytic roofline for one training step under a given Strategy on a
given card and cluster: compute from the forward's FLOPs at the card's
dense peak, collective costs from the spec's link bandwidths, PS costs
from per-server byte loads, and a per-device memory estimate that the
plan-level ADT501 gate (``analysis/memory.py``) reads. Its trace inputs
(the forward's FLOPs, activation bytes and model-parallel collectives)
come from the one fake-tensor run ``ModelItem.prepare`` makes
(``model_item.TraceCosts``), where the JAX model traces a jaxpr; the
port counts FLOPs exactly, where the JAX ``count_flops_estimate``
approximates (ROADMAP C).

Deliberately simple (closed-form, no learned component): its job is to
*rank* candidate strategies for ``AutoStrategy``, not to predict wall time
exactly.
"""
import dataclasses
import math
from typing import Dict, Optional

from autodist_tpu_torch.strategy.base import (AllReduceSynchronizer,
                                              PSSynchronizer,
                                        Strategy, ZeroShardedSynchronizer)
from autodist_tpu_torch.utils import logging

# Peak dense bf16 FLOP/s per card: the H100 SXM's 989 TFLOP/s (the
# figure PERF.md's MFU divides by), and the CPU development path's.
# Unknown kinds price as "h100".
CHIP_PEAK_FLOPS = {
    "h100": 989e12,
    "cpu": 5e10,
}
# per-card memory lives in resource_spec.py (the ResourceSpec owns the
# cluster's memory budget; re-exported here)
from autodist_tpu_torch.resource_spec import CHIP_HBM_BYTES  # noqa: E402,F401
# extra compute for gradient rematerialization: "full" re-runs the whole
# forward in the backward (fwd+bwd ~3x fwd -> ~4x), "dots" recomputes
# only the cheap non-contraction work (~3.5x)
REMAT_COMPUTE_FACTOR = {None: 1.0, "full": 4.0 / 3.0, "dots": 3.5 / 3.0}
# step-time gain of the managed bf16 compute tier
# (graph_config.compute_dtype="bf16") over the f32 baseline the model is
# calibrated against: the tensor cores run bf16 products faster than f32
# and the activation traffic halves, but the f32 master update, the casts
# and the f32 gradient collectives claw some back — an analytic 1.8x,
# conservative enough that the searcher only picks bf16 when the plan is
# compute-bound
BF16_COMPUTE_SPEEDUP = 1.8
# Price of the fused 1F1B schedule (parallel/pipeline._run_1f1b): each
# microbatch's stage forward is recomputed in its backward tick —
# ~4(M+S-1) fwd-units vs GPipe's ~3(M+S-1): the 4/3 is the recompute.
F1B_RECOMPUTE_FACTOR = 4.0 / 3.0
DEFAULT_MXU_EFFICIENCY = 0.4      # achieved/peak tensor-core rate assumed
WIRE_DTYPE_BYTES = 4              # gradients travel fp32 unless compressed
# host<->card link for the host-offloaded PS path (no-proxy PS keeps
# values+opt state in host RAM; every step pulls/pushes over PCIe): an
# analytic effective rate, below the H100's PCIe Gen5 x16 peak
PCIE_BANDWIDTH_BYTES_S = 32e9
COMPRESSED_BYTES = {"HorovodCompressor": 2, "HorovodCompressorEF": 2,
                    "BF16Compressor": 2, "BF16CompressorEF": 2,
                    "Int8Compressor": 1, "Int8CompressorEF": 1}
PER_COLLECTIVE_LATENCY_S = 5e-6   # launch overhead per collective/bucket
PER_HOP_LATENCY_S = 1e-6          # per ring/tree hop under topology pricing

# forward wire factors per cost class at axis size k: bytes crossing each
# link of a ring, relative to the TRACED payload (gather traces one shard,
# scatter/permute/alltoall trace the full input, reduce traces the psum
# operand — the classes parallel/mesh.py::recording records at size 1)
_FWD_WIRE_FACTOR = {
    "reduce": lambda k: 2.0 * (k - 1) / k,   # ring all-reduce
    "gather": lambda k: float(k - 1),        # all_gather of one shard
    "scatter": lambda k: (k - 1) / k,        # reduce_scatter of the input
    "permute": lambda k: (k - 1) / k,        # ring hop amortized
    "alltoall": lambda k: (k - 1) / k,
}

# the transpose of each collective is its DUAL class
_DUAL_CLASS = {"gather": "scatter", "scatter": "gather",
               "reduce": "reduce", "permute": "permute",
               "alltoall": "alltoall"}


def collective_wire_bytes(kind: str, traced_bytes: float, k: int,
                          direction: str = "fwd") -> float:
    """Ring wire bytes for one collective of ``kind`` with
    ``traced_bytes`` payload at axis size ``k``.

    ``direction="bwd"`` prices the TRANSPOSE as its dual class with the
    dual's payload:

    - gather (traced B = one shard) transposes to a reduce_scatter of the
      FULL cotangent k*B: wire (k-1)/k * kB = (k-1)B — equal to fwd.
    - scatter (traced B = full input) transposes to an all_gather of k
      shards of B/k: wire (k-1) * B/k — equal to fwd's (k-1)/k * B.
    - reduce's transpose is free, but every Megatron-style layer pairs a
      fwd psum with its dual layer's bwd psum (row- vs column-parallel),
      so the program-level backward moves the same reduce bytes.
    - permute/alltoall are self-dual (inverted permutation / shuffle).
    """
    if direction == "bwd":
        dual = _DUAL_CLASS[kind]
        if kind == "gather":
            return collective_wire_bytes(dual, traced_bytes * k, k, "fwd")
        if kind == "scatter":
            return collective_wire_bytes(dual, traced_bytes / k, k, "fwd")
        return collective_wire_bytes(dual, traced_bytes, k, "fwd")
    return _FWD_WIRE_FACTOR[kind](k) * traced_bytes


@dataclasses.dataclass
class StaticCollectiveProfile:
    """Measured per-step collective costs of a LOWERED program — the
    replacement for the trace heuristics when a lowering exists.

    Built from a lowered collective schedule (duck-typed: anything
    iterable of objects with ``kind``, ``payload_bytes`` and
    ``group_size``). Payloads are the per-device
    operand bytes the program actually moves (forward AND backward ops
    are both present in the text, so no dual-class doubling applies);
    wire bytes are ring-priced per op at its OWN replica-group size —
    more precise than pricing by a single mesh-axis extent.
    """

    class_payload_bytes: Dict[str, float]
    class_wire_bytes: Dict[str, float]
    num_collectives: int = 0
    # per-link-level wire bytes (level name -> bytes/step), populated
    # when the profile is built against a multi-level topology: every
    # replica group's ring edges are attributed to the physical level
    # they cross (analysis/topology.py). Empty on flat specs.
    level_wire_bytes: Dict[str, float] = dataclasses.field(
        default_factory=dict)

    @classmethod
    def from_schedule(cls, schedule, default_group_size: int = 1,
                      topology=None) -> "StaticCollectiveProfile":
        per_step = (schedule.per_step() if hasattr(schedule, "per_step")
                    else schedule)
        levels: Dict[str, float] = {}
        if topology is not None:
            from autodist_tpu_torch.analysis.topology import \
                schedule_level_bytes
            levels = schedule_level_bytes(
                per_step, topology, default_group_size=default_group_size)
        payload: Dict[str, float] = {}
        wire: Dict[str, float] = {}
        n = 0
        for c in per_step:
            k = c.group_size if c.group_size > 1 else default_group_size
            if k <= 1:
                continue  # single-device group: no wire crossed
            payload[c.kind] = payload.get(c.kind, 0.0) + c.payload_bytes
            wire[c.kind] = (wire.get(c.kind, 0.0)
                            + collective_wire_bytes(c.kind,
                                                    c.payload_bytes, k))
            n += 1
        return cls(payload, wire, n, level_wire_bytes=levels)

    @property
    def total_wire_bytes(self) -> float:
        return sum(self.class_wire_bytes.values())


@dataclasses.dataclass
class CostBreakdown:
    compute_s: float
    allreduce_s: float
    ps_s: float
    latency_s: float
    # model-parallel collective time (Megatron psums, ring-attention
    # ppermutes, MoE all_to_alls): these live INSIDE the forward/backward
    # on the compute critical path, so unlike the gradient collectives
    # they do not overlap with compute
    mp_s: float = 0.0
    # per-device HBM estimate (params + optimizer + gradient buffer +
    # activations) and whether it fits the chip — strategies change all
    # four terms: host-PS offloads params/opt, ZeRO partitions them,
    # remat shrinks activations
    hbm_bytes: float = 0.0
    hbm_capacity: float = float("inf")
    # overlapped gradient-sync schedule (graph_config.overlap): did the
    # plan lower sync as a barrier-chained per-bucket schedule, how many
    # stages, and how much collective time stays EXPOSED past the end of
    # the backward (the per-bucket max(compute_tail, wire) queueing
    # recurrence in ``estimate()``, calibrated against the goodput
    # report's measured collective_wait by the drift row "overlap")
    overlap: bool = False
    overlap_stages: int = 0
    overlap_exposed_s: float = 0.0

    @property
    def feasible(self) -> bool:
        return self.hbm_bytes <= self.hbm_capacity

    @property
    def step_time_s(self) -> float:
        # The epilogue lowering computes the FULL gradient, then runs the
        # collectives, then applies: compute and gradient wire add (they
        # only overlap when the program is lowered as an overlap schedule
        # — the old unconditional max(compute, wire) here silently
        # credited every plan with an overlap the lowering never did).
        # Under an overlapped schedule only the EXPOSED tail of the wire
        # (what the backward could not hide — never less than the last
        # bucket's reduce) is paid on top of compute. PS wire,
        # model-parallel collectives and launch latency are serial in
        # both lowerings, so they cancel in overlap-vs-epilogue
        # comparisons.
        wire = self.overlap_exposed_s if self.overlap else self.allreduce_s
        return (self.compute_s + wire + self.ps_s
                + self.mp_s + self.latency_s)


class CostModel:
    def __init__(self, model_item, resource_spec,
                 chip_kind: Optional[str] = None,
                 mxu_efficiency: float = DEFAULT_MXU_EFFICIENCY,
                 flops_per_step: Optional[float] = None,
                 hbm_capacity_bytes: Optional[float] = None,
                 calibration=None,
                 static_profile: Optional[StaticCollectiveProfile] = None):
        self._item = model_item
        self._spec = resource_spec
        # measured collective costs from lowered programs: one profile per
        # strategy id, plus an optional default applied to every strategy
        # (the `static_profile` kwarg). When a strategy has a profile, its
        # collective seconds are priced from MEASURED wire bytes and the
        # heuristic-vs-measured drift is logged per collective class.
        self._static_profiles: Dict[Optional[str], StaticCollectiveProfile] = {}
        if static_profile is not None:
            self._static_profiles[None] = static_profile
        self._chip = chip_kind or self._guess_chip()
        self._eff = mxu_efficiency
        self._flops = flops_per_step
        if hbm_capacity_bytes is not None:
            self._hbm_capacity = hbm_capacity_bytes
        elif chip_kind is not None:
            # an explicit chip override prices that generation's memory
            # even when the spec describes another
            self._hbm_capacity = CHIP_HBM_BYTES[chip_kind]
        else:
            self._hbm_capacity = resource_spec.chip_hbm_bytes()
        self._act_cache = None
        # measured-run correction of the analytic constants: a Calibration,
        # a path to a saved one, or None (uncalibrated)
        if isinstance(calibration, str):
            from autodist_tpu_torch.simulator.calibration import Calibration
            calibration = Calibration.load(calibration)
        self.calibration = calibration

    def attach_static_profile(self, profile: StaticCollectiveProfile,
                              strategy: Optional[Strategy] = None):
        """Attach MEASURED collective costs (a lowered program's
        collective schedule) for ``strategy`` — or, with no strategy, as
        the default for every estimate. Subsequent :meth:`estimate`
        calls price that strategy's collectives from the measured wire
        bytes instead of the trace heuristics and log the per-class
        drift."""
        key = getattr(strategy, "id", None) if strategy is not None else None
        self._static_profiles[key] = profile

    def _static_profile_for(self, strategy: Strategy
                            ) -> Optional[StaticCollectiveProfile]:
        by_id = self._static_profiles.get(getattr(strategy, "id", None))
        return by_id if by_id is not None else self._static_profiles.get(None)

    def _heuristic_wire_by_class(self, strategy: Strategy, n: int,
                                 ar_bytes: float) -> Dict[str, float]:
        """The trace-heuristic wire bytes per collective class — the
        numbers a static profile replaces, kept for drift logging."""
        out: Dict[str, float] = {}
        if n > 1 and ar_bytes > 0:
            out["reduce"] = 2.0 * (n - 1) / n * ar_bytes
        mesh_shape = strategy.graph_config.mesh_shape or {}
        for axis, by_kind in self._collective_profile().items():
            k = int(mesh_shape.get(axis, 1))
            if k <= 1:
                continue
            for kind, traced in by_kind.items():
                out[kind] = out.get(kind, 0.0) + (
                    collective_wire_bytes(kind, traced, k, "fwd")
                    + collective_wire_bytes(kind, traced, k, "bwd"))
        return out

    def _log_static_drift(self, strategy: Strategy,
                          profile: StaticCollectiveProfile, n: int,
                          ar_bytes: float):
        heur = self._heuristic_wire_by_class(strategy, n, ar_bytes)
        for kind in sorted(set(heur) | set(profile.class_wire_bytes)):
            h = heur.get(kind, 0.0)
            m = profile.class_wire_bytes.get(kind, 0.0)
            ratio = (m / h) if h > 0 else float("inf") if m > 0 else 1.0
            logging.info(
                "static profile drift [%s/%s]: heuristic=%.0fB "
                "measured=%.0fB ratio=%.2f", strategy.id, kind, h, m, ratio)

    def verify(self, strategy: Strategy):
        """Static diagnostics for a candidate (``analysis/rules.py``):
        the cheap validity gate the simulator applies BEFORE estimating —
        pricing an un-compilable plan would just hand the auto-strategy
        search a winner that explodes at lowering time."""
        from autodist_tpu_torch.analysis import verify as _verify
        return _verify(strategy, self._item, self._spec)

    def _guess_chip(self) -> str:
        kind = self._spec.chip_kind()
        return kind if kind in CHIP_PEAK_FLOPS else "h100"

    # ---------------------------------------------------------------- pieces

    def _example_batch_size(self) -> int:
        """Leading dim of the example batch (the real batch size), falling
        back to 32 only when no batch is attached."""
        from torch.utils import _pytree as pytree
        for leaf in pytree.tree_leaves(self._item.example_batch):
            shape = getattr(leaf, "shape", ())
            if len(shape) >= 1 and shape[0] > 0:
                return int(shape[0])
        return 32

    def _trace_costs(self):
        """The item's :class:`~autodist_tpu_torch.model_item.TraceCosts`
        (the one fake-tensor run of ``ModelItem.prepare``, shared by the
        FLOPs, activation and collective estimates), or None when the
        item was not traced (no example batch, a step_fn item, a loss
        the fake run could not take): callers fall back to the
        params-based bounds."""
        return getattr(self._item, "trace_costs", None)

    def flops_per_step(self) -> float:
        if self._flops is not None:
            return self._flops
        costs = self._trace_costs()
        if costs is not None:
            fwd = costs.flops
        else:
            # dense fwd ~ 2 * params * batch (the REAL batch size, not a
            # guess — a hardcoded 32 misranks compute- vs comm-bound
            # candidates for large-batch CNNs)
            fwd = 2.0 * (self._item.total_bytes() / 4) * self._example_batch_size()
        self._flops = 3.0 * fwd  # fwd + ~2x bwd
        return self._flops

    def compute_time(self, num_devices: int) -> float:
        peak = CHIP_PEAK_FLOPS[self._chip] * self._eff
        return self.flops_per_step() / max(num_devices, 1) / peak

    def _activation_profile(self):
        """(saved-residual bytes, dot/conv output bytes, batch input
        bytes) from the traced forward — the activation-memory inputs for
        the three remat modes. The trace counts every op's outputs but
        views and shape-only ops (the JAX ``_FUSED_OPS`` rule), once per
        op it runs (a Python loop over 48 layers runs 48 of them). Still
        a heuristic — no liveness analysis — but for TRAINING the sum of
        non-trivial forward outputs approximates the residual set
        autograd keeps, which is what remat trades away."""
        if self._act_cache is not None:
            return self._act_cache
        costs = self._trace_costs()
        if costs is not None:
            total, dots = costs.act_bytes, costs.dot_bytes
            batch_in = costs.batch_bytes
        else:  # params-based bound
            total = 2.0 * self._item.total_bytes()
            dots = total / 2
            batch_in = total / 8
        self._act_cache = (float(total), float(dots), float(batch_in))
        return self._act_cache

    def _collective_profile(self):
        """{axis: {cost class: fwd payload bytes}} of the loss's own
        collectives (``parallel/mesh.py::recording`` in the item's one
        trace). Empty when the loss has no model-parallel collectives or
        was not traced. A traced Python loop runs its real trip count,
        where the JAX walk assumes one for a ``while_loop``
        (``while_trip_count``, which the port therefore lacks)."""
        costs = self._trace_costs()
        return dict(costs.collectives) if costs is not None else {}

    def mp_comm_time(self, strategy: Strategy, ici_bw: float) -> float:
        """Serial model-parallel collective seconds per step, by cost
        class (see ``_FWD_WIRE_FACTOR`` for how each class's traced
        bytes relate to real wire at axis size k). The backward is priced as each collective's DUAL CLASS via
        :func:`collective_wire_bytes` — a gather's transpose is a
        reduce_scatter of the full cotangent, a scatter's is an
        all_gather of the shards, reduce pairs with its dual layer's
        psum (row- vs column-parallel), permute/alltoall invert
        themselves. Per class the dual's wire equals the forward's (see
        the algebra in ``collective_wire_bytes``), so the total comes
        out fwd+bwd = 2x — computed, not asserted."""
        mesh_shape = strategy.graph_config.mesh_shape or {}
        total = 0.0
        for axis, by_kind in self._collective_profile().items():
            k = int(mesh_shape.get(axis, 1))
            if k <= 1:
                continue  # axis not materialized: collective is a no-op
            wire = sum(
                collective_wire_bytes(kind, traced, k, "fwd")
                + collective_wire_bytes(kind, traced, k, "bwd")
                for kind, traced in by_kind.items())
            total += wire / ici_bw
        return total

    def opt_state_bytes(self) -> float:
        """Total optimizer-state bytes (full tree, undistributed); 0.0
        when no optimizer is attached: each slot (``mu``, ``nu``,
        ``trace``) holds a copy of every variable in its dtype, and a
        counting optimizer adds optax's int32 count. Shared by
        :meth:`hbm_bytes` and the plan-level memory analyzer
        (``analysis/memory.py``)."""
        spec = getattr(self._item, "optimizer_spec", None)
        if spec is None:
            return 0.0
        return float(len(spec.slots) * self._item.total_bytes()
                     + (4 if spec.has_count else 0))

    def hbm_bytes(self, strategy: Strategy) -> float:
        """Per-device HBM estimate under a strategy: device-resident
        params + optimizer state + one gradient buffer + activations.
        Host-PS (no proxy) offloads optimizer state (values are still
        pulled to device each step); partitioned storage divides by the
        replica count (ZeRO-3-style); ZeroSharded sync keeps params full
        but divides the optimizer-state share by the replica count (the
        ~(P-1)/P drop the ADT501 gate must project, or sharded plans
        would be refused the memory they just freed);
        ``graph_config.remat`` shrinks the activation term ("dots":
        contraction outputs only; "full": batch residuals plus the peak
        recompute window)."""
        infos = self._item.var_infos
        n = max(len(strategy.graph_config.replicas), 1)
        opt_total = self.opt_state_bytes()
        params_total = float(self._item.total_bytes())

        mesh_shape = strategy.graph_config.mesh_shape or {}
        device_params = 0.0
        device_param_fraction_num = 0.0
        for node in strategy.node_config:
            info = infos.get(node.var_name)
            if info is None:
                continue
            syncs = ([node.synchronizer] if node.synchronizer else
                     [p.synchronizer for p in node.part_configs])
            host_ps = any(isinstance(s, PSSynchronizer)
                          and not s.local_replication for s in syncs)
            zero = any(isinstance(s, ZeroShardedSynchronizer)
                       for s in syncs)
            share = (1.0 / n) if node.partitioner and not host_ps else 1.0
            if node.mp_axes:
                # model-parallel storage: each device holds 1/extent of
                # every sharded dim (tensor/pipeline/expert axes)
                for _dim, axis in dict(node.mp_axes).items():
                    share /= max(int(mesh_shape.get(axis, 1)), 1)
            if host_ps:
                # pulled copy lives on device during the step, but the
                # optimizer state does not
                device_params += info.byte_size
            elif zero:
                # ZeRO-sharded update: params (and the gradient buffer)
                # stay full, but optimizer state is created sharded —
                # each chip holds 1/P of this variable's opt-state share
                device_params += info.byte_size
                device_param_fraction_num += info.byte_size / n
            else:
                device_params += info.byte_size * share
                device_param_fraction_num += info.byte_size * share
        opt_bytes = (opt_total * device_param_fraction_num / params_total
                     if params_total else 0.0)
        grad_bytes = device_params  # one gradient buffer alongside params

        total_act, dot_act, batch_in = self._activation_profile()
        remat = strategy.graph_config.remat
        if remat == "full":
            act = batch_in + (total_act - dot_act) * 0.1  # peak recompute
        elif remat == "dots":
            act = dot_act + batch_in
        else:
            act = total_act + batch_in
        act /= n  # activations scale with the per-device batch shard
        if getattr(strategy.graph_config, "compute_dtype", "f32") == "bf16":
            # the managed bf16 tier stores residuals at half width (params,
            # opt state, and the gradient buffer stay f32 — the master)
            act *= 0.5
        # 1F1B pipeline schedule: at most S microbatches in flight per
        # rank vs GPipe's all-M residency (Narayanan et al. 1806.03377)
        from autodist_tpu_torch import const as _const
        mesh = strategy.graph_config.mesh_shape or {}
        pp = int(mesh.get(_const.PIPELINE_AXIS, 1))
        m = int(strategy.graph_config.pp_microbatches or 1)
        if pp > 1 and strategy.graph_config.pp_schedule == "1f1b" and m > pp:
            act *= pp / m
        return device_params + opt_bytes + grad_bytes + act

    @staticmethod
    def _int8_payload(num_elements: int) -> float:
        """Quantized wire payload at its TRUE byte width: int8 body padded
        to scale blocks PLUS the f32 scale sidecar — the same formula the
        lowering's telemetry counters use
        (``collectives.int8_wire_payload_bytes``), so predicted and
        measured bytes can only drift by padding, never by formula."""
        from autodist_tpu_torch.parallel.collectives import \
            int8_wire_payload_bytes
        q, _ = int8_wire_payload_bytes(num_elements, WIRE_DTYPE_BYTES)
        return float(q)

    def _wire_bytes(self, info, sync, compressed: bool = True,
                    wire_ok: bool = True) -> float:
        from autodist_tpu_torch.kernel.synchronization import \
            compressor as compressor_lib
        from autodist_tpu_torch.parallel.collectives import wire_quantizable
        if getattr(info, "sparse", False):
            # sparse (gather-indexed) gradients ship as (ids, values)
            # pairs and the lowering IGNORES compressors on them (the
            # linter's ADT306) — pricing them compressed let whole-graph
            # compressor candidates win on bytes they never save
            compressed = False
        if (getattr(sync, "wire_dtype", "fp32") or "fp32") == "int8" \
                and wire_ok and wire_quantizable(info):
            # wire_dtype=int8: blockwise int8 + scale sidecar. On the PS
            # path the host wire quantizes regardless of partitioning
            # (shards split host-side after dequant); on AllReduce only
            # the unpartitioned collective honors it (the reduce-scatter
            # path ignores wire codecs — ADT310 warns). The ZeroSharded
            # rs/ag pair is priced separately in :meth:`estimate`
            # through the kernel's padded formula. Callers pass
            # ``wire_ok=False`` on paths the runtime never quantizes
            # (proxied PS, model-parallel complement reductions) so a
            # mispinned plan is not priced 4x cheaper than it runs.
            if getattr(sync, "kind", "") == "PS" or compressed:
                comp = getattr(sync, "compressor", "") or "NoneCompressor"
                if getattr(sync, "kind", "") == "PS" \
                        or comp == "NoneCompressor":
                    return self._int8_payload(info.num_elements)
        if not compressed:
            # partitioned/reduce-scatter syncs ignore compressors entirely
            return info.num_elements * WIRE_DTYPE_BYTES
        try:
            name, rank = compressor_lib.parse_name(getattr(sync, "compressor", ""))
        except ValueError:
            name, rank = getattr(sync, "compressor", ""), None
        if name == "PowerSGDCompressor":
            if len(info.shape) >= 2:
                # PowerSGD flattens trailing dims to an n x m matrix and
                # ships P (n x r) + Q (m x r), so wire bytes scale with rank
                n = info.shape[0]
                m = info.num_elements // max(n, 1)
                return float(rank or 1) * (n + m) * WIRE_DTYPE_BYTES
            # rank-0/1 tensors pass through PowerSGD uncompressed
            return info.num_elements * WIRE_DTYPE_BYTES
        if name in ("Int8Compressor", "Int8CompressorEF"):
            # int8 compressors ride the same blockwise wire codec: the
            # scale sidecar is part of the payload, not free (the byte
            # accounting the drift tests assert on)
            return self._int8_payload(info.num_elements)
        factor = COMPRESSED_BYTES.get(name, None)
        if factor is None:
            factor = WIRE_DTYPE_BYTES
        return info.num_elements * factor

    def _topology_ar_time(self, sched: str, payload: float, topo,
                          n: int) -> float:
        """Price one resolved gradient-sync algorithm per link level.

        ring/rhd move the full 2(n-1)/n*P over the bottleneck level (the
        inter-host link once the group spans hosts) and differ only in
        hop count — 2(n-1) vs 2*ceil(log2 n) latency hops; hier pays
        2(c-1)/c*P at intra speed plus 2(H-1)/H*(P/c) at inter speed
        with 2(c-1)+2(H-1) hops (arXiv 2110.10548's two-level
        reduction). Hops are charged at PER_HOP_LATENCY_S each, which is
        what lets recursive halving/doubling win small payloads and the
        hierarchical schedule win slow inter-host links."""
        if n <= 1 or payload <= 0:
            return 0.0
        intra_bw = topo.intra_level.bandwidth_bytes_s
        inter = topo.inter_level
        inter_bw = inter.bandwidth_bytes_s if inter is not None else intra_bw
        cph = max(topo.chips_per_host, 1)
        hosts = min(max(1, -(-n // cph)), max(topo.hosts, 1))
        c = min(n, cph)
        if sched == "hier" and hosts > 1 and c > 1:
            t = (2.0 * (c - 1) / c * payload / intra_bw
                 + 2.0 * (hosts - 1) / hosts * (payload / c) / inter_bw)
            hops = 2 * (c - 1) + 2 * (hosts - 1)
        else:
            bw = inter_bw if hosts > 1 else intra_bw
            t = 2.0 * (n - 1) / n * payload / bw
            hops = (2 * int(math.ceil(math.log2(n))) if sched == "rhd"
                    else 2 * (n - 1))
        return t + hops * PER_HOP_LATENCY_S

    # ------------------------------------------------------------------ main

    def estimate(self, strategy: Strategy,
                 use_static_profile: bool = True) -> CostBreakdown:
        """Price one candidate. ``use_static_profile=False`` forces the
        pure trace-heuristic pricing even when a measured profile is
        attached — the baseline a drift report compares against —
        without touching shared state."""
        n = max(len(strategy.graph_config.replicas), 1)
        # int8 rings run per-axis on multi-axis meshes (sequential rings),
        # so compression no longer degrades off single-axis meshes
        infos = self._item.var_infos
        ici_bw = self._spec.ici_bandwidth_gbps() * 1e9 / 8  # bytes/s
        # cross-host PS traffic rides the node NICs
        dcn_bw = min((self._spec.network_bandwidth_gbps(a)
                      for a in self._spec.node_addresses)) * 1e9 / 8

        ar_bytes = 0.0
        # gradient-sync payload bytes by RESOLVED collective algorithm
        # (analysis/topology.py resolve_schedule): only plain AllReduce
        # syncs carry the schedule knob; ZeRO/proxied-PS contributions
        # stay on the ring formula. Irrelevant (all "ring") without a
        # topology on the spec.
        ar_sched_bytes: Dict[str, float] = {}
        topo = self._spec.topology()
        ps_load: Dict[str, float] = {}
        groups = set()
        num_ps_transfers = 0
        num_zero_colls = 0
        # overlapped-schedule stage accounting: one stage per concat
        # bucket (group x compressor), per individually-synced AR var,
        # and per ZeRO reduce-scatter — mirrors the lowering's
        # build_grad_sync_schedule unit construction
        from autodist_tpu_torch.parallel.collectives import (_CONCATABLE,
                                                       wire_quantizable)
        overlap_groups = set()
        overlap_pervar = 0
        num_zero_vars = 0
        ps_stale = False
        mesh_cfg = strategy.graph_config.mesh_shape or {}
        for node in strategy.node_config:
            info = infos.get(node.var_name)
            if info is None:
                continue
            syncs = ([node.synchronizer] if node.synchronizer else
                     [p.synchronizer for p in node.part_configs])
            partitioned = bool(node.partitioner)
            # model-parallel vars sync their LOCAL shard over the
            # complement axes only: the payload is 1/extent of the var
            # per sharded mesh axis, and with a trivial complement
            # (dp == 1) there is no gradient collective at all — pricing
            # the full dense bytes here is what made EP/TP/PP candidates
            # look as wire-heavy as plain AllReduce
            mp_share, mp_extent = 1.0, 1
            for _dim, ax in dict(node.mp_axes or {}).items():
                e = max(int(mesh_cfg.get(ax, 1)), 1)
                mp_share /= e
                mp_extent *= e
            complement = max(n // mp_extent, 1)
            for sync in syncs:
                if isinstance(sync, ZeroShardedSynchronizer):
                    # rs + ag move the same ring bytes as one all-reduce
                    # (2(n-1)/n of the payload per link — the factor
                    # applied to ar_bytes below), at lower HBM: the
                    # memory side is priced in hbm_bytes. Two extra
                    # collective launches per variable (no bucketing).
                    # Payload priced through the kernel's own padded
                    # formula (per-shard block rounding on the int8
                    # wire) so predicted and telemetry bytes agree.
                    from autodist_tpu_torch.kernel.synchronization.\
                        zero_synchronizer import zero_wire_payload_bytes
                    wd = (sync.wire_dtype or "fp32"
                          if wire_quantizable(info) else "fp32")
                    ar_bytes += zero_wire_payload_bytes(
                        info.num_elements, n, wd) / max(len(syncs), 1)
                    num_zero_colls += 2
                    num_zero_vars += 1
                elif isinstance(sync, AllReduceSynchronizer):
                    if node.mp_axes and complement == 1:
                        continue  # whole mesh is model axes: no grad sync
                    contrib = mp_share * self._wire_bytes(
                        info, sync, compressed=not partitioned,
                        wire_ok=not node.mp_axes) / max(len(syncs), 1)
                    ar_bytes += contrib
                    if topo is not None:
                        from autodist_tpu_torch.analysis.topology import \
                            resolve_schedule
                        resolved = resolve_schedule(
                            getattr(sync, "schedule", "auto"), topo, n)
                        ar_sched_bytes[resolved] = (
                            ar_sched_bytes.get(resolved, 0.0) + contrib)
                    groups.add(sync.group)
                    if not node.mp_axes:
                        # schedule-unit classification, mirroring the
                        # lowering: compressed concatable vars share a
                        # bucket stage per (group, compressor); a
                        # NoneCompressor var on the int8 wire gets
                        # Int8CompressorEF substituted and buckets too;
                        # everything else syncs as its own stage
                        comp = (getattr(sync, "compressor", None)
                                or "NoneCompressor")
                        wd = getattr(sync, "wire_dtype", "fp32") or "fp32"
                        if (comp == "NoneCompressor" and wd == "int8"
                                and wire_quantizable(info)):
                            comp = "Int8CompressorEF"
                        if (not partitioned and comp != "NoneCompressor"
                                and comp in _CONCATABLE):
                            overlap_groups.add((sync.group, comp))
                        else:
                            overlap_pervar += 1
                elif isinstance(sync, PSSynchronizer):
                    if ((getattr(sync, "staleness", 0) or 0) > 0
                            or not getattr(sync, "sync_mode", True)):
                        ps_stale = True  # overlap disarms (lowering parity)
                    if sync.local_replication:
                        # proxied PS is device-resident: its sync is an
                        # on-device psum — ICI traffic, no PCIe (and no
                        # host wire for wire_dtype to quantize)
                        ar_bytes += (self._wire_bytes(
                            info, sync, compressed=False, wire_ok=False)
                            / max(len(syncs), 1))
                        num_ps_transfers += 1
                        continue
                    dest = sync.reduction_destination.split(":")[0] or "ps"
                    ps_load[dest] = ps_load.get(dest, 0.0) + (
                        self._wire_bytes(info, sync,
                                         compressed=not partitioned)
                        / max(len(syncs), 1))
                    num_ps_transfers += 1

        # ring all-reduce: 2*(N-1)/N of the payload crosses each link;
        # with a multi-level topology on the spec each resolved schedule
        # is priced per level at that level's link speed instead
        if topo is not None and n > 1 and ar_bytes > 0:
            other = ar_bytes - sum(ar_sched_bytes.values())
            if other > 0:
                ar_sched_bytes["ring"] = (ar_sched_bytes.get("ring", 0.0)
                                          + other)
            allreduce_s = sum(
                self._topology_ar_time(sched, payload, topo, n)
                for sched, payload in ar_sched_bytes.items())
        else:
            allreduce_s = ((2.0 * (n - 1) / n) * ar_bytes / ici_bw
                           if n > 1 else 0.0)
        mp_s = self.mp_comm_time(strategy, ici_bw)
        profile = (self._static_profile_for(strategy)
                   if use_static_profile else None)
        if profile is not None:
            # a lowering exists: price collectives from the MEASURED wire
            # bytes (fwd+bwd ops are both in the program text, each ring-
            # priced at its own replica-group size) and log the drift the
            # heuristics would have had. Reduce-class stays on the
            # overlappable gradient path; everything else (gathers,
            # permutes, all-to-alls) is in-loss model-parallel traffic on
            # the compute critical path, like the heuristic mp_s.
            self._log_static_drift(strategy, profile, n, ar_bytes)
            allreduce_s = profile.class_wire_bytes.get("reduce", 0.0) / ici_bw
            mp_s = sum(w for kind, w in profile.class_wire_bytes.items()
                       if kind != "reduce") / ici_bw
        # PS (host-offloaded, no proxy): every step pulls values host->device
        # and pushes grads device->host over PCIe on each node, plus
        # cross-node serving over the busiest server's NIC
        single = self._spec.is_single_node()
        ps_bytes = max(ps_load.values(), default=0.0)
        pcie_s = (2.0 * sum(ps_load.values()) / PCIE_BANDWIDTH_BYTES_S
                  if ps_load else 0.0)
        ps_s = pcie_s + (ps_bytes * 2.0 * (n - 1) / n / dcn_bw
                         if (n > 1 and not single) else 0.0)
        latency_s = PER_COLLECTIVE_LATENCY_S * (len(groups) + num_ps_transfers
                                                + num_zero_colls)
        remat_factor = REMAT_COMPUTE_FACTOR.get(
            strategy.graph_config.remat, 1.0)
        compute_s = self.compute_time(n) * remat_factor
        if getattr(strategy.graph_config, "compute_dtype",
                   "f32") == "bf16":
            # managed bf16 tier: forward/backward at the bf16 MXU rate;
            # master params, opt state and gradient collectives stay f32,
            # so only the compute term moves (wire terms are unchanged)
            compute_s /= BF16_COMPUTE_SPEEDUP
        # GPipe bubble: S stages over M microbatches keep each device
        # busy M/(S-1+M) of the schedule (Huang et al. 1811.06965)
        from autodist_tpu_torch import const as _const
        mesh_shape_cfg = strategy.graph_config.mesh_shape or {}
        pp = int(mesh_shape_cfg.get(_const.PIPELINE_AXIS, 1))
        if pp > 1:
            m = int(strategy.graph_config.pp_microbatches or 1)
            if strategy.graph_config.pp_schedule == "interleaved":
                # virtual stages cut the fill/drain bubble by V: per-rank
                # work slots go M -> M*V while the bubble stays S-1 slots
                # (Narayanan et al. 2104.04473)
                v = max(int(strategy.graph_config.pp_virtual or 2), 1)
                compute_s *= ((pp - 1) / v + m) / m
            else:
                compute_s *= (pp - 1 + m) / m
            if strategy.graph_config.pp_schedule == "1f1b":
                # the fused schedule recomputes each stage forward from
                # the stashed input in its backward tick (per-microbatch
                # remat): ~one extra forward on top of fwd+bwd
                compute_s *= F1B_RECOMPUTE_FACTOR
        cal = self.calibration
        if cal is not None:
            compute_s *= cal.compute_scale
            allreduce_s *= cal.ar_scale
            ps_s *= cal.ps_scale
            latency_s *= cal.latency_scale
            mp_s *= cal.ar_scale  # same wire as the gradient collectives
        # overlapped schedule (graph_config.overlap): per-bucket
        # launch-as-ready recurrence over the CALIBRATED compute/wire
        # terms. Buckets become launchable as the backward sweep reaches
        # them (uniform spacing over the backward ~2/3 of compute); each
        # reduce occupies the wire for ar/k, so
        #   wire_free_i = max(ready_i, wire_free_{i-1}) + ar/k
        # and the EXPOSED wait is what spills past the end of compute —
        # never less than the tail bucket's ar/k (its gradients only
        # exist once the backward finishes). The un-merged launch chain
        # additionally pays one collective latency per stage, which is
        # what makes a compute-bound spec (tiny ar, many stages) refuse
        # overlap while a bandwidth-bound one hides ~ar*(k-1)/k.
        overlap = (bool(getattr(strategy.graph_config, "overlap", False))
                   and n > 1 and not ps_stale)
        overlap_stages = 0
        overlap_exposed_s = 0.0
        if overlap:
            k = max(len(overlap_groups) + overlap_pervar + num_zero_vars, 1)
            overlap_stages = k
            fwd = compute_s / 3.0
            bwd = compute_s - fwd
            w = allreduce_s / k
            wire_free = 0.0
            for i in range(1, k + 1):
                ready = fwd + bwd * (i / k)
                wire_free = max(ready, wire_free) + w
            overlap_exposed_s = max(wire_free - compute_s, 0.0)
            latency_s += (PER_COLLECTIVE_LATENCY_S
                          * (cal.latency_scale if cal is not None else 1.0)
                          * k)
        return CostBreakdown(compute_s=compute_s,
                             allreduce_s=allreduce_s, ps_s=ps_s,
                             latency_s=latency_s, mp_s=mp_s,
                             hbm_bytes=self.hbm_bytes(strategy),
                             hbm_capacity=self._hbm_capacity,
                             overlap=overlap,
                             overlap_stages=overlap_stages,
                             overlap_exposed_s=overlap_exposed_s)
