"""Host-resident parameter-server data path (PyTorch counterpart of
``autodist_tpu/parallel/ps.py``).

The reference places each PS variable and its update op ON a
parameter-server device, a host CPU, and its workers read and write it
over the wire every step (reference
``autodist/kernel/synchronization/ps_synchronizer.py:171-176``). Here a
PS variable without a proxy (``local_replication=False``) and its
optimizer state rest in **host memory**, off the card:

- at each step the store is **pulled**: the values cross to the device
  and the step's loss sees them beside the device-resident params;
- the step returns the mean gradient of every PS variable instead of
  updating it — dense, or the (ids, values) pairs of a lookup table
  (``ops/embedding.py``), or the int8 wire container — and the store is
  **pushed**: the gradients cross back, are split by the true shard
  ranges (uneven ``shard_sizes`` kept as they are: host storage is
  ragged, never padded) and the optimizer applies on the host CPU, shard
  by shard.

With more than one replica every rank keeps a mirror of the store and
applies the identical mean gradient, so the mirrors stay bit-equal (the
reference's "every worker transforms its own graph");
``reduction_destination`` names the owner, whose copy the JAX package's
async serving treats as authoritative. That serving mode, its degraded
reads and the remote optimizer-state channel are the control plane
(ROADMAP A item 8) and are not here: ``sync=False`` is refused by the
lowering.

The JAX package carves PS variables out of its pytree state as
``PSHole`` nodes; the port's state is keyed by name, so PS variables are
simply absent from the device params and the device optimizer state, and
each step fills them in from the pulled values.

On ``cuda`` the values rest in pinned memory, and the copies run on a
side stream (:class:`_Wire`): a pull's host-to-device copy is waited on
by the host before the store may change (the update writes in place) and
recorded on the steps' stream, which uses it; a push's
device-to-host copy waits on an event the step recorded, lands in
pinned buffers and is waited on before the host reads it.

Fused supersteps (``DistributedStep.multi_step``) keep the store's
variables on the device for a run of supersteps instead: the values
(:meth:`PSStore.pull` with ``wire=False``) and each variable's
optimizer state as one full-variable tree (:meth:`PSStore.
full_little_opt`) cross once, the supersteps apply the optimizer there,
and :meth:`PSStore.absorb_device_state` takes the result back, split by
shard range, at the next read of the store.
"""
import collections
import concurrent.futures
import dataclasses
import hashlib
import os
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from autodist_tpu_torch import const
from autodist_tpu_torch.convert import (from_flax, from_jax_layout,
                                        to_flax, to_jax_layout)
from autodist_tpu_torch.parallel import collectives
from autodist_tpu_torch.telemetry import spans as tel

# ------------------------------------------------------------------- plans


@dataclasses.dataclass(frozen=True)
class PSVarPlan:
    """Host-residency plan of one PS variable.

    ``destinations`` has one owner device string a shard (one for an
    unpartitioned variable); ``shard_sizes`` are the TRUE sizes along
    ``axis`` (uneven allowed) of the variable in the JAX package's layout
    (its flax shape: a Dense ``weight [out, in]`` splits ``[in, out]``'s
    axis 0), so each shard holds the JAX shard's elements.
    ``wire_dtype="int8"`` quantizes the step's
    host<->device wire: a pull ships the value as blockwise int8 + f32
    scales (dequantized on the device), a push ships the reduced gradient
    the same way (dequantized at the store before the apply); the store
    itself holds exact float32."""
    var_name: str
    destinations: Tuple[str, ...]
    shard_sizes: Optional[Tuple[int, ...]] = None   # None = unpartitioned
    axis: int = 0
    sync: bool = True
    staleness: int = 0
    sparse: bool = False
    wire_dtype: str = "fp32"

    @property
    def partitioned(self) -> bool:
        return self.shard_sizes is not None and len(self.shard_sizes) > 1

    def shard_ranges(self) -> List[Tuple[int, int]]:
        if not self.shard_sizes:
            return [(0, -1)]
        ranges, off = [], 0
        for s in self.shard_sizes:
            ranges.append((off, off + s))
            off += s
        return ranges


def _flax_shape(info) -> Tuple[int, ...]:
    return tuple(getattr(info, "flax_shape", None) or info.shape)


def _even_or_given_sizes(node, info) -> Tuple[int, ...]:
    if node.shard_sizes:
        return tuple(node.shard_sizes)
    n = node.num_shards
    dim = _flax_shape(info)[node.partition_axis or 0]
    base, rem = divmod(dim, n)
    return tuple(base + (1 if i < rem else 0) for i in range(n))


def plan_host_ps(strategy, var_infos) -> Dict[str, PSVarPlan]:
    """The host-resident variables of a compiled strategy: each trainable
    variable PS-synchronized without a proxy (``ProxyVariable.plan``
    decides cached vs resident). Proxied PS variables stay on the device;
    AllReduce variables never come here."""
    from autodist_tpu_torch.kernel.common.proxy_variable import ProxyVariable
    from autodist_tpu_torch.strategy.base import PSSynchronizer as PSConfig

    def cached(cfg) -> bool:
        return ProxyVariable.plan("", cfg).cached

    def wire_for(info, syncs) -> str:
        """int8 only when EVERY shard config asks for it and the variable
        is dense float (the linter's ADT310: sparse gradients ship (ids,
        values) pairs, integers have no absmax scale)."""
        if not collectives.wire_quantizable(info):
            return "fp32"
        if all((getattr(s, "wire_dtype", "fp32") or "fp32") == "int8"
               for s in syncs):
            return "int8"
        return "fp32"

    plans: Dict[str, PSVarPlan] = {}
    for node in strategy.node_config:
        info = var_infos.get(node.var_name)
        if info is None or not info.trainable or node.mp_axes:
            continue
        sync_cfg = node.synchronizer
        part_syncs = [p.synchronizer for p in node.part_configs
                      if p.synchronizer is not None]
        if node.partitioner and part_syncs:
            if not all(isinstance(s, PSConfig) for s in part_syncs):
                continue
            if any(cached(s) for s in part_syncs):
                continue  # proxied: the device path
            plans[node.var_name] = PSVarPlan(
                var_name=node.var_name,
                destinations=tuple(s.reduction_destination
                                   for s in part_syncs),
                shard_sizes=_even_or_given_sizes(node, info),
                axis=node.partition_axis or 0,
                sync=all(s.sync for s in part_syncs),
                staleness=max(s.staleness for s in part_syncs),
                sparse=info.sparse,
                wire_dtype=wire_for(info, part_syncs))
        elif isinstance(sync_cfg, PSConfig):
            if cached(sync_cfg):
                continue  # proxied: device-resident
            plans[node.var_name] = PSVarPlan(
                var_name=node.var_name,
                destinations=(sync_cfg.reduction_destination,),
                sync=sync_cfg.sync,
                staleness=sync_cfg.staleness,
                sparse=info.sparse,
                wire_dtype=wire_for(info, [sync_cfg]))
    return plans


# -------------------------------------------------------------------- wire


class _Wire:
    """The store's copies between the host and ``device``. On ``cuda``
    both directions run on one side stream; each waits for its copies
    before returning, so the host memory involved is free to change and
    the device tensors are complete. On the CPU a pull copies (the step
    must never alias the store, which updates in place) and a push passes
    through."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None
        # the steps' stream: the one current where the store is made
        self.compute = (torch.cuda.current_stream(self.device)
                        if self.cuda else None)

    def to_device(self, host):
        if not self.cuda:
            return pytree.tree_map(lambda t: t.clone(), host)
        with torch.cuda.stream(self.stream):
            out = pytree.tree_map(
                lambda t: t.to(self.device, non_blocking=True), host)
            done = torch.cuda.Event()
            done.record(self.stream)
        done.synchronize()
        # the step uses them on its stream: the allocator must not reuse
        # their memory before the work queued there is done
        for t in pytree.tree_leaves(out):
            t.record_stream(self.compute)
        return out

    def to_host(self, tree, ready=None):
        """Device tensors to the host (pinned) once ``ready`` (an event
        the step recorded after producing them) has passed."""
        if not self.cuda:
            return pytree.tree_map(lambda t: t.detach(), tree)
        with torch.cuda.stream(self.stream):
            if ready is not None:
                self.stream.wait_event(ready)

            def copy(t):
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t, non_blocking=True)
                return host
            out = pytree.tree_map(copy, tree)
            done = torch.cuda.Event()
            done.record(self.stream)
        done.synchronize()
        return out


# -------------------------------------------------------------------- store


def _nbytes(t) -> int:
    return int(t.numel() * t.element_size())


class PSStore:
    """Host-memory parameter server: values and optimizer state a shard.

    The store is the reference's PS device: parameters rest here, the
    update applies here on the host CPU (the port's ``optim.py``
    arithmetic, optax's float32, on CPU tensors, in place), and the step
    only ever sees pulled copies. Each shard keeps its own little
    optimizer state (the optimizer's state of ``{"v": shard}``: Adam's
    ``{"count", "mu": {"v"}, "nu": {"v"}}``, the JAX store's per-shard
    ``optimizer.init({"v": shard})``), so a clip's norm is the shard's,
    as in the JAX store. The apply fans
    the shards out over a deterministic round-robin thread pool
    (``ADT_PS_APPLY_THREADS``): each shard's arithmetic is the same in
    any grouping, so the result is bit-exact against one thread.

    ``stats`` counts the wire: pulls and pushes and their bytes, as the
    JAX store counts them. ``version`` is the number of pushes applied;
    a pull is tagged with the version it read (:meth:`pull`). One lock
    orders the apply against the pulls, so a pull reads one version of
    every variable."""

    def __init__(self, plans: Dict[str, PSVarPlan], var_infos, optimizer,
                 device="cpu"):
        self.plans = dict(plans)
        self._var_infos = var_infos
        self._optimizer = optimizer
        self._wire = _Wire(device)
        # variables whose step wire ships blockwise int8 + scales
        self.wire_quant = sorted(n for n, p in self.plans.items()
                                 if p.wire_dtype == "int8")
        self._jax_names = {n: var_infos[n].collective_name
                           for n in self.wire_quant}
        self._values: Dict[str, List[torch.Tensor]] = {}
        self._opt: Dict[str, List[dict]] = {}
        self.stats = {"pulls": 0, "pushes": 0, "applies": 0,
                      "bytes_pulled": 0, "bytes_pushed": 0}
        self.version = 0
        self._lock = threading.Lock()
        n = const.ENV.ADT_PS_APPLY_THREADS.val
        if n <= 0:
            n = min(4, os.cpu_count() or 1)
        self._apply_threads = n
        self._apply_pool = None  # built at the first parallel apply

    # ------------------------------------------------------------ lifecycle

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        """A float32 CPU copy of ``t`` that this store owns (pinned when
        the device is a card)."""
        out = torch.as_tensor(t).detach().to("cpu", torch.float32,
                                             copy=True).contiguous()
        return out.pin_memory() if self._wire.cuda else out

    @staticmethod
    def _shard_slice(plan: PSVarPlan, si: int, full: torch.Tensor
                     ) -> torch.Tensor:
        lo, hi = plan.shard_ranges()[si]
        return full.narrow(plan.axis, lo, hi - lo)

    def _split(self, plan: PSVarPlan, full: torch.Tensor):
        """A full value (the port's layout) as the plan's shards: itself
        unpartitioned, else views of its JAX layout (``convert.to_flax``)
        along the plan axis."""
        if not plan.partitioned:
            return [full]
        info = self._var_infos[plan.var_name]
        flax = to_flax(full, info.collective_name, _flax_shape(info))
        return [self._shard_slice(plan, si, flax)
                for si in range(len(plan.shard_ranges()))]

    def _join(self, plan: PSVarPlan, shards) -> torch.Tensor:
        """Inverse of :meth:`_split`: the shards as one full value of the
        port's layout (a new tensor when there is more than one)."""
        if len(shards) == 1:
            return shards[0]
        info = self._var_infos[plan.var_name]
        return from_flax(torch.cat(shards, dim=plan.axis), info.shape,
                         info.collective_name)

    def init_params(self, full_params) -> None:
        """Take copies of the PS variables of a ``{name: tensor}``
        mapping, with fresh optimizer state."""
        with self._lock:
            for name, plan in self.plans.items():
                self._values[name] = [
                    self._host(s) for s in self._split(
                        plan, torch.as_tensor(full_params[name]))]
                self._opt[name] = [self._optimizer.init({"v": s})
                                   for s in self._values[name]]

    def load_opt_from_full(self, opt_state) -> None:
        """Each shard's optimizer state from a full-layout optimizer state
        (the count, and each slot's ``{name: t}``: a checkpoint's): the
        slots sliced by shard range, the count copied whole."""
        with self._lock:
            for name, plan in self.plans.items():
                full = {"count": opt_state["count"]} \
                    if self._optimizer.has_count else {}
                for slot in self._optimizer.slots:
                    full[slot] = {"v": opt_state[slot][name]}
                self._opt[name] = self._split_little(plan, full)

    def _split_little(self, plan: PSVarPlan, little: dict) -> List[dict]:
        """Each shard's little state from a full variable's: the slots
        split as the values are (:meth:`_split`; copies, float32,
        contiguous), the count copied whole to each (the JAX
        ``load_opt_from_full`` and ``absorb_device_state`` rule)."""
        states = [{} for _ in plan.shard_ranges()]
        for st in states:
            if "count" in little:
                st["count"] = torch.as_tensor(little["count"]).to(
                    "cpu", torch.int32, copy=True)
        for slot in self._optimizer.slots:
            full = torch.as_tensor(little[slot]["v"]).cpu()
            for st, part in zip(states, self._split(plan, full)):
                st[slot] = {"v": self._host(part)}
        return states

    # ------------------------------------------------------------- step i/o

    def _local_full(self) -> Dict[str, torch.Tensor]:
        return {name: self._join(plan, self._values[name])
                for name, plan in self.plans.items()}

    def pull(self, wire: bool = True) -> Tuple[dict, int]:
        """The current full values on the device (the workers' per-step
        PS read) and the version they are. ``wire=True`` ships each
        int8-wire variable as its ``{"q", "s"}`` container, quantized here
        with the codec's numpy mirror and dequantized on the device;
        ``wire=False`` (the fused carry's pull) ships exact float32, and
        the fused microsteps apply the codec themselves."""
        with tel.span("ps.pull", "ps", step=self.stats["pulls"]):
            out = self._pull_impl(wire)
        tel.counter_add("ps.pulls")
        return out

    def _pull_impl(self, wire: bool):
        nbytes = 0
        with self._lock:
            host = self._local_full()
            for name in sorted(host):
                if wire and name in self._jax_names:
                    # blocks in the JAX element order: the same elements
                    # share a scale in both packages
                    w = collectives.quant_wire_np(to_jax_layout(
                        host[name], self._jax_names[name]).contiguous()
                        .numpy())
                    host[name] = {k: torch.from_numpy(v)
                                  for k, v in w.items()}
                    qb = _nbytes(host[name]["q"]) + _nbytes(host[name]["s"])
                    tel.counter_add("wire.bytes_quantized", qb)
                    tel.counter_add("wire.bytes_saved",
                                    self._var_infos[name].byte_size - qb)
                    nbytes += qb
                else:
                    nbytes += _nbytes(host[name])
            staged = self._wire.to_device(host)
            version = self.version
        self.stats["bytes_pulled"] += nbytes
        self.stats["pulls"] += 1
        tel.counter_add("ps.bytes_pulled", nbytes)
        return staged, version

    def push(self, grads: dict, ready=None) -> None:
        """Hand the mean-reduced gradients to the PS: to the host (after
        the ``ready`` event), then :meth:`apply_local`. Every rank
        replays the same deterministic update on its mirror."""
        with tel.span("ps.push", "ps", step=self.stats["pushes"]):
            host = self._wire.to_host(grads, ready)
            nbytes = 0
            host_grads = {}
            for name in sorted(host):
                host_grads[name], b = self._grad_to_host(name, host[name])
                nbytes += b
            self.stats["bytes_pushed"] += nbytes
            self.apply_local(host_grads)
            self.stats["pushes"] += 1
        tel.counter_add("ps.pushes")
        tel.counter_add("ps.bytes_pushed", nbytes)

    def _grad_to_host(self, name: str, g):
        """(the host form of one pushed gradient, the bytes that crossed
        the wire): a wire-quantized gradient arrives as its ``{"q", "s"}``
        container (blocks in the JAX element order,
        ``convert.to_jax_layout``) and dequantizes here (the store never
        sees int8); dense arrays and sparse (ids, values) pairs pass
        through."""
        if isinstance(g, dict):
            info = self._var_infos[name]
            qb = _nbytes(g["q"]) + _nbytes(g["s"])
            flat = torch.from_numpy(collectives.dequant_wire_np(
                {k: v.numpy() for k, v in g.items()}, (info.num_elements,)))
            dense = from_jax_layout(flat, info.shape, self._jax_names[name])
            tel.counter_add("wire.bytes_quantized", qb)
            tel.counter_add("wire.bytes_saved", _nbytes(dense) - qb)
            return dense, qb
        if isinstance(g, (tuple, list)):
            return tuple(g), sum(_nbytes(x) for x in g)
        return g, _nbytes(g)

    def _densify(self, name: str, pair) -> torch.Tensor:
        """(ids, values) -> the dense mean gradient of the full variable,
        by ``np.add.at``: a repeated id's rows add in order, as in the JAX
        store."""
        ids, vals = (np.asarray(x) for x in pair)
        ids = ids.reshape(-1)
        vals = vals.reshape(ids.shape[0], -1)
        shape = tuple(self._var_infos[name].shape)
        dense = np.zeros(shape, vals.dtype).reshape(shape[0], -1)
        np.add.at(dense, ids, vals)
        return torch.from_numpy(dense.reshape(shape))

    def apply_local(self, grads: Dict[str, object]) -> None:
        """The PS-side update op: each gradient (a full dense tensor or a
        sparse (ids, values) pair, densified) split by shard range and
        applied through the optimizer to the resident shards, in place,
        on the host CPU."""
        work = {}
        for name, g in grads.items():
            plan = self.plans[name]
            g = self._densify(name, g) if isinstance(g, tuple) else g
            for si, gs in enumerate(self._split(plan, g)):
                work["%s::%d" % (name, si)] = (name, si, gs.contiguous())
        if not work:
            return
        with self._lock, tel.span("ps.apply", "ps", shards=len(work)):
            self._apply_sharded(work)
            self.version += 1
        tel.counter_add("ps.applies", len(work))
        self.stats["applies"] += len(grads)

    def _apply_sharded(self, work) -> None:
        """The per-shard updates, round-robin over sorted keys: one group
        on the calling thread when the pool is off or there is one shard,
        else a group a pool thread."""
        keys = sorted(work)

        def run(group):
            for key in group:
                name, si, g = work[key]
                self._optimizer.update({"v": g}, self._opt[name][si],
                                       {"v": self._values[name][si]})
        n = min(self._apply_threads, len(keys))
        if n <= 1:
            run(keys)
            return
        if self._apply_pool is None:
            self._apply_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=self._apply_threads,
                thread_name_prefix="adt-ps-apply")
        for f in [self._apply_pool.submit(run, keys[i::n])
                  for i in range(n)]:
            f.result()

    def close(self) -> None:
        if self._apply_pool is not None:
            self._apply_pool.shutdown(wait=True)
            self._apply_pool = None

    # ---------------------------------------------------------- checkpoints

    def full_values(self) -> Dict[str, torch.Tensor]:
        """Every variable's full value on the host (copies), for
        checkpoints and gathers; not counted as wire."""
        with self._lock:
            return {n: t.clone() for n, t in self._local_full().items()}

    def full_opt_leaf(self, slot: str, var_name: str) -> torch.Tensor:
        """One variable's slot (``mu``, ``nu``, ``trace``) in its full
        layout: the shards' slots concatenated along the plan axis."""
        plan = self.plans[var_name]
        with self._lock:
            parts = [st[slot]["v"] for st in self._opt[var_name]]
            return (parts[0].clone() if len(parts) == 1
                    else self._join(plan, parts))

    def full_little_opt(self, name: str) -> dict:
        """One variable's optimizer state as a FULL-variable little tree
        (the structure of ``optimizer.init({"v": full_value})``), copies
        assembled from the shards' states: the slots concatenated along
        the plan axis, the count from shard 0 (the JAX
        ``full_little_opt``). The fused carry; the inverse of
        :meth:`absorb_device_state`."""
        out = {}
        with self._lock:
            states = list(self._opt[name])
        if "count" in states[0]:
            out["count"] = states[0]["count"].clone()
        for slot in self._optimizer.slots:
            out[slot] = {"v": self.full_opt_leaf(slot, name)}
        return out

    def pull_little_opts(self) -> Dict[str, dict]:
        """Every variable's :meth:`full_little_opt` on the device, through
        the wire (the fused carry's optimizer half; not counted as a
        pull, as in the JAX store)."""
        return self._wire.to_device({n: self.full_little_opt(n)
                                     for n in self.var_names})

    def absorb_device_state(self, values: Dict[str, torch.Tensor],
                            opt_states: Dict[str, dict]) -> None:
        """Take back the state the fused supersteps computed on the device
        (the JAX ``absorb_device_state``): each full value split by the
        true shard ranges, each full little optimizer state sliced per
        shard (:meth:`_split_little`), copied to the host and swapped in
        under the lock. One write-back replaces the k-microstep pushes,
        and the counters say so: ``bytes_pushed`` the values' bytes,
        ``applies`` one a variable, ``pushes`` one."""
        bytes0 = self.stats["bytes_pushed"]
        ready = None
        if self._wire.cuda:
            # the supersteps' stream produced them: the side stream's
            # copies wait for it
            ready = torch.cuda.Event()
            ready.record()
        with tel.span("ps.absorb", "ps", vars=len(values)):
            host = self._wire.to_host({"v": values, "o": opt_states}, ready)
            for name in sorted(host["v"]):
                plan = self.plans[name]
                full = host["v"][name]
                new_vals = [self._host(p) for p in self._split(plan, full)]
                new_opt = self._split_little(plan, host["o"][name])
                self.stats["bytes_pushed"] += _nbytes(full)
                with self._lock:
                    self._values[name] = new_vals
                    self._opt[name] = new_opt
                self.stats["applies"] += 1
        if values:
            with self._lock:
                self.version += 1
            self.stats["pushes"] += 1
            tel.counter_add("ps.pushes")
            tel.counter_add("ps.bytes_pushed",
                            self.stats["bytes_pushed"] - bytes0)

    # ------------------------------------------------------------ accounting

    def mirror_digest(self) -> str:
        """md5 of every resident value: the ranks' mirrors must stay
        bit-equal (the same mean gradient through the same apply), which
        ``ADT_PS_MIRROR_CHECK_EVERY`` checks across the ranks."""
        h = hashlib.md5()
        with self._lock:
            for name in sorted(self._values):
                h.update(name.encode())
                for s in self._values[name]:
                    h.update(s.contiguous().numpy().tobytes())
        return h.hexdigest()

    def resident_bytes(self) -> int:
        """Host bytes of the values resident in this store (values only,
        as the JAX store counts them)."""
        return sum(_nbytes(s) for shards in self._values.values()
                   for s in shards)

    def resident_bytes_by_destination(self) -> Dict[str, int]:
        """Each owner's bytes of resident values (the PS load-balancing
        accounting), summing to :meth:`resident_bytes`."""
        out: Dict[str, int] = {}
        for name, plan in self.plans.items():
            for dest, shard in zip(plan.destinations, self._values[name]):
                out[dest] = out.get(dest, 0) + _nbytes(shard)
        return out

    @property
    def var_names(self):
        return sorted(self.plans)

    def max_staleness(self) -> int:
        return max((p.staleness for p in self.plans.values()), default=0)

    def any_async(self) -> bool:
        return any(not p.sync for p in self.plans.values())


# ----------------------------------------------------------------- pipeline


class PSPipeline:
    """Overlap the host-PS data path with compute (the JAX ``PSPipeline``).

    The serial path runs pull -> step -> push (D2H + apply) -> pull ...
    Here the push and the NEXT step's pull run on a background worker:

    - **exact** (staleness 0): a step's job is push -> apply -> pull, and
      the next :meth:`values` waits for it — the same calls in the same
      order as the serial path, so the values are bit-identical;
    - **stale** (``staleness`` s >= 1): the pull runs on its own lane
      and waits only for the push submitted s steps earlier, so a read
      lags the newest apply by at most s and the copies overlap the next
      step.

    ``ADT_PS_OVERLAP=0`` keeps the serial path."""

    def __init__(self, store: PSStore, stale_ok: bool):
        self._store = store
        self._stale_ok = stale_ok
        self._exec = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="adt-ps-pipe")
        self._pull_exec = (concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="adt-ps-pull")
            if stale_ok else self._exec)
        self._pending = None       # Future -> the next step's staged pull
        self._push_pending = None  # stale mode: the last push's Future
        self._window = max(1, store.max_staleness())
        self._push_hist = collections.deque(maxlen=self._window)

    def values(self):
        """``(staged values, version)`` for the step about to run: the
        prefetch when one is pending, else a fresh pull."""
        if self._pending is None:
            return self._store.pull()
        fut, self._pending = self._pending, None
        return fut.result()

    def submit(self, ps_grads: dict, ready=None) -> None:
        """Queue this step's push and the next step's pull."""
        store = self._store
        if self._stale_ok:
            barrier = (self._push_hist[0]
                       if len(self._push_hist) >= self._window else None)

            def pull_job():
                if barrier is not None:
                    barrier.result()
                return store.pull()
            self._pending = self._pull_exec.submit(pull_job)
            prev = self._push_pending

            def push_job():
                if prev is not None:
                    prev.result()        # pushes stay ordered
                store.push(ps_grads, ready)
            self._push_pending = self._exec.submit(push_job)
            self._push_hist.append(self._push_pending)
        else:
            def job():
                store.push(ps_grads, ready)
                return store.pull()
            self._pending = self._exec.submit(job)

    def flush(self) -> None:
        """Wait for the in-flight push (a checkpoint, a gather or a digest
        must see every submitted gradient applied); the staged values
        stay pending for the next :meth:`values`."""
        if self._push_pending is not None:
            self._push_pending.result()
        if self._pending is not None and not self._stale_ok:
            self._pending.result()

    def invalidate(self) -> None:
        """Flush, then drop the staged prefetch: the store's contents were
        replaced (a restore, a re-init)."""
        self.flush()
        if self._pending is not None:
            self._pending.result()
        self._pending = None

    def close(self) -> None:
        self.flush()
        self._exec.shutdown(wait=True)
        if self._pull_exec is not self._exec:
            self._pull_exec.shutdown(wait=True)
