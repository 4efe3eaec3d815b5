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
reference's "every worker transforms its own graph").

Async PS (``sync=False``) puts the store in **serving** mode
(:meth:`PSStore.enable_serving`, over ``runtime/ps_service.py``):
``reduction_destination`` names each shard's owner host; this process
applies the gradient blobs of the shards it owns on an apply thread, one
blob at a time, and publishes their values after each apply (their
optimizer state on a side channel that only checkpoints read), and a
pull fetches the latest published values of the shards other hosts own.
A pull that cannot reach an owner serves its last fetch for a bounded
number of pulls (the degraded-serve window), then fails loudly.

An apply computes the new values outside the store's lock and swaps them
in under it (the JAX store's compute-then-swap), so a pull never waits
for an apply: the stored value tensors are never written in place, only
replaced. The optimizer state advances in place on the applying thread,
which is the only one that reads it while applies run (a checkpoint
flushes or drains first).

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
import functools
import hashlib
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from autodist_tpu_torch import const
from autodist_tpu_torch.convert import (from_flax, from_jax_layout,
                                        to_flax, to_jax_layout)
from autodist_tpu_torch.parallel import collectives
from autodist_tpu_torch.runtime import elastic
from autodist_tpu_torch.runtime import ps_service as pss
from autodist_tpu_torch.telemetry import spans as tel
from autodist_tpu_torch.utils import logging

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
    arithmetic, optax's float32, on CPU tensors), and the step only ever
    sees pulled copies. Each shard keeps its own little optimizer state
    (the optimizer's state of ``{"v": shard}``: Adam's ``{"count", "mu":
    {"v"}, "nu": {"v"}}``, the JAX store's per-shard
    ``optimizer.init({"v": shard})``), so a clip's norm is the shard's,
    as in the JAX store. The apply fans the shards out over a
    deterministic round-robin thread pool (``ADT_PS_APPLY_THREADS``):
    each shard's arithmetic is the same in any grouping, so the result is
    bit-exact against one thread. New values are computed outside the
    lock and swapped in under it, so a pull reads one version of every
    variable without waiting for an apply.

    ``stats`` counts the wire: pulls and pushes and their bytes, as the
    JAX store counts them (in serving mode, the blobs that crossed the
    service). ``version`` is the number of applies to this store's
    shards; a pull is tagged with the version it read (:meth:`pull`)."""

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
                      "bytes_pulled": 0, "bytes_pushed": 0,
                      "degraded_pulls": 0, "dropped_pushes": 0}
        self.version = 0
        self._lock = threading.Lock()
        n = const.ENV.ADT_PS_APPLY_THREADS.val
        if n <= 0:
            n = min(4, os.cpu_count() or 1)
        self._apply_threads = n
        self._apply_pool = None  # built at the first parallel apply
        # async serving (enable_serving): (service_for_host, my_host), and
        # the owner groups once values exist
        self._serve_config = None
        self._serve_groups: Optional[Dict[str, dict]] = None
        self._my_pushes = 0
        self._warned_sync_fallback = False
        # the effective-LR scale every update is multiplied by (the health
        # sentinel's escalation ladder, runtime/sentinel.py); 1.0 leaves
        # the updates as they are
        self.update_scale = 1.0

    # ------------------------------------------------------------ lifecycle

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        """A float32 CPU copy of ``t`` that this store owns (pinned when
        the device is a card)."""
        out = torch.as_tensor(t).detach().to("cpu", torch.float32,
                                             copy=True).contiguous()
        return out.pin_memory() if self._wire.cuda else out

    def _host_empty(self, shape) -> torch.Tensor:
        """An uninitialized float32 host buffer (pinned when the device is
        a card): the target of an apply's new values."""
        return torch.empty(shape, dtype=torch.float32,
                           pin_memory=self._wire.cuda)

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
        mapping, with fresh optimizer state; in serving mode, (re)start
        the owner loops, which publish these values."""
        with self._lock:
            for name, plan in self.plans.items():
                self._values[name] = [
                    self._host(s) for s in self._split(
                        plan, torch.as_tensor(full_params[name]))]
                self._opt[name] = [self._optimizer.init({"v": s})
                                   for s in self._values[name]]
        if self._serve_config is not None:
            self._start_serving()

    def load_opt_from_full(self, opt_state) -> None:
        """Each shard's optimizer state from a full-layout optimizer state
        (the count, and each slot's ``{name: t}``: a checkpoint's): the
        slots sliced by shard range, the count copied whole. In serving
        mode the owner loops are paused across the swap and republish."""
        workers = self._owner_workers()
        for w in workers:
            w.pause()
        try:
            with self._lock:
                for name, plan in self.plans.items():
                    full = {"count": opt_state["count"]} \
                        if self._optimizer.has_count else {}
                    for slot in self._optimizer.slots:
                        full[slot] = {"v": opt_state[slot][name]}
                    self._opt[name] = self._split_little(plan, full)
            for w in workers:
                w.publish_now()
        finally:
            for w in workers:
                w.resume()

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

    def _snapshot(self) -> Tuple[Dict[str, list], int]:
        """Every variable's shard list and the version they are, read
        under the lock (the tensors are replaced, never written, so the
        snapshot stays one version)."""
        with self._lock:
            return ({n: list(s) for n, s in self._values.items()},
                    self.version)

    def _local_full(self) -> Dict[str, torch.Tensor]:
        shards, _ = self._snapshot()
        return {name: self._join(plan, shards[name])
                for name, plan in self.plans.items()}

    def pull(self, wire: bool = True) -> Tuple[dict, int]:
        """The current full values on the device (the workers' per-step
        PS read) and the version they are. ``wire=True`` ships each
        int8-wire variable as its ``{"q", "s"}`` container, quantized here
        with the codec's numpy mirror and dequantized on the device;
        ``wire=False`` (the fused carry's pull) ships exact float32, and
        the fused microsteps apply the codec themselves.

        In serving (async) mode the shards other hosts own are fetched
        from the service, the latest published version, with no barrier
        (the reference's async read from the PS); the version is then the
        versions read, summed over the owner groups."""
        with tel.span("ps.pull", "ps", serving=self.serving,
                      step=self.stats["pulls"]):
            out = self._pull_impl(wire)
        tel.counter_add("ps.pulls")
        return out

    def _pull_impl(self, wire: bool):
        nbytes = 0
        if self._serve_groups is None:
            shards, version = self._snapshot()
            host = {name: self._join(plan, shards[name])
                    for name, plan in self.plans.items()}
            count = True
        else:
            host, version, nbytes = self._serve_pull()
            count = False   # the fetched blobs were counted
        for name in sorted(host):
            if wire and name in self._jax_names:
                # blocks in the JAX element order: the same elements
                # share a scale in both packages
                w = collectives.quant_wire_np(to_jax_layout(
                    host[name], self._jax_names[name]).contiguous()
                    .numpy())
                host[name] = {k: torch.from_numpy(v) for k, v in w.items()}
                qb = _nbytes(host[name]["q"]) + _nbytes(host[name]["s"])
                tel.counter_add("wire.bytes_quantized", qb)
                tel.counter_add("wire.bytes_saved",
                                self._var_infos[name].byte_size - qb)
                nbytes += qb if count else 0
            elif count:
                nbytes += _nbytes(host[name])
        staged = self._wire.to_device(host)
        self.stats["bytes_pulled"] += nbytes
        self.stats["pulls"] += 1
        tel.counter_add("ps.bytes_pulled", nbytes)
        return staged, version

    def _serve_pull(self):
        """Serving mode's read: ``(full values on the host, version,
        bytes fetched)``. The shards this process owns come from its own
        store; the others from each owner's latest publish, or, while the
        owner is unreachable, from the last fetch within the
        degraded-serve window."""
        shard_vals: Dict[str, Dict[int, object]] = {}
        version, nbytes = 0, 0
        for host, grp in self._serve_groups.items():
            if grp["owned"]:
                with self._lock:
                    blobs = {"%s::%d" % (n, si): self._values[n][si]
                             for n, si in grp["pairs"]}
                    version += self.version
            else:
                res, fetch_err = None, None
                try:
                    deadline = time.monotonic() + 60.0
                    res = grp["service"].fetch()
                    while res is None:  # the owner has not published yet
                        if time.monotonic() > deadline:
                            break
                        time.sleep(0.002)
                        res = grp["service"].fetch()
                except OSError as e:
                    fetch_err = e
                if fetch_err is not None:
                    blobs = self._serve_stale(host, grp, fetch_err)
                    if blobs is None:
                        raise RuntimeError(
                            "async PS: owner %s unreachable and the "
                            "degraded-serve window is exhausted — "
                            "aborting instead of training on "
                            "unboundedly stale values (%s)"
                            % (host, fetch_err)) from fetch_err
                    version += grp.get("last_version", 0)
                elif res is None:
                    # reachable, but the owner never published: not a
                    # transport error, and no stale serving (it would hide
                    # a wedged owner behind frozen parameters)
                    raise TimeoutError(
                        "async PS: owner %s never published" % host)
                else:
                    ver, blob = res
                    blobs = {k: torch.from_numpy(v) for k, v in
                             pss.unpack_arrays(blob).items()}
                    nbytes += len(blob)
                    # the last good fetch: the degraded-serve fallback
                    grp["last_fetch"] = blobs
                    grp["last_version"] = ver
                    grp["degraded"] = 0
                    version += ver
            for key, arr in blobs.items():
                if "!" in key:
                    continue  # an optimizer-state leaf (checkpoint wire)
                name, si = key.rsplit("::", 1)
                shard_vals.setdefault(name, {})[int(si)] = arr
        return self._assemble(shard_vals), version, nbytes

    def _degraded_bound(self) -> int:
        """How many consecutive pulls may serve the last fetch while an
        owner is unreachable: the strategy's staleness bound when one is
        declared, else the async pacing lag (``ADT_PS_MAX_LAG``)."""
        return max(self.max_staleness(), const.ENV.ADT_PS_MAX_LAG.val)

    def _serve_stale(self, host: str, grp: dict, err: OSError):
        """Serve the last fetched values for up to :meth:`_degraded_bound`
        consecutive pulls; None when the window is used up (the caller
        fails loudly). No reconnect here: the resilient client reconnects
        on its own schedule and keeps its breaker state."""
        bound = self._degraded_bound()
        cached = grp.get("last_fetch")
        used = grp.get("degraded", 0)
        if cached is None or used >= bound:
            return None
        grp["degraded"] = used + 1
        self.stats["degraded_pulls"] += 1
        tel.counter_add("ps.degraded_pulls")
        tel.instant("ps.degraded_pull", "ps", host=host, used=used + 1,
                    bound=bound)
        logging.warning(
            "async PS: owner %s unreachable (%s); serving last-fetched "
            "values (degraded pull %d/%d)", host, err, used + 1, bound)
        return cached

    def _assemble(self, shard_vals: Dict[str, Dict[int, object]]
                  ) -> Dict[str, torch.Tensor]:
        """Full variables from their shards (possibly published by
        different owners), in plan shard order; a shard nobody published
        yet comes from the local mirror."""
        out = {}
        for name, plan in self.plans.items():
            pieces = []
            for si in range(len(plan.shard_ranges())):
                arr = shard_vals.get(name, {}).get(si)
                if arr is None:
                    with self._lock:
                        arr = self._values[name][si]
                pieces.append(torch.as_tensor(arr))
            out[name] = self._join(plan, pieces)
        return out

    def push(self, grads: dict, ready=None, ok=None) -> None:
        """Hand the mean-reduced gradients to the PS: to the host (after
        the ``ready`` event), then :meth:`apply_local`; every rank replays
        the same deterministic update on its mirror. In serving (async)
        mode each owner group's gradients are packed into a blob and
        queued on the owner's queue instead; the owner's apply thread
        applies them, one blob at a time, with no barrier. ``ok``, the
        health sentinel's verdict of the step that made the gradients (a
        device scalar), crosses in the same copy; a bad one suppresses
        the push: the store never sees the poisoned gradient and its
        optimizer state stays as it was."""
        # the epoch fence, before any copy: a fenced process's push never
        # reaches a queue its successor drains
        elastic.maybe_fence("ps.push")
        if ok is not None:
            moved = self._wire.to_host({"g": grads, "ok": ok}, ready)
            if not bool(moved["ok"]):
                tel.counter_add("sentinel.ps_suppressed")
                logging.warning("sentinel: PS push suppressed (bad verdict)")
                return
            grads, ready = moved["g"], None
        with tel.span("ps.push", "ps", serving=self.serving,
                      step=self.stats["pushes"]):
            host = self._wire.to_host(grads, ready)
            nbytes = 0
            host_grads = {}
            for name in sorted(host):
                host_grads[name], b = self._grad_to_host(name, host[name])
                nbytes += b
            drops0 = self.stats["dropped_pushes"]
            if self._serve_groups is None:
                if self.any_async() and not self._warned_sync_fallback:
                    self._warned_sync_fallback = True
                    logging.warning(
                        "async PS (sync=False) requested but serving is not "
                        "wired (no AutoDist async build); applying "
                        "synchronously")
                self.apply_local(host_grads)
            else:
                nbytes = self._serve_push(host_grads)
            self.stats["bytes_pushed"] += nbytes
            self.stats["pushes"] += 1
        tel.counter_add("ps.pushes")
        tel.counter_add("ps.bytes_pushed", nbytes)
        dropped = self.stats["dropped_pushes"] - drops0
        if dropped:
            tel.counter_add("ps.dropped_pushes", dropped)

    def _serve_push(self, host_grads: dict) -> int:
        """Serving mode's push: one blob an owner group (its shards'
        slices; a sparse pair whole, which the owner applies to its own
        shard ranges), behind the ``ADT_PS_MAX_LAG`` backpressure; returns
        the bytes queued."""
        nbytes = 0
        for host, grp in self._serve_groups.items():
            payload = {}
            for name, si in grp["pairs"]:
                if name not in host_grads:
                    continue
                g = host_grads[name]
                plan = self.plans[name]
                if isinstance(g, tuple):
                    payload[name + "#idx"] = g[0]
                    payload[name + "#vals"] = g[1]
                elif plan.partitioned:
                    payload["%s::%d" % (name, si)] = self._split(plan, g)[si]
                else:
                    payload["%s::0" % name] = g
            if not payload:
                continue
            blob = pss.pack_arrays(payload)
            # backpressure before the push: at most ADT_PS_MAX_LAG blobs in
            # flight a queue (0 = unbounded); a queue stuck past a minute
            # drops this push (counted) — the chief's heartbeat watchdog
            # (runtime/coordinator.py, under ADT_ELASTIC) is what ends a
            # job whose owner is really gone
            max_lag = const.ENV.ADT_PS_MAX_LAG.val
            try:
                if max_lag > 0:
                    deadline = time.monotonic() + 60.0
                    stuck = False
                    while grp["service"].pending_grads() >= max_lag:
                        if time.monotonic() > deadline:
                            logging.warning(
                                "async PS: owner %s queue stuck at max "
                                "lag; dropping this push", host)
                            stuck = True
                            break
                        time.sleep(0.001)
                    if stuck:
                        self.stats["dropped_pushes"] += 1
                        continue
                grp["service"].push_grads(blob)
            except OSError as e:
                # a dropped async gradient is legal within the degraded
                # window; past it the owner is gone and the job fails
                used = grp.get("push_failures", 0) + 1
                bound = self._degraded_bound()
                if used > bound:
                    raise RuntimeError(
                        "async PS: pushes to owner %s failed %d "
                        "consecutive times — aborting instead of "
                        "silently training without gradient exchange "
                        "(%s)" % (host, used, e)) from e
                grp["push_failures"] = used
                self.stats["dropped_pushes"] += 1
                logging.warning(
                    "async PS: push to owner %s failed (%s); dropped "
                    "this gradient (consecutive failure %d/%d)",
                    host, e, used, bound)
                continue
            grp["push_failures"] = 0
            nbytes += len(blob)
        self._my_pushes += 1
        return nbytes

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

    def apply_local(self, grads: Dict[str, object],
                    shard_filter=None) -> None:
        """The PS-side update op: each gradient split by shard range and
        applied through the optimizer to the resident shards on the host
        CPU. Gradients arrive as full dense tensors (mirror mode), as
        pre-sliced ``name::si`` shard slices (a serving push), or as
        sparse (ids, values) pairs, also in their packed
        ``name#idx``/``name#vals`` form, densified. ``shard_filter``
        restricts the apply to the given (name, si) set: an owner loop
        touches only the shards it owns. The new values are computed
        outside the lock and swapped in under it."""
        items, slices = {}, {}
        for name, g in grads.items():
            if name.endswith("#idx"):
                base = name[:-4]
                items[base] = (g, grads[base + "#vals"])
            elif name.endswith("#vals"):
                continue
            elif ("::" in name and name not in self.plans
                  and name.rsplit("::", 1)[0] in self.plans
                  and name.rsplit("::", 1)[1].isdigit()):
                # a wire shard-slice key; a variable literally named "w::1"
                # is in self.plans and takes the dense branch
                base, si = name.rsplit("::", 1)
                slices.setdefault(base, {})[int(si)] = g
            else:
                items[name] = g
        work = {}

        def add(name, si, gs):
            if shard_filter is None or (name, si) in shard_filter:
                work["%s::%d" % (name, si)] = (
                    name, si, torch.as_tensor(gs).contiguous())
        for name, g in items.items():
            plan = self.plans[name]
            g = self._densify(name, g) if isinstance(g, tuple) \
                else torch.as_tensor(g)
            for si, gs in enumerate(self._split(plan, g)):
                add(name, si, gs)
        for name, by_si in slices.items():
            for si, gs in sorted(by_si.items()):
                add(name, si, gs)
        if not work:
            return
        with tel.span("ps.apply", "ps", shards=len(work)):
            fresh = self._apply_sharded(work)
        with self._lock:
            for key, (name, si, _) in work.items():
                shards = list(self._values[name])
                shards[si] = fresh[key]
                self._values[name] = shards
            self.version += 1
        tel.counter_add("ps.applies", len(work))
        self.stats["applies"] += len({n for n, _, _ in work.values()})

    def _apply_sharded(self, work) -> Dict[str, torch.Tensor]:
        """The per-shard updates, round-robin over sorted keys: one group
        on the calling thread when the pool is off or there is one shard,
        else a group a pool thread. Each shard's optimizer state advances
        in place; its new value lands in a fresh buffer (returned by key),
        the same float32 additions as an in-place update."""
        keys = sorted(work)
        fresh = {}

        def run(group):
            for key in group:
                name, si, g = work[key]
                v = self._values[name][si]
                upd = self._optimizer.delta({"v": g}, self._opt[name][si],
                                            {"v": v})["v"]
                if self.update_scale != 1.0:
                    # the sentinel's LR scale, as the JAX store's apply
                    # multiplies its updates (x 1.0 changes nothing)
                    upd = upd * torch.tensor(self.update_scale,
                                             dtype=upd.dtype)
                fresh[key] = torch.add(v, upd, out=self._host_empty(v.shape))
        n = min(self._apply_threads, len(keys))
        if n <= 1:
            run(keys)
            return fresh
        if self._apply_pool is None:
            self._apply_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=self._apply_threads,
                thread_name_prefix="adt-ps-apply")
        for f in [self._apply_pool.submit(run, keys[i::n])
                  for i in range(n)]:
            f.result()
        return fresh

    # ---------------------------------------------------- async PS serving

    def enable_serving(self, service_for_host, my_host: str) -> None:
        """Switch to serving (async) mode: the shards are grouped by owner
        host (``reduction_destination``); this process runs an apply loop
        for the group it owns and fetches the others over the service
        (the reference's sharded-PS deployment, one PS task a
        destination, ``ps_synchronizer.py:636-762``). May be called
        before :meth:`init_params`: the owner loops start once values
        exist."""
        self._serve_config = (service_for_host, my_host)
        if self._values:
            self._start_serving()

    def _start_serving(self) -> None:
        """Group by owner host a shard: a partitioned variable's shards
        can be owned (stored, applied, published) by different hosts, and
        a pull reassembles the variable across its owners' blobs."""
        service_for_host, my_host = self._serve_config
        if self._serve_groups is not None:  # re-init: restart the loops
            self.close()
        groups: Dict[str, list] = {}
        for name, plan in sorted(self.plans.items()):
            for si, dest in enumerate(plan.destinations):
                host = dest.split(":")[0] if dest else my_host
                groups.setdefault(host, []).append((name, si))
        self._serve_groups = {}
        for host, pairs in sorted(groups.items()):
            svc = service_for_host(host)
            owned = host == my_host
            grp = {"pairs": sorted(pairs), "service": svc, "owned": owned,
                   "worker": None}
            if owned:
                # values on the hot channel (every worker's per-step
                # pull); the optimizer state on the side channel, read
                # only by checkpoints
                grp["worker"] = pss.AsyncPSWorker(
                    svc,
                    functools.partial(self.apply_local,
                                      shard_filter=frozenset(grp["pairs"])),
                    functools.partial(self._local_shard_blobs, grp["pairs"]),
                    opt_fn=functools.partial(self._local_opt_blobs,
                                             grp["pairs"])).start()
            self._serve_groups[host] = grp
        logging.info("async PS serving: %d owner groups, this process (%s) "
                     "owns %s", len(self._serve_groups), my_host,
                     [h for h, g in self._serve_groups.items() if g["owned"]])

    def _local_shard_blobs(self, pairs) -> Dict[str, torch.Tensor]:
        """``{'name::si': shard value}`` for the given (name, si) pairs:
        the owner's publish payload."""
        with self._lock:
            return {"%s::%d" % (name, si): self._values[name][si]
                    for name, si in pairs}

    def _opt_leaves(self, state: dict) -> Dict[str, torch.Tensor]:
        """A little optimizer state's leaves by the JAX package's
        flattened names (``0/count``, ``0/mu/v``; ``OptimizerSpec.
        jax_prefix``)."""
        prefix = self._optimizer.jax_prefix
        out = {}
        if "count" in state:
            out[prefix + "count"] = state["count"]
        for slot in self._optimizer.slots:
            out["%s%s/v" % (prefix, slot)] = state[slot]["v"]
        return out

    def _local_opt_blobs(self, pairs) -> Dict[str, torch.Tensor]:
        """``{'name::si!leaf': optimizer leaf}`` for the owned pairs: the
        side channel a checkpoint on another host reads to hold the
        owner's moments for shards it does not own."""
        out = {}
        with self._lock:
            for name, si in pairs:
                for leaf, t in self._opt_leaves(self._opt[name][si]).items():
                    out["%s::%d!%s" % (name, si, leaf)] = t
        return out

    def _owner_workers(self) -> list:
        if self._serve_groups is None:
            return []
        return [g["worker"] for g in self._serve_groups.values()
                if g["worker"] is not None]

    @property
    def serving(self) -> bool:
        return self._serve_groups is not None

    def owner_health_errors(self) -> List[Tuple[str, str]]:
        """(host, error) for every owner apply loop of this process that
        is dead or past its reconnect budget: the gradients pushed to
        those groups are never applied again, so the Runner fails the job
        loudly."""
        out: List[Tuple[str, str]] = []
        if self._serve_groups is None:
            return out
        for host, grp in self._serve_groups.items():
            w = grp["worker"]
            if w is not None and not w.healthy:
                out.append((host, str(w.last_error or
                                      "apply thread died unexpectedly")))
        return out

    def applied_total(self) -> int:
        """Gradient blobs applied by this process's owner loops (the
        applies, outside serving mode)."""
        if self._serve_groups is None:
            return self.stats["applies"]
        return sum(w.applied for w in self._owner_workers())

    def drain(self, timeout: float = 30.0) -> None:
        """Wait for this process's owner queues to empty (checkpoints,
        paced tests)."""
        for w in self._owner_workers():
            w.drain(timeout)

    def close(self) -> None:
        # the owner loops stop before the apply pool: a loop mid-apply
        # would otherwise build a fresh pool after its shutdown
        if self._serve_groups is not None:
            for grp in self._serve_groups.values():
                stopped = True
                if grp["worker"] is not None:
                    stopped = grp["worker"].stop()
                if stopped:
                    grp["service"].close()
                else:
                    # a wedged apply thread keeps its socket: closing it
                    # under a live thread mid-publish is worse than a leak
                    logging.warning("PS owner apply thread did not stop; "
                                    "leaving its service open")
        if self._apply_pool is not None:
            self._apply_pool.shutdown(wait=True)
            self._apply_pool = None

    # ---------------------------------------------------------- checkpoints

    # ------------------------------------------------ sharded checkpoints

    def checkpoint_pairs(self, is_chief: bool) -> List[Tuple[str, int]]:
        """(var, shard) pairs THIS process writes in a sharded checkpoint
        (the JAX ``checkpoint_pairs``). Serving (async) mode: the shards
        this process owns — its state is the authoritative copy of
        exactly those. Mirror (sync) mode: every process holds the same
        state, so the chief writes all of them and everyone else none."""
        if self._serve_groups is not None:
            out: List[Tuple[str, int]] = []
            for grp in self._serve_groups.values():
                if grp["owned"]:
                    out.extend(grp["pairs"])
            return sorted(out)
        if not is_chief:
            return []
        out = []
        for name, plan in sorted(self.plans.items()):
            n = len(plan.shard_ranges()) if plan.partitioned else 1
            out.extend((name, si) for si in range(n))
        return out

    def _to_jax(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """A shard-shaped tensor of ``name`` in the JAX layout: a
        partitioned variable's shards already are; an unpartitioned one's
        single shard is the port's full tensor (``convert.to_flax``)."""
        if self.plans[name].partitioned or t.dim() == 0:
            return t
        info = self._var_infos[name]
        return to_flax(t, info.collective_name, _flax_shape(info))

    def _from_jax(self, name: str, t: torch.Tensor) -> torch.Tensor:
        if self.plans[name].partitioned or t.dim() == 0:
            return t
        info = self._var_infos[name]
        return from_flax(t, info.shape, info.collective_name)

    def shard_state(self, name: str, si: int
                    ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """(value, optimizer-state leaves by the JAX flattened names:
        ``0/count``, ``0/mu/v``) of one shard, in the JAX layout — an
        atomic snapshot against a concurrent apply (copies taken under
        the store's lock)."""
        with self._lock:
            value = self._to_jax(name, self._values[name][si])
            leaves = self._opt_leaves(self._opt[name][si])
            opt_flat = {k: np.array(self._to_jax(name, t).numpy())
                        for k, t in leaves.items()}
            value = np.array(value.numpy())
        return value, opt_flat

    def load_shard_states(self, provider) -> None:
        """Reload every shard from ``provider(name, si) -> (value,
        opt_flat)`` (the sharded-checkpoint restore; the JAX
        ``load_shard_states``). Every shard loads in every process (the
        owned ones authoritative; the rest seed the mirror a pull falls
        back to before the owners publish). An optimizer leaf the
        checkpoint lacks keeps the fresh init, with a warning. In serving
        mode the owner loops pause across the swap and republish after
        it; a serving store with no values yet (an auto-resume restores
        before any init) starts serving now."""
        workers = self._owner_workers()
        for w in workers:
            w.pause()
        prefix = self._optimizer.jax_prefix
        try:
            for name, plan in sorted(self.plans.items()):
                n = len(plan.shard_ranges()) if plan.partitioned else 1
                new_vals, new_opts = [], []
                for si in range(n):
                    value, opt_flat = provider(name, si)
                    value = self._host(self._from_jax(name, torch.from_numpy(
                        np.array(value, np.float32))))
                    fresh = self._optimizer.init({"v": value})
                    state = {}
                    for key, tmpl in self._opt_leaves(fresh).items():
                        src = opt_flat.get(key)
                        if src is None:
                            logging.warning(
                                "PS sharded restore: opt leaf %r for %s[%d] "
                                "not in checkpoint; keeping fresh init",
                                key, name, si)
                            src = tmpl
                        t = torch.as_tensor(np.array(src)).to(tmpl.dtype)
                        if key in opt_flat:
                            t = self._from_jax(name, t)
                        leaf = key[len(prefix):]
                        if leaf == "count":
                            state["count"] = t.clone()
                        else:
                            state[leaf[:-2]] = {"v": self._host(t)}
                    new_vals.append(value)
                    new_opts.append(state)
                with self._lock:
                    self._values[name] = new_vals
                    self._opt[name] = new_opts
                    self.version += 1
            for w in workers:
                w.publish_now()
        finally:
            for w in workers:
                w.resume()
        if self._serve_config is not None and self._serve_groups is None:
            self._start_serving()

    def full_values(self) -> Dict[str, torch.Tensor]:
        """Every variable's full value on the host (copies), for
        checkpoints and gathers; not counted as wire. In serving mode the
        shards other hosts own come from their owner's latest publish
        (the authoritative copy; the local mirror before it)."""
        if self._serve_groups is None:
            return {n: t.clone() for n, t in self._local_full().items()}
        shard_vals: Dict[str, Dict[int, object]] = {}
        for grp in self._serve_groups.values():
            if grp["owned"]:
                blobs = self._local_shard_blobs(grp["pairs"])
            else:
                res = grp["service"].fetch()
                if res is None:
                    continue  # pre-publish: the mirror
                blobs = {k: torch.from_numpy(v) for k, v in
                         pss.unpack_arrays(res[1]).items()}
            for key, arr in blobs.items():
                name, si = key.rsplit("::", 1)
                shard_vals.setdefault(name, {})[int(si)] = arr
        return {n: t.clone() for n, t in self._assemble(shard_vals).items()}

    def _shard_states(self, var_name: str) -> List[dict]:
        """The variable's per-shard optimizer states: the local ones, and
        in serving mode the owner's (:meth:`_remote_opt_state`) for the
        shards other hosts own."""
        with self._lock:
            states = list(self._opt[var_name])
        if self._serve_groups is not None:
            states = [self._remote_opt_state(var_name, si, st)
                      for si, st in enumerate(states)]
        return states

    def full_opt_leaf(self, slot: str, var_name: str) -> torch.Tensor:
        """One variable's slot (``mu``, ``nu``, ``trace``) in its full
        layout: the shards' slots concatenated along the plan axis."""
        plan = self.plans[var_name]
        parts = [st[slot]["v"] for st in self._shard_states(var_name)]
        return (parts[0].clone() if len(parts) == 1
                else self._join(plan, parts))

    def _remote_opt_state(self, var_name: str, si: int, local_state: dict):
        """The authoritative little optimizer state of one shard: the
        local one when this process owns the shard, else rebuilt from the
        owner's latest ``name::si!leaf`` publish (the local state before
        the owner's first publish)."""
        for grp in self._serve_groups.values():
            if (var_name, si) not in grp["pairs"]:
                continue
            if grp["owned"]:
                return local_state
            res = grp["service"].fetch_opt()
            if res is None:
                return local_state  # the owner has not published
            want = "%s::%d!" % (var_name, si)
            remote = {k[len(want):]: torch.from_numpy(v) for k, v in
                      pss.unpack_arrays(res[1]).items()
                      if k.startswith(want)}
            if not remote:
                return local_state
            leaves = self._opt_leaves(local_state)
            prefix = self._optimizer.jax_prefix
            out = {}
            if "count" in local_state:
                out["count"] = remote.get(prefix + "count",
                                          leaves[prefix + "count"])
            for slot in self._optimizer.slots:
                key = "%s%s/v" % (prefix, slot)
                out[slot] = {"v": remote.get(key, leaves[key])}
            return out
        return local_state

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
        ``ADT_PS_MIRROR_CHECK_EVERY`` checks across the ranks. Mirror
        (sync) mode only: a serving store has one authoritative owner
        copy a shard."""
        if self.serving:  # not an assert: must hold under python -O too
            raise RuntimeError("mirror_digest is for sync (mirror) mode")
        h = hashlib.md5()
        shards, _ = self._snapshot()
        for name in sorted(shards):
            h.update(name.encode())
            for s in shards[name]:
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
    - **stale** (``staleness`` s >= 1, or async serving): the pull runs
      on its own lane and waits only for the push submitted s (async: 1)
      steps earlier, so a read lags the newest apply by at most s and
      the copies overlap the next step. Under async the push job queues
      the blobs on the owners' queues, and a pull serves whatever the
      owners published last.

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

    def submit(self, ps_grads: dict, ready=None, ok=None) -> None:
        """Queue this step's push and the next step's pull. ``ok`` is the
        sentinel's verdict, read with the push's copy on the worker
        (:meth:`PSStore.push`)."""
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
                store.push(ps_grads, ready, ok=ok)
            self._push_pending = self._exec.submit(push_job)
            self._push_hist.append(self._push_pending)
        else:
            def job():
                store.push(ps_grads, ready, ok=ok)
                return store.pull()
            self._pending = self._exec.submit(job)

    def flush(self) -> None:
        """Wait for the in-flight push (a checkpoint, a gather or a digest
        must see every submitted gradient applied; under async, queued on
        its owner's queue, which ``PSStore.drain`` then empties); the
        staged values stay pending for the next :meth:`values`."""
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
