"""DecodeEngine — continuous-batching autoregressive decode over a built
Runner (PyTorch counterpart of ``autodist_tpu/serving/decode.py``).

The engine runs ONE fixed-shape decode-step program
(``DistributedStep.decode_program``): params + slot-major KV caches
``[slots, layers, max_len, heads, head_dim]`` + per-slot token/cursor/
alive → next-token per slot, with the caches updated in place. Slot
occupancy is pure host bookkeeping: a finished sequence flips its
``alive`` bit and the next admission overwrites its rows; the masked
attention (``ops.attention.cached_attention`` or the flash kernel) never
reads a dead slot's garbage.

**Continuous batching** (the :class:`SlotScheduler`): between steps,
queued prompts are admitted into freed slots — prefill runs through the
bucketed forward path (:class:`InferenceEngine`) and the resulting caches
are copied into the freed slots' rows with an in-place ``index_copy_``
(the JAX engine scatters them with a donated jitted insert; the port keeps
the prefilled caches on the device, where the JAX engine round-trips them
through the host). ``admission="static"`` degrades the scheduler to the
classic static batch — admit only when EVERY slot is free.

Shutdown is drain-aware: :meth:`drain` stops admitting, sheds the queue
typed with a Retry-After computed from the measured completion rate, and
lets in-flight sequences run to completion.

At N > 1 ranks the slot dim shards over the B batch replicas (the batch
axes' size: B = N under a data-parallel plan): the ranks at batch index b
hold the caches of slots ``[b*S/B, (b+1)*S/B)`` and no other, the ranks
of one model, pipe, seq or expert line the same slots. The chief (rank
0) owns the queue and the :class:`SlotScheduler`, and drives every rank
through the engine's serving plane (``serving/plane.py``): an admission
header carries the prompts in batch-index blocks, each block holding the
prompts bound to its own slots, so each rank prefills and inserts only
its own rows and the caches never cross ranks; a step header carries the
per-slot token/cursor/alive arrays; every rank runs its slots (with the
plan's axes bound) and the next tokens come back whole over the batch
axes' group. A follower's loop runs the headers from the
engine's construction until the chief's drain or close.

Telemetry: ``serve.token_ms`` histogram (per-step wall time — the
per-token latency each live slot observed), ``serve.tokens`` /
``serve.prefill_admits`` / ``serve.evictions`` counters, and the
``serve.slot_occupancy`` / ``serve.tokens_per_s`` gauges.
"""
import collections
import dataclasses
import threading
import time
import weakref
from concurrent.futures import Future
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from autodist_tpu_torch import const
from autodist_tpu_torch.remapper import CACHE_KEYS
from autodist_tpu_torch.serving.engine import (InferenceEngine, ServingConfig,
                                               ServingUnavailable)
from autodist_tpu_torch.serving.plane import ServingPlane
from autodist_tpu_torch.telemetry import spans as tel
from autodist_tpu_torch.utils import logging

# every live decode engine, so a process can drain its decode tier (and
# ``autodist_tpu_torch.reset()`` can close it) without threading references
_ACTIVE: "weakref.WeakSet" = weakref.WeakSet()

# Retry-After clamp band, shared with the micro-batcher's
_RETRY_MIN_S = 0.05
_RETRY_MAX_S = 60.0
_RATE_ALPHA = 0.3


def active_decoders() -> list:
    """The process's live decode engines."""
    return list(_ACTIVE)


@dataclasses.dataclass
class DecodeSetup:
    """The model-side decode contract (``models/lm.make_decode_setup``).

    ``prefill_fn(params, {"tokens": [B, P], "length": [B]})`` returns
    ``{"next_token": [B] int32, "k": [B, layers, max_len, heads, dim],
    "v": ...}`` — the first generated token plus the prompt's caches.
    ``decode_fn(params, dstate)`` is the step: dstate carries ``k``/
    ``v`` slot caches plus per-slot ``token``/``cursor``/``alive`` and
    returns the caches (updated in place) + ``next_token``.
    ``init_dstate(slots, device)`` builds the zeroed state fixing every
    shape."""

    prefill_fn: Callable
    decode_fn: Callable
    init_dstate: Callable
    max_len: int
    vocab_size: int


@dataclasses.dataclass
class DecodeConfig:
    """Slot-engine knobs (docs/serving.md "Continuous batching").

    ``slots``: decode batch width — must split evenly over the mesh's
    batch axes. ``max_new_tokens``: per-request generation cap (a submit
    may lower it). ``prefill_len``: the fixed padded prompt length every
    prefill dispatch runs at (prompts longer than this are rejected
    typed). ``prefill_buckets``: padded prefill group sizes (None =
    {1, slots} rounded to replica multiples). ``eos_id``: token ending a
    sequence early (None = length-only stopping). ``admission``:
    "continuous" (admit into any freed slot between steps) or "static"
    (admit only when ALL slots are free — the baseline bench compares
    against). ``max_queue``: backpressure bound on queued prompts.
    ``snapshot_max_age_s``: the prefill engine's host-PS snapshot refresh
    period (:class:`ServingConfig`'s). ``hbm_budget_bytes``: arms the
    ADT442 cache-vs-device-memory projection lint at construction (None
    skips it)."""

    slots: int = 8
    max_new_tokens: int = 32
    prefill_len: int = 16
    prefill_buckets: Optional[Sequence[int]] = None
    eos_id: Optional[int] = None
    admission: str = "continuous"
    max_queue: int = 1024
    snapshot_max_age_s: float = 0.1
    hbm_budget_bytes: Optional[float] = None

    def __post_init__(self):
        if self.slots < 1:
            raise ValueError("slots must be >= 1")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.prefill_len < 1:
            raise ValueError("prefill_len must be >= 1")
        if self.admission not in ("continuous", "static"):
            raise ValueError("admission must be 'continuous' or 'static', "
                             "got %r" % (self.admission,))
        if self.max_queue < 1:
            raise ValueError("max_queue must be >= 1")


class _Request:
    __slots__ = ("prompt", "max_new", "future", "t0")

    def __init__(self, prompt, max_new: int):
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new = int(max_new)
        self.future = Future()
        self.t0 = time.perf_counter()


class _Slot:
    """One in-flight sequence: its request, the tokens generated so far,
    and how many more it may emit."""
    __slots__ = ("req", "generated", "remaining")

    def __init__(self, req: _Request, first_token: int):
        self.req = req
        self.generated = [int(first_token)]
        self.remaining = req.max_new - 1


class SlotScheduler:
    """Host-side slot bookkeeping + admission policy. Pure state machine
    — no device work — so admission/eviction semantics are unit-testable
    without a compiled engine.

    Lifecycle of a slot: FREE → (admit: prefill seeds cache, cursor =
    prompt_len, first token already generated) → LIVE (each step appends
    one token, cursor advances) → evicted on EOS / per-request token cap
    / cache exhaustion (cursor reaching max_len) → FREE again; the next
    admission overwrites the rows, nothing is ever zeroed."""

    def __init__(self, slots: int, admission: str = "continuous"):
        self.n_slots = int(slots)
        self.admission = admission
        self._slots: list = [None] * self.n_slots

    def free_slots(self) -> list:
        return [i for i, s in enumerate(self._slots) if s is None]

    def live_slots(self) -> list:
        return [i for i, s in enumerate(self._slots) if s is not None]

    def occupancy(self) -> float:
        return (self.n_slots - len(self.free_slots())) / self.n_slots

    def admissible(self, queued: int) -> int:
        """How many queued prompts the policy admits right now.
        Continuous: any freed slot takes work. Static: only a fully
        drained batch re-admits (the classic static-batching idle)."""
        free = len(self.free_slots())
        if self.admission == "static" and free != self.n_slots:
            return 0
        return min(free, queued)

    def occupy(self, idx: int, slot: _Slot):
        assert self._slots[idx] is None
        self._slots[idx] = slot

    def get(self, idx: int) -> Optional[_Slot]:
        return self._slots[idx]

    def evict(self, idx: int) -> _Slot:
        slot = self._slots[idx]
        self._slots[idx] = None
        return slot


class DecodeEngine:
    """Continuous-batching decode over a built (initialized) Runner.

    Composes an :class:`InferenceEngine` for the prefill leg (bucketed,
    snapshot-degradation-aware) and the decode-step / cache-insert
    programs for the token loop. One worker thread owns the loop:
    admit → step → account → evict, forever; callers interact only
    through :meth:`submit` futures."""

    def __init__(self, runner, setup: DecodeSetup,
                 config: Optional[DecodeConfig] = None):
        self._runner = runner
        self._dstep = runner.distributed_step
        self.setup = setup
        self.config = config or DecodeConfig()
        cfg = self.config
        if cfg.prefill_len > setup.max_len:
            raise ValueError(
                "prefill_len %d exceeds the model's max_len %d"
                % (cfg.prefill_len, setup.max_len))
        self.scheduler = SlotScheduler(cfg.slots, cfg.admission)
        dstep = self._dstep
        self.world, self.rank = dstep.num_replicas, dstep.rank
        # the batch replicas the slots split over, and this rank's batch
        # index (the process count and rank without a mesh)
        self._n_batch = dstep.replica_info.num_replicas
        self._b_rank = dstep.replica_info.rank
        # this rank's slots (the JAX ValueError when they do not divide)
        self._per = dstep.local_slots(cfg.slots)
        self._plane = (ServingPlane(self.rank, self.world, "decode",
                                    dstep.mesh,
                                    dstep.replica_info.batch_axes)
                       if self.world > 1 else None)

        # prefill rides the bucketed forward path
        replicas = runner.remapper.num_replicas
        buckets = cfg.prefill_buckets
        if buckets is None:
            r = max(replicas, 1)
            buckets = sorted({max(-(-b // r), 1) * r
                              for b in (1, cfg.slots)})
        example_req = {"tokens": np.zeros(cfg.prefill_len, np.int32),
                       "length": np.zeros((), np.int32)}
        self._prefill = InferenceEngine(
            runner, setup.prefill_fn, example_req,
            ServingConfig(buckets=buckets,
                          snapshot_max_age_s=cfg.snapshot_max_age_s),
            plane=self._plane, keep_local=CACHE_KEYS)

        # the ONE decode-step program (fixed shapes, caches updated in
        # place) and its device-resident state: the two cache halves of
        # this rank's slots live on the device for the engine's life; the
        # per-slot arrays (all slots) are host-managed and placed per
        # dispatch
        example_dstate = setup.init_dstate(self._per, device=runner.device)
        self._decode_prog = dstep.decode_program(
            setup.decode_fn, example_dstate, slots=cfg.slots,
            group=self._plane.group if self._plane is not None else None,
            mesh=self._plane.mesh if self._plane is not None else None)
        self._dev_k = example_dstate["k"]
        self._dev_v = example_dstate["v"]
        self._token, self._cursor, self._alive = (
            np.zeros(cfg.slots, example_dstate[k].cpu().numpy().dtype)
            for k in ("token", "cursor", "alive"))

        self._cv = threading.Condition()
        self._pending: "collections.deque" = collections.deque()
        self._closing = False
        self._retry_after: Optional[float] = None
        self._complete_rate: Optional[float] = None  # requests/s EWMA
        self._last_complete_t: Optional[float] = None
        self._token_rate: Optional[float] = None  # tokens/s EWMA
        self._token_ms: list = []
        self.stats_local = {"steps": 0, "tokens": 0, "prefill_admits": 0,
                            "evictions": 0, "completed": 0, "shed": 0,
                            "drained": 0, "errors": 0}
        self._peak_occupancy = 0.0
        self._warmed = False
        self._lint_hbm()
        if self._plane is not None and not self._plane.chief:
            # a follower's worker is the plane's loop: the chief's headers
            self._plane.on("admit", self._prefill_rows)
            self._plane.on("step", self._step_rows)
            self._plane.start_follower()
            self._worker = None
        else:
            self._worker = threading.Thread(target=self._run,
                                            name="adt-serve-decode",
                                            daemon=True)
            self._worker.start()
        _ACTIVE.add(self)

    @property
    def chief(self) -> bool:
        """Whether this rank owns the queue and the scheduler (always, at
        one replica)."""
        return self._plane is None or self._plane.chief

    # ----------------------------------------------------------- lint

    def _lint_hbm(self):
        """ADT442 at construction: does max_len x slots of KV cache (+
        the full params the decode step holds) project past the device
        memory budget? Warned now, not at the allocation that fails."""
        if self.config.hbm_budget_bytes is None:
            return
        from autodist_tpu_torch.analysis import rules
        # the global allocation: each of the N ranks holds its slots' share
        cache_bytes = (2 * self._dev_k.numel() * self._dev_k.element_size()
                       * self.world)
        param_bytes = float(self._dstep.model_item.total_bytes())
        for d in rules.verify_decode(
                cache_bytes, param_bytes=param_bytes,
                slots=self.config.slots, max_len=self.setup.max_len,
                replicas=self._runner.remapper.num_replicas,
                budget_bytes=self.config.hbm_budget_bytes):
            logging.warning("%s: %s", d.code, d.message)

    # --------------------------------------------------------- warmup

    def warmup(self):
        """Run every prefill bucket once and one decode step on the empty
        all-dead state (no cache row changes), so first-use costs — the
        kernel build, allocator growth — land here and not on the first
        request. On a follower, nothing: the chief's warmup runs there
        through the loop."""
        if not self.chief:
            return self
        self._prefill.warmup()
        with self._cv:
            with tel.span("serve.decode_warmup", "serve"):
                self._dispatch_step(warmup=True)
            # warmup's fake step must not leak into the accounting the
            # smoke legs assert on
            self.stats_local["steps"] = 0
            self.stats_local["tokens"] = 0
            self._token_ms.clear()
            self._warmed = True
        return self

    def recompiles_after_warmup(self) -> int:
        """Eager programs compile nothing per shape: always 0 (kept for the
        JAX engine's stats contract)."""
        return self._prefill.recompiles_after_warmup()

    # --------------------------------------------------------- submit

    def submit(self, prompt, max_new_tokens: Optional[int] = None) -> Future:
        """Enqueue one prompt (1-D int token ids); resolves to
        ``{"tokens": generated ids (int32, EOS included when hit),
        "prompt_len": int, "finished": "eos"|"length"}``. Sheds typed
        with :class:`ServingUnavailable` (Retry-After from the measured
        completion rate) when the queue is full or the engine is
        draining. Prompts longer than ``prefill_len`` are rejected —
        the prefill program's shape is fixed. At N > 1 only the chief
        accepts prompts."""
        if not self.chief:
            raise ValueError(
                "submit on a follower (rank %d): at N > 1 the chief (rank 0) "
                "takes the prompts and each follower's loop runs its slots"
                % self.rank)
        req = _Request(prompt, max_new_tokens or self.config.max_new_tokens)
        n = req.prompt.shape[0]
        if not 1 <= n <= self.config.prefill_len:
            raise ValueError(
                "prompt length %d outside [1, prefill_len=%d]"
                % (n, self.config.prefill_len))
        if n >= self.setup.max_len:
            raise ValueError(
                "prompt length %d leaves no cache room under max_len %d"
                % (n, self.setup.max_len))
        with self._cv:
            if self._closing:
                retry = (self._retry_after
                         if self._retry_after is not None
                         else const.ENV.ADT_DRAIN_RETRY_AFTER_S.val)
                raise ServingUnavailable(
                    "decode engine is draining (Retry-After %.1fs)" % retry,
                    retry_after_s=retry)
            depth = len(self._pending)
            if depth >= self.config.max_queue:
                retry = self._computed_retry_after(depth)
                self.stats_local["shed"] += 1
                tel.counter_add("serve.shed")
                raise ServingUnavailable(
                    "decode queue full (%d pending) — shedding "
                    "(Retry-After %.2fs)" % (depth, retry),
                    retry_after_s=retry)
            self._pending.append(req)
            tel.counter_add("serve.requests")
            self._cv.notify()
        return req.future

    def generate(self, prompt, max_new_tokens: Optional[int] = None,
                 timeout: Optional[float] = None) -> dict:
        """Blocking convenience: ``submit(...).result(timeout)``."""
        return self.submit(prompt, max_new_tokens).result(timeout=timeout)

    def _computed_retry_after(self, depth: int) -> float:
        """Retry-After from the measured completion rate (sequences/s
        EWMA): backlog over throughput, clamped to the same sane band
        the micro-batcher uses; the operator drain knob before any
        measurement exists."""
        rate = self._complete_rate
        if not rate or rate <= 0:
            base = const.ENV.ADT_DRAIN_RETRY_AFTER_S.val
        else:
            base = depth / rate
        return min(max(base, _RETRY_MIN_S), _RETRY_MAX_S)

    # ---------------------------------------------------------- worker

    def _run(self):
        try:
            self._loop()
        finally:
            # the chief's loop is over (drain or close): so are its
            # followers'
            if self._plane is not None:
                self._plane.stop()

    def _loop(self):
        while True:
            with self._cv:
                while (not self._pending and not self.scheduler.live_slots()
                       and not self._closing):
                    self._cv.wait(timeout=0.1)
                if (self._closing and not self._pending
                        and not self.scheduler.live_slots()):
                    break
                dst = self._pick_slots(
                    self.scheduler.admissible(len(self._pending)))
                group = [self._pending.popleft() for _ in dst]
            try:
                if group:
                    self._admit(group, dst)
                if self.scheduler.live_slots():
                    self._step()
            except ServingUnavailable as e:
                # typed shed (snapshot degradation exhausted): fail the
                # admitted group, keep the loop alive — in-flight slots
                # and later refresh attempts are unaffected
                for r in group:
                    if not r.future.done():
                        r.future.set_exception(e)
                self.stats_local["shed"] += len(group)
                tel.counter_add("serve.shed", len(group))
            except Exception as e:  # noqa: BLE001 — a poisoned dispatch
                # must not silently kill the loop and hang every future
                self.stats_local["errors"] += 1
                logging.warning("decode step failed: %s", e)
                for r in group:
                    if not r.future.done():
                        r.future.set_exception(e)
            occ = self.scheduler.occupancy()
            self._peak_occupancy = max(self._peak_occupancy, occ)
            tel.gauge_set("serve.slot_occupancy", occ)

    # -------------------------------------------------------- admission

    def _pick_slots(self, n: int) -> list:
        """The free slots the next ``n`` admissions go to: in order of the
        local slot index, then the batch index (index b holds slots
        ``[b*S/B, (b+1)*S/B)``), so that the batch replicas prefill about
        as many rows each, and at most the largest prefill bucket's share
        a replica (at one replica: the lowest free slots, at most a bucket
        of them)."""
        per = self._per
        cap = max(self._prefill.max_batch // self._n_batch, 1)
        taken = [0] * self._n_batch
        out = []
        for s in sorted(self.scheduler.free_slots(),
                        key=lambda s: (s % per, s // per)):
            if len(out) == n:
                break
            if taken[s // per] < cap:
                taken[s // per] += 1
                out.append(s)
        return out

    def _admit(self, group, dst):
        """Prefill a request group through the bucketed forward path and
        copy the caches into the freed slots ``dst`` (in-flight batching:
        live slots keep decoding across this boundary untouched). The
        prefill feed is laid out in batch-index blocks: block b holds the
        prompts bound to batch index b's slots, padded by repeating its
        last (the first prompt when it has none), so each rank prefills
        exactly the rows it keeps."""
        cfg, per, world = self.config, self._per, self._n_batch
        mine = [[j for j, s in enumerate(dst) if s // per == r]
                for r in range(world)]
        block = self._prefill.bucket_for(
            max(len(m) for m in mine) * world) // world
        tokens = np.zeros((block * world, cfg.prefill_len), np.int32)
        length = np.zeros(block * world, np.int32)
        slot = np.full(block * world, -1, np.int64)
        row_of = {}
        for r, js in enumerate(mine):
            for i in range(block):
                j = js[min(i, len(js) - 1)] if js else 0
                row = r * block + i
                prompt = group[j].prompt
                tokens[row, :prompt.shape[0]] = prompt
                length[row] = prompt.shape[0]
                if i < len(js):
                    slot[row] = dst[j]
                    row_of[j] = row
        payload = {"tokens": tokens, "length": length, "slot": slot,
                   "n": len(group), "refresh": self._prefill._refresh_due()}
        with tel.span("serve.prefill", "serve", n=len(group)):
            if self._plane is None:
                first_tokens = self._prefill_rows(payload)
            else:
                first_tokens = self._plane.dispatch("admit", payload,
                                                    self._prefill_rows)
        for j, r in enumerate(group):
            first = int(first_tokens[row_of[j]])
            plen = r.prompt.shape[0]
            sl = _Slot(r, first)
            # a request satisfied by its prefill alone (cap of 1, or EOS
            # first token) never occupies a slot (its rows were written
            # there; a dead slot's rows are never read)
            done = self._finished(sl, plen)
            if done:
                self._resolve(sl, plen, done)
            else:
                s = dst[j]
                self.scheduler.occupy(s, sl)
                self._token[s] = first
                self._cursor[s] = plen
                self._alive[s] = True
        self.stats_local["prefill_admits"] += len(group)
        tel.counter_add("serve.prefill_admits", len(group))
        # every prefill emits each request's first token
        self.stats_local["tokens"] += len(group)
        tel.counter_add("serve.tokens", len(group))

    def _prefill_rows(self, payload):
        """Every rank's part of an admission: its block of the prefill feed
        through the prefill program (the first tokens of the whole feed
        come back; the caches stay here), then its rows copied into its
        slots. Returns the first tokens on the host."""
        block = payload["tokens"].shape[0] // self._n_batch
        fetched = self._prefill._dispatch(
            {"tokens": payload["tokens"], "length": payload["length"]},
            payload["refresh"], payload["n"], block * self._n_batch,
            to_host=False)
        lo, base = self._b_rank * block, self._b_rank * self._per
        rows = [(i, int(s) - base) for i, s in
                enumerate(payload["slot"][lo:lo + block]) if s >= 0]
        if rows:
            self._dispatch_insert([d for _, d in rows], [i for i, _ in rows],
                                  fetched["k"], fetched["v"])
        return fetched["next_token"].cpu().numpy()

    def _dispatch_insert(self, dst, src, pk, pv):
        """Copy prefilled cache rows ``src`` of ``pk``/``pv`` into this
        rank's slots ``dst`` (local indexes) of the live caches, in
        place."""
        dev = self._dev_k.device
        dst_t = torch.as_tensor(dst, dtype=torch.long, device=dev)
        src_t = torch.as_tensor(src, dtype=torch.long, device=dev)
        with torch.inference_mode():
            self._dev_k.index_copy_(0, dst_t, pk.index_select(0, src_t))
            self._dev_v.index_copy_(0, dst_t, pv.index_select(0, src_t))

    def _finished(self, slot: _Slot, next_row: int) -> Optional[str]:
        """Eviction verdict AFTER ``slot.generated[-1]`` was produced:
        EOS, the per-request cap, or the cache running out of rows
        (``next_row`` — where another step would write — past the
        cache)."""
        if (self.config.eos_id is not None
                and slot.generated[-1] == self.config.eos_id):
            return "eos"
        if slot.remaining <= 0:
            return "length"
        if next_row >= self.setup.max_len:
            return "length"
        return None

    def _resolve(self, slot: _Slot, prompt_len: int, finished: str):
        slot.req.future.set_result({
            "tokens": np.asarray(slot.generated, np.int32),
            "prompt_len": int(prompt_len),
            "finished": finished})
        self.stats_local["evictions"] += 1
        self.stats_local["completed"] += 1
        tel.counter_add("serve.evictions")
        now = time.perf_counter()
        if self._last_complete_t is not None:
            dt = now - self._last_complete_t
            if dt > 0:
                rate = 1.0 / dt
                self._complete_rate = (
                    rate if self._complete_rate is None else
                    _RATE_ALPHA * rate
                    + (1 - _RATE_ALPHA) * self._complete_rate)
        self._last_complete_t = now

    # ------------------------------------------------------------ step

    def _dispatch_step(self, warmup: bool = False) -> np.ndarray:
        """One decode-step dispatch on the current state; returns the
        [slots] next-token vector (the step's ONLY readback — one int32
        per slot). A ``warmup`` step counts on no rank."""
        payload = {"token": self._token.copy(), "cursor": self._cursor.copy(),
                   "alive": self._alive.copy(), "warmup": warmup,
                   "refresh": self._prefill._refresh_due()}
        if self._plane is None:
            return self._step_rows(payload)
        return self._plane.dispatch("step", payload, self._step_rows)

    def _step_rows(self, payload):
        """Every rank's part of a decode step: its slots through the step
        program, the caches updated in place; the next tokens of every
        slot on the host (on the chief; None on a follower)."""
        try:
            state = self._runner.state
            if state is None:
                raise RuntimeError("DecodeEngine over an uninitialized "
                                   "Runner — call runner.init() first")
            ps_vals = self._prefill._snapshot(payload["refresh"])
            dstate = self._runner.remapper.remap_dstate(
                {"k": self._dev_k, "v": self._dev_v,
                 "token": payload["token"], "cursor": payload["cursor"],
                 "alive": payload["alive"]})
            out, error = self._decode_prog.local(state, ps_vals,
                                                 dstate), None
        except Exception as e:  # noqa: BLE001 — agreed in collect()
            out, error = None, e
        out = self._decode_prog.collect(out, error)
        self._dev_k, self._dev_v = out["k"], out["v"]
        if not self.chief:
            self.stats_local["steps"] += not payload["warmup"]
            return None
        return out["next_token"].cpu().numpy()

    def _step(self):
        live = self.scheduler.live_slots()
        t0 = time.perf_counter()
        with tel.span("serve.decode_step", "serve", live=len(live)):
            next_tok = self._dispatch_step()
        step_ms = (time.perf_counter() - t0) * 1e3
        # the step's wall time IS each live slot's per-token latency
        tel.hist_observe("serve.token_ms", step_ms)
        self._token_ms.append(step_ms)
        if len(self._token_ms) > 10000:
            del self._token_ms[:5000]
        self.stats_local["steps"] += 1
        self.stats_local["tokens"] += len(live)
        tel.counter_add("serve.tokens", len(live))
        inst = len(live) / max(step_ms / 1e3, 1e-9)
        self._token_rate = (inst if self._token_rate is None else
                            _RATE_ALPHA * inst
                            + (1 - _RATE_ALPHA) * self._token_rate)
        tel.gauge_set("serve.tokens_per_s", self._token_rate)
        for s in live:
            slot = self.scheduler.get(s)
            slot.generated.append(int(next_tok[s]))
            slot.remaining -= 1
            self._token[s] = next_tok[s]
            self._cursor[s] += 1
            done = self._finished(slot, int(self._cursor[s]))
            if done:
                self.scheduler.evict(s)
                self._alive[s] = False
                self._resolve(slot, slot.req.prompt.shape[0], done)

    # ----------------------------------------------------------- stats

    def queue_depth(self) -> int:
        with self._cv:
            return len(self._pending)

    def tokens_per_s(self) -> Optional[float]:
        """Smoothed decode throughput (the ``serve.tokens_per_s`` gauge
        feeding the autoscaler)."""
        return self._token_rate

    def stats(self) -> dict:
        """Decode accounting + the composed prefill engine's, plus
        per-token latency percentiles over recent steps (None before
        any step)."""
        out = {"prefill": dict(self._prefill.stats)}
        out.update(self.stats_local)
        ms = self._token_ms
        out.update(
            slots=self.config.slots,
            admission=self.config.admission,
            queue_depth=self.queue_depth(),
            slot_occupancy=self.scheduler.occupancy(),
            peak_occupancy=self._peak_occupancy,
            tokens_per_s=self._token_rate,
            recompiles_after_warmup=self.recompiles_after_warmup(),
            token_p50_ms=float(np.percentile(ms, 50)) if ms else None,
            token_p99_ms=float(np.percentile(ms, 99)) if ms else None,
        )
        return out

    # -------------------------------------------------------- shutdown

    def drain(self, retry_after_s: Optional[float] = None,
              timeout: float = 30.0) -> int:
        """Planned-departure drain: stop admitting (subsequent submits
        shed typed), shed everything still QUEUED with the Retry-After,
        and let the IN-FLIGHT sequences decode to completion — their
        futures resolve normally. Returns the shed count. Idempotent; a
        drained engine is closed. At N > 1 the chief's drain ends its
        followers' loops once the in-flight sequences are done; a
        follower's holds no queue (0)."""
        if not self.chief:
            with self._cv:
                self._closing = True
            return 0
        retry = (const.ENV.ADT_DRAIN_RETRY_AFTER_S.val
                 if retry_after_s is None else float(retry_after_s))
        with self._cv:
            if self._closing:
                return 0
            self._closing = True
            self._retry_after = retry
            shed_exc = ServingUnavailable(
                "decode engine draining for departure — retry elsewhere "
                "(Retry-After %.1fs)" % retry, retry_after_s=retry)
            shed = 0
            while self._pending:
                req = self._pending.popleft()
                if not req.future.done():
                    req.future.set_exception(shed_exc)
                    shed += 1
            in_flight = len(self.scheduler.live_slots())
            self._cv.notify()
        self._worker.join(timeout=timeout)
        self.stats_local["shed"] += shed
        self.stats_local["drained"] += in_flight
        if shed:
            tel.counter_add("serve.shed", shed)
        tel.counter_add("serve.drained", in_flight)
        tel.instant("serve.decode_drained", "serve", shed=shed,
                    drained=in_flight, retry_after_s=retry)
        logging.warning(
            "serving: drained decode engine — %d in-flight sequence(s) "
            "ran to completion, %d queued shed with Retry-After %.1fs",
            in_flight, shed, retry)
        return shed

    def close(self, timeout: float = 30.0):
        """Drain (in-flight sequences complete, queue sheds typed) and
        join the worker. Idempotent. On a follower: wait up to ``timeout``
        for the chief's drain or close to end the loop."""
        self.drain(timeout=timeout)
        if self._worker is not None:
            self._worker.join(timeout=timeout)
        else:
            self._plane.stop(timeout)

    def follow(self, timeout: Optional[float] = None) -> bool:
        """On a follower: wait until the chief's drain or close ends this
        engine's loop (True) or ``timeout`` passes (False). Elsewhere:
        True."""
        if self.chief:
            return True
        return self._plane.follow(timeout)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False
