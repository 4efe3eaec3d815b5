"""Gradient bucketing and the int8 wire codec over ``torch.distributed``.

PyTorch counterpart of ``autodist_tpu/parallel/collectives.py``:

- **buckets** (``Bucket``, :func:`make_buckets`, :func:`bucket_reduce`):
  gradients of one strategy group with one concatable compressor are
  flattened in the JAX package's element order (``convert.to_jax_layout``),
  concatenated in deterministic instance-key order (``collective_key.py``,
  keyed on the JAX names), reduced as one payload with the group's
  compressor applied to the concatenated vector, then split back — the
  same bucket, element for element, as the JAX package's;
- **the int8 wire codec**: blockwise absmax-scaled symmetric int8
  (:func:`quant_i8_block` / :func:`dequant_i8_block`, the any-shape
  container :func:`quant_wire` / :func:`dequant_wire`, and the numpy
  mirrors :func:`quant_wire_np` / :func:`dequant_wire_np`, bit-identical
  to the torch codec and to the JAX package's);
- **the two-phase quantized all-reduce** (:func:`int8_block_all_reduce`):
  one ``all_to_all`` of the int8 body and one of the f32 scales, a local
  f32 dequant-accumulate, a requantize and an ``all_gather``;
- **reduce-scatter and all-gather** of a flat vector
  (:func:`reduce_scatter_flat_launch`, :func:`all_gather_flat`) and their
  int8 forms (:func:`int8_block_reduce_scatter`,
  :func:`int8_block_all_gather`), the wire of the ZeRO-sharded update and
  of the partitioned layouts. The reduce-scatter is one
  ``all_to_all_single`` and a local sum over the ranks' chunks, one form
  on every backend and device (gloo runs ``all_to_all_single`` on CUDA
  tensors; its ``reduce_scatter_tensor`` there is not relied on). The
  reduce-scatters and the plain all-gather split into a launch that
  returns a :class:`Pending` and its completion, so the overlapped
  schedule can issue the collective asynchronously and finish it later
  with the same arithmetic;
- **the gradient-sync schedule IR** (:class:`CollectiveOp`,
  :class:`ScheduleStage`, :class:`GradSyncSchedule`,
  :func:`build_grad_sync_schedule`): the sync units ordered by reverse
  layer position, which the overlapped lowering launches from backward
  hooks (``kernel/graph_transformer.py``).

The JAX codec is plain XLA outside any Pallas kernel; its counterpart
here is plain torch ops. The collectives run on the process group they
are given, on whatever device the tensors are on: the same calls serve
NCCL and gloo (gloo runs ``all_to_all_single``, ``all_gather`` and
``all_reduce`` on CUDA tensors by staging them through the host).

The recursive halving/doubling psum (:func:`rhd_psum`), the
hierarchical one over the resource spec's hosts (:func:`hierarchical_psum`)
and the int8 ring (:func:`int8_ring_all_reduce`, n - 1 quantized hops
over ``parallel/mesh.py``'s permute, then a quantized all-gather) are
here too, with the topology pass's candidate synthesis
(:func:`synthesize_collective_candidates`, :func:`reduction_equivalent`).
The JAX module's ``wire_avals``, ``overlap_token`` and ``barrier_chain``
are tracing aids of XLA with no counterpart in an eager program.
"""
import dataclasses
import threading
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from autodist_tpu_torch import const
from autodist_tpu_torch.convert import from_jax_layout, to_jax_layout
from autodist_tpu_torch.kernel.synchronization import \
    compressor as compressor_lib
from autodist_tpu_torch.kernel.synchronization.collective_key import \
    CollectiveKey
from autodist_tpu_torch.telemetry import spans as tel

# compressors whose payload can be concatenated into one flat vector
_CONCATABLE = {"NoneCompressor", "HorovodCompressor", "HorovodCompressorEF",
               "BF16Compressor", "BF16CompressorEF",
               "Int8Compressor", "Int8CompressorEF"}


@dataclasses.dataclass
class Bucket:
    key: str
    var_names: List[str]            # deterministic order
    shapes: List[Tuple[int, ...]]
    sizes: List[int]
    dtype: str
    compressor_name: str
    spec: str = "AUTO"              # AUTO | ICI | DCN communication hint
    schedule: str = "auto"          # auto | ring | rhd | hier algorithm knob
    # the members' JAX names: their element order on the wire
    collective_names: List[str] = dataclasses.field(default_factory=list)

    @property
    def total_size(self) -> int:
        return sum(self.sizes)

    def make_compressor(self):
        return compressor_lib.create(self.compressor_name, self.key)


def _collective_name(var_infos, name: str) -> str:
    return getattr(var_infos[name], "collective_name", "") or name


def make_buckets(ar_vars: Dict[str, object], var_infos
                 ) -> Tuple[List[Bucket], Dict[str, str]]:
    """Group unpartitioned AllReduce vars into buckets.

    ``ar_vars`` maps var_name -> AllReduceSynchronizer kernel. Returns
    (buckets, per_var) where ``per_var`` maps vars that must sync
    individually (non-concatable compressors like PowerSGD) to their
    compressor name. Buckets come in ``(group, compressor, spec,
    schedule)`` order, members in instance-key order of their JAX
    names."""
    groups: Dict[Tuple, List[str]] = {}
    per_var: Dict[str, str] = {}
    for name, sync in ar_vars.items():
        comp = sync.compressor.name
        if comp not in _CONCATABLE:
            per_var[name] = comp
            continue
        dtype = var_infos[name].dtype
        spec = getattr(sync, "spec", "AUTO")
        sched = (getattr(sync, "schedule", "auto") or "auto").lower()
        groups.setdefault((sync.group, comp, dtype, spec, sched),
                          []).append(name)
    buckets = []
    for (gid, comp, dtype, spec, sched), names in sorted(
            groups.items(), key=lambda kv: kv[0][:2] + kv[0][3:]):
        names = sorted(names, key=lambda n: CollectiveKey.instance_key(
            _collective_name(var_infos, n)))
        shapes = [tuple(var_infos[n].shape) for n in names]
        sizes = [int(np.prod(s or (1,))) for s in shapes]
        key = "g%d_%s_%s_%s" % (gid, comp, dtype, spec)
        if sched != "auto":
            key += "_%s" % sched
        buckets.append(Bucket(
            key=key, var_names=names, shapes=shapes, sizes=sizes,
            dtype=dtype, compressor_name=comp, spec=spec, schedule=sched,
            collective_names=[_collective_name(var_infos, n)
                              for n in names]))
    return buckets, per_var


def bucket_reduce(bucket: Bucket, grads: Dict[str, torch.Tensor], state,
                  psum, num_replicas: int, ring_axes=()):
    """Concat -> compress+psum -> mean -> split. Returns (synced dict,
    state). ``ring_axes`` — ``((process_group, size), ...)`` — arms int8
    compressors' two-phase quantized all-reduce, one per entry in order."""
    wire_names = bucket.collective_names or [""] * len(bucket.var_names)
    flat = torch.cat([to_jax_layout(grads[n], w).reshape(-1)
                      for n, w in zip(bucket.var_names, wire_names)])
    comp = bucket.make_compressor()
    if isinstance(comp, compressor_lib.Int8Compressor) and ring_axes:
        comp.ring_axes = tuple((g, n) for g, n in ring_axes if n > 1)
    reduced, new_state = comp.reduce(flat, state, psum)
    reduced = reduced / num_replicas
    out = {}
    offset = 0
    for n, w, shape, size in zip(bucket.var_names, wire_names, bucket.shapes,
                                 bucket.sizes):
        out[n] = from_jax_layout(reduced[offset:offset + size], shape, w)
        offset += size
    return out, new_state


# --------------------------------------------------- quantized wire codec


def wire_block_size() -> int:
    """Elements per absmax-scale block for the int8 wire codec
    (``ADT_WIRE_BLOCK``; floor-clamped to 8 — below that the f32 sidecar
    cancels the payload saving)."""
    return max(int(const.ENV.ADT_WIRE_BLOCK.val), 8)


def _quant_rows(xp: torch.Tensor):
    """Symmetric int8 quantization of each row (last axis) of ``xp``:
    ``(q int8, scale f32)``. A non-finite row poisons its scale (NaN) so
    divergence propagates instead of clipping away. Both divisions are
    correctly rounded, as in the JAX codec and its numpy mirror: each
    divides by a tensor on the data's device, since on CUDA torch turns a
    division by a Python scalar into a multiply by its reciprocal, which
    rounds differently."""
    absmax = xp.abs().amax(dim=-1)
    scale = torch.where(torch.isfinite(absmax), absmax.clamp_min(1e-30),
                        torch.full_like(absmax, float("nan"))) / \
        torch.full_like(absmax, 127.0)
    safe = torch.where(torch.isfinite(scale), scale,
                       torch.ones_like(scale))
    q = torch.clamp(torch.round(xp / safe[..., None]), -127, 127).to(
        torch.int8)
    return q, scale.to(torch.float32)


def quant_i8_block(x: torch.Tensor, block: int = 0):
    """Blockwise-scaled symmetric int8 quantization of a flat f32 vector
    (EQuARX's wire format, arXiv 2506.17615): pad to a block multiple,
    one absmax scale per ``block`` elements. Returns ``(q, s)`` with
    ``q: int8 [nb, block]`` and ``s: f32 [nb]``; round half to even."""
    block = block or wire_block_size()
    L = x.shape[0]
    nb = max(-(-L // block), 1)
    xp = F.pad(x.to(torch.float32), (0, nb * block - L)).reshape(nb, block)
    return _quant_rows(xp)


def dequant_i8_block(q: torch.Tensor, s: torch.Tensor, length: int):
    """Inverse of :func:`quant_i8_block`: flat f32 vector of ``length``."""
    out = q.to(torch.float32) * s.to(torch.float32)[:, None]
    return out.reshape(-1)[:length]


def quant_wire(arr, block: int = 0):
    """Any-shape tensor -> the wire container ``{"q": int8 [nb, block],
    "s": f32 [nb]}`` (flattened blockwise). The shape is not carried:
    both endpoints know it."""
    flat = torch.as_tensor(arr).to(torch.float32).reshape(-1)
    q, s = quant_i8_block(flat, block)
    return {"q": q, "s": s}


def dequant_wire(wire, shape, dtype=torch.float32):
    """Inverse of :func:`quant_wire` given the variable's shape."""
    length = int(np.prod(tuple(shape) or (1,)))
    return dequant_i8_block(wire["q"], wire["s"],
                            length).reshape(tuple(shape)).to(dtype)


def quant_wire_np(arr, block: int = 0):
    """Host-side (numpy) mirror of :func:`quant_wire`, with the same
    round-half-to-even rounding and NaN scales."""
    block = block or wire_block_size()
    flat = np.asarray(arr, np.float32).reshape(-1)
    L = flat.shape[0]
    nb = max(-(-L // block), 1)
    xp = np.pad(flat, (0, nb * block - L)).reshape(nb, block)
    absmax = np.max(np.abs(xp), axis=1)
    with np.errstate(invalid="ignore"):
        scale = np.where(np.isfinite(absmax),
                         np.maximum(absmax, 1e-30), np.nan) / 127.0
        safe = np.where(np.isfinite(scale), scale, 1.0)
        q = np.clip(np.round(xp / safe[:, None]), -127, 127).astype(np.int8)
    return {"q": q, "s": scale.astype(np.float32)}


def dequant_wire_np(wire, shape, dtype=np.float32):
    """Host-side mirror of :func:`dequant_wire`."""
    length = int(np.prod(tuple(shape) or (1,)))
    q = np.asarray(wire["q"], np.float32)
    s = np.asarray(wire["s"], np.float32)
    out = (q * s[:, None]).reshape(-1)[:length]
    return out.reshape(tuple(shape)).astype(dtype)


def wire_quantizable(info, min_block: bool = False) -> bool:
    """The one eligibility gate for the int8 wire codec, shared by the
    builders and the lowering. Dense float only — sparse (lookup-indexed)
    tables and integer values are never quantized (the linter's ADT310).
    ``min_block=True`` additionally requires at least one scale block
    (the builders' ADT311 policy gate)."""
    if info is None or getattr(info, "sparse", False):
        return False
    if not str(getattr(info, "dtype", "float32")).startswith(
            ("float", "bfloat")):
        return False
    if min_block and getattr(info, "num_elements", 0) < wire_block_size():
        return False
    return True


def int8_wire_payload_bytes(num_elements: int, itemsize: int = 4,
                            block: int = 0):
    """(quantized_bytes, full_width_bytes) for one wire crossing of a
    ``num_elements`` payload: the int8 body padded to a block multiple
    plus the f32 scale sidecar, vs the uncompressed payload."""
    block = block or wire_block_size()
    nb = max(-(-int(num_elements) // block), 1)
    return nb * block + nb * 4, int(num_elements) * int(itemsize)


class Pending:
    """A launched collective: ``wait()`` blocks on its handles (none for
    a collective that ran synchronously) and returns ``finish()``'s
    value, computed once."""

    def __init__(self, handles, finish: Callable):
        self._handles = [h for h in handles if h is not None]
        self._finish = finish
        self._done = False
        self._value = None

    def wait(self):
        if not self._done:
            for h in self._handles:
                h.wait()
            self._value = self._finish()
            self._done = True
        return self._value


def done(value) -> Pending:
    """A :class:`Pending` of an already computed value."""
    return Pending((), lambda: value)


# the cost class a program recording (kernel/lowering.py) gives the
# all_to_all being issued, where the op alone would mislead: the one that
# carries a reduce-scatter is the JAX lowering's reduce_scatter
_CARRIED_KIND = threading.local()


def carried_kind() -> Optional[str]:
    """The cost class of the ``all_to_all`` being issued, when it is not
    ``"alltoall"``; None otherwise."""
    return getattr(_CARRIED_KIND, "kind", None)


def _all_to_all(x: torch.Tensor, group, async_op: bool = False,
                kind: Optional[str] = None) -> Pending:
    out = torch.empty_like(x)
    _CARRIED_KIND.kind = kind
    try:
        handle = dist.all_to_all_single(out, x.contiguous(), group=group,
                                        async_op=async_op)
    finally:
        _CARRIED_KIND.kind = None
    tel.counter_add("sync.wire_bytes", x.numel() * x.element_size())
    return Pending([handle], lambda: out)


def _all_gather(x: torch.Tensor, group, n: int,
                async_op: bool = False) -> Pending:
    """The ranks' ``x`` stacked in rank order, ``[n, *x.shape]``."""
    parts = [torch.empty_like(x) for _ in range(n)]
    handle = dist.all_gather(parts, x.contiguous(), group=group,
                             async_op=async_op)
    tel.counter_add("sync.wire_bytes", x.numel() * x.element_size())
    return Pending([handle], lambda: torch.stack(parts))


def all_reduce_sum_launch(x: torch.Tensor, group=None,
                          async_op: bool = False) -> Pending:
    """Launch the sum of ``x`` over the ranks of ``group`` (None: the
    default group) into a new tensor; ``x`` is left as it was."""
    out = x.clone()
    handle = dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group,
                             async_op=async_op)
    tel.counter_add("sync.wire_bytes", out.numel() * out.element_size())
    return Pending([handle], lambda: out)


def int8_block_all_reduce(x: torch.Tensor, group, n: int, block: int = 0):
    """Sum a flat f32 vector over the ``n`` ranks of ``group`` with a
    blockwise-scaled int8 wire payload in the EQuARX two-phase shape:

    1. quantize -> reduce-scatter on the int8 payload: each rank
       blockwise-quantizes all ``n`` peer chunks and ships them in one
       ``all_to_all`` for the int8 body and one for the f32 scales;
    2. local dequant-accumulate: the received chunks dequantize and sum
       in f32, so accumulation never overflows int8;
    3. quantize -> all-gather: the completed chunk requantizes once and
       all-gathers (int8 + scales); every rank dequantizes the same
       bytes, so the result is bit-identical across ranks.

    Phases 1-2 are :func:`int8_block_reduce_scatter`, phase 3
    :func:`int8_block_all_gather`. Chunks are padded to whole scale
    blocks, so every chunk's scales are its own. Exactly two
    quantizations of any element; pair with error feedback
    (``Int8CompressorEF``) for training."""
    if n <= 1:
        return x
    shard = int8_block_reduce_scatter(x, group, n, block)
    return int8_block_all_gather(shard, group, n, block)[:x.shape[0]]


def int8_multi_axis_all_reduce(x: torch.Tensor, axes_sizes, block: int = 0):
    """Sum a flat f32 vector over several process groups in order, one
    two-phase quantized all-reduce each (``axes_sizes``: ``((group,
    size), ...)``). The port has one data axis, so one entry."""
    for group, n in axes_sizes:
        if n > 1:
            x = int8_block_all_reduce(x, group, n, block)
    return x


def _quant_i8(c: torch.Tensor):
    """Symmetric per-tensor int8 quantization of ``c``: ``(q, scale)``,
    the JAX ``_quant_i8`` (a non-finite input poisons the scale)."""
    q, s = _quant_rows(c.reshape(1, -1))
    return q.reshape(c.shape), s.reshape(())


def _dequant_i8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def int8_ring_all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum a flat f32 vector over the n ranks of ``group`` with an
    int8 wire payload, as an explicit ring (the JAX
    ``int8_ring_all_reduce``, EQuARX-style): a reduce-scatter of n - 1
    hops, each shipping one int8-quantized chunk and its f32 scale to the
    next rank while the accumulation stays f32 locally, then an
    all-gather of the completed chunks, quantized once. The owner of a
    chunk takes its own dequantized copy too, so every rank holds
    bit-identical sums. Each hop is two :func:`parallel.mesh._permute`
    exchanges (the body and its scale) over ``group``."""
    from autodist_tpu_torch.parallel import mesh
    n = dist.get_world_size(group)
    if n <= 1:
        return x
    b = mesh.AxisBinding("ring", n, dist.get_rank(group), group)
    L = x.shape[0]
    chunk = -(-L // n)
    acc = F.pad(x.to(torch.float32), (0, n * chunk - L)).reshape(n, chunk)
    idx = b.index
    perm = [(i, (i + 1) % n) for i in range(n)]

    def hop(q, s):
        return (mesh._permute(q, perm, q, b),
                mesh._permute(s.reshape(1), perm, s.reshape(1), b)[0])

    for t in range(n - 1):
        q, s = hop(*_quant_i8(acc[(idx - t) % n]))
        recv = (idx - t - 1) % n
        acc[recv] = acc[recv] + _dequant_i8(q, s)
    own = (idx + 1) % n  # this rank's fully reduced chunk
    q, s = _quant_i8(acc[own])
    out = torch.zeros_like(acc)
    out[own] = _dequant_i8(q, s)
    for t in range(1, n):
        q, s = hop(q, s)
        out[(own - t) % n] = _dequant_i8(q, s)
    return out.reshape(-1)[:L]


# ------------------------------------------ reduce-scatter and all-gather


def _pad_flat(x: torch.Tensor, n: int):
    """``x`` flattened and zero-padded to a multiple of ``n``; the
    unpadded length."""
    flat = x.reshape(-1)
    length = flat.shape[0]
    pad = (-length) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat, length


def rhd_psum(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """Recursive-halving/doubling all-reduce over the ``n`` ranks of
    ``group`` (None: the default group), as the reduce-scatter +
    all-gather composition (JAX ``collectives.rhd_psum``): the flat value
    zero-padded to a multiple of ``n``, each rank's chunk summed over the
    ranks, the chunks all-gathered. Every element is summed once, on one
    rank, and broadcast as it is, so the ranks' copies cannot drift."""
    if n <= 1:
        return x
    flat, length = _pad_flat(x, n)
    shard = reduce_scatter_flat_launch(flat, group, n).wait()
    return all_gather_flat(shard, group, n)[:length].reshape(x.shape)


def hierarchical_psum(x: torch.Tensor, hosts) -> torch.Tensor:
    """Bandwidth-hierarchical sum over every rank (JAX
    ``collectives.hierarchical_psum``), on ``hosts``
    (``parallel/mesh.py::HostGroups``): reduce-scatter within each host's
    group, all-reduce the 1/n_intra shard across the hosts (the group of
    the ranks with this rank's local index), then all-gather within the
    host, so the links between hosts carry 1/n_intra of the payload. One
    rank a host is the plain all-reduce across them, one host the plain
    all-reduce within it."""
    if hosts.n_inter <= 1:
        return all_reduce_sum_launch(x, hosts.intra).wait()
    if hosts.n_intra <= 1:
        return all_reduce_sum_launch(x, hosts.inter).wait()
    n = hosts.n_intra
    flat, length = _pad_flat(x, n)
    shard = reduce_scatter_flat_launch(flat, hosts.intra, n).wait()
    shard = all_reduce_sum_launch(shard, hosts.inter).wait()
    return all_gather_flat(shard, hosts.intra, n)[:length].reshape(x.shape)



def reduce_scatter_flat_launch(x: torch.Tensor, group, n: int,
                               async_op: bool = False) -> Pending:
    """Launch the sum-reduce-scatter of a flat vector of ``n`` equal
    chunks over the ``n`` ranks of ``group``: rank r receives chunk r
    summed over the ranks, ``[len(x) / n]``. One ``all_to_all_single``
    (chunk j to rank j), then a local sum of the received chunks."""
    if n <= 1:
        return done(x)
    out = _all_to_all(x, group, async_op, kind="scatter")
    return Pending([out], lambda: out.wait().reshape(n, -1).sum(dim=0))


def all_gather_flat_launch(x: torch.Tensor, group, n: int,
                           async_op: bool = False) -> Pending:
    """Launch the all-gather of each rank's flat chunk: the ``[n *
    len(x)]`` concatenation in rank order."""
    if n <= 1:
        return done(x)
    parts = _all_gather(x, group, n, async_op)
    return Pending([parts], lambda: parts.wait().reshape(-1))


def all_gather_flat(x: torch.Tensor, group, n: int) -> torch.Tensor:
    return all_gather_flat_launch(x, group, n).wait()


def int8_block_reduce_scatter_launch(x: torch.Tensor, group, n: int,
                                     block: int = 0,
                                     async_op: bool = False) -> Pending:
    """Launch :func:`int8_block_reduce_scatter`: the two ``all_to_all``
    of the int8 body and the f32 scales; the dequant-accumulate runs at
    ``wait()``."""
    block = block or wire_block_size()
    L = x.shape[0]
    chunk = -(-(-(-L // n)) // block) * block
    nb = chunk // block
    if n <= 1:
        return done(F.pad(x.to(torch.float32), (0, chunk - L)))
    xp = F.pad(x.to(torch.float32), (0, n * chunk - L)).reshape(n, nb, block)
    q, scale = _quant_rows(xp)
    q = _all_to_all(q, group, async_op)
    s = _all_to_all(scale, group, async_op)
    return Pending([q, s], lambda: (
        q.wait().to(torch.float32) * s.wait()[:, :, None]).sum(
            dim=0).reshape(-1))


def int8_block_reduce_scatter(x: torch.Tensor, group, n: int,
                              block: int = 0) -> torch.Tensor:
    """Reduce-scatter a flat f32 vector over the ``n`` ranks of ``group``
    with a blockwise int8 wire payload — phases 1+2 of the two-phase
    all-reduce (:func:`int8_block_all_reduce`), stopping before the
    all-gather: each rank blockwise-quantizes all ``n`` peer chunks,
    ships them in one ``all_to_all`` (int8 body + f32 scale sidecar),
    then dequant-accumulates its own chunk locally in f32. Returns this
    rank's summed chunk of ``ceil-to-block(ceil(L/n))`` elements; chunk
    ``r`` lands on rank ``r``. The gradient wire of the ZeRO-sharded
    update."""
    return int8_block_reduce_scatter_launch(x, group, n, block).wait()


def int8_block_all_gather(x: torch.Tensor, group, n: int,
                          block: int = 0) -> torch.Tensor:
    """All-gather a flat f32 chunk over the ``n`` ranks of ``group`` with
    a blockwise int8 wire payload: quantize the local chunk once,
    all-gather body + scales, and dequantize the SHARED bytes — every
    rank (the chunk's owner too) reconstructs from the same int8 image,
    so the result is bit-identical across ranks. Returns the ``[n *
    padded_chunk]`` concatenation in rank order. The update wire of the
    ZeRO-sharded update."""
    block = block or wire_block_size()
    if n <= 1:
        return x.to(torch.float32)
    q, s = quant_i8_block(x.to(torch.float32).reshape(-1), block)
    qg = _all_gather(q, group, n).wait().reshape(-1, block)   # [n*nb, block]
    sg = _all_gather(s, group, n).wait().reshape(-1)          # [n*nb]
    return (qg.to(torch.float32) * sg[:, None]).reshape(-1)


# ----------------------------------------------- collective-schedule IR


VALID_OP_KINDS = ("reduce", "reduce_scatter", "all_gather")


@dataclasses.dataclass(frozen=True)
class CollectiveOp:
    """One collective in the gradient-sync schedule: ``kind`` over the
    named mesh ``axes``, reducing/gathering the sync unit ``unit`` (a
    bucket key, ``var:<name>`` or ``zero:<name>``)."""
    kind: str                       # reduce | reduce_scatter | all_gather
    unit: str
    axes: Tuple[str, ...]
    var_names: Tuple[str, ...] = ()
    payload_elems: int = 0
    wire_dtype: str = "fp32"


@dataclasses.dataclass(frozen=True)
class ScheduleStage:
    """An ordered stage of the schedule. ``ready_rank`` is the position
    in the backward pass (max var index of the unit's gradients, in
    params-flatten order) after which every op in the stage is launchable
    — stages are emitted in DESCENDING ready_rank, i.e. reverse layer
    order, because later layers' gradients materialize first in the
    backward sweep. ``deps`` names earlier stage indices that must
    launch before this stage does."""
    index: int
    ops: Tuple[CollectiveOp, ...]
    ready_rank: int = 0
    deps: Tuple[int, ...] = ()

    @property
    def var_names(self) -> Tuple[str, ...]:
        return tuple(n for op in self.ops for n in op.var_names)


@dataclasses.dataclass(frozen=True)
class GradSyncSchedule:
    """The gradient-synchronization schedule the overlapped lowering
    executes: ordered stages of collectives with explicit ready
    dependencies. ``validate()`` is the IR's one structural contract."""
    stages: Tuple[ScheduleStage, ...]

    @property
    def num_stages(self) -> int:
        return len(self.stages)

    @property
    def num_collectives(self) -> int:
        return sum(len(st.ops) for st in self.stages)

    def validate(self) -> None:
        seen_units = set()
        for pos, st in enumerate(self.stages):
            if st.index != pos:
                raise ValueError(
                    "schedule stage %d carries index %d — stages must be "
                    "densely numbered in emission order" % (pos, st.index))
            if not st.ops:
                raise ValueError("schedule stage %d has no ops" % pos)
            for dep in st.deps:
                if not 0 <= dep < pos:
                    raise ValueError(
                        "stage %d depends on stage %d which does not "
                        "precede it" % (pos, dep))
            for op in st.ops:
                if op.kind not in VALID_OP_KINDS:
                    raise ValueError("unknown collective kind %r (stage %d)"
                                     % (op.kind, pos))
                if not op.axes:
                    raise ValueError("op %r reduces over no mesh axes"
                                     % (op.unit,))
                if (op.kind, op.unit) in seen_units:
                    raise ValueError("unit %r scheduled twice for %s"
                                     % (op.unit, op.kind))
                seen_units.add((op.kind, op.unit))
        ranks = [st.ready_rank for st in self.stages]
        if ranks != sorted(ranks, reverse=True):
            raise ValueError(
                "stages are not in reverse-readiness order (ready_rank "
                "must be non-increasing): %r" % (ranks,))

    def describe(self) -> str:
        lines = []
        for st in self.stages:
            ops = ", ".join("%s(%s%s)" % (
                op.kind, op.unit,
                ", int8" if op.wire_dtype == "int8" else "")
                for op in st.ops)
            dep = (" after %s" % (",".join(map(str, st.deps)))
                   if st.deps else "")
            lines.append("stage %d [ready@%d]%s: %s"
                         % (st.index, st.ready_rank, dep, ops))
        return "\n".join(lines)


def build_grad_sync_schedule(units, var_positions) -> GradSyncSchedule:
    """Order gradient-sync units into a :class:`GradSyncSchedule`.

    ``units`` — iterable of ``(unit_id, kind, var_names, payload_elems,
    wire_dtype, axes)`` — one entry per sync unit the lowering would
    execute (a concat bucket, a per-var sync, a ZeRO reduce-scatter).
    ``var_positions`` maps var_name -> index in params-flatten order.

    Stages are emitted one unit each, sorted by DESCENDING max var
    position (reverse layer order): in the backward sweep the LAST
    layer's gradients are produced first, so its stage launches first and
    overlaps with the remaining backward compute. Each stage depends on
    its predecessor: the collectives launch in stage order on every
    rank."""
    entries = []
    for unit_id, kind, var_names, payload, wire_dtype, axes in units:
        if kind not in VALID_OP_KINDS:
            raise ValueError("unknown unit kind %r" % (kind,))
        rank = max((int(var_positions.get(n, 0)) for n in var_names),
                   default=0)
        entries.append((rank, unit_id, kind, tuple(var_names),
                        int(payload), wire_dtype, tuple(axes)))
    # descending readiness rank; unit_id tie-break keeps emission stable
    entries.sort(key=lambda e: (-e[0], e[1]))
    stages = []
    for i, (rank, unit_id, kind, names, payload, wire, axes) in enumerate(
            entries):
        op = CollectiveOp(kind=kind, unit=unit_id, axes=axes,
                          var_names=names, payload_elems=payload,
                          wire_dtype=wire)
        stages.append(ScheduleStage(index=i, ops=(op,), ready_rank=rank,
                                    deps=(i - 1,) if i else ()))
    sched = GradSyncSchedule(stages=tuple(stages))
    sched.validate()
    return sched


# The gradient-sync algorithms the schedule IR can place (JAX
# ``SCHEDULE_ALGORITHMS``): ring (one reduce), rhd (reduce-scatter +
# all-gather, :func:`rhd_psum`) and hier (the two-level
# :func:`hierarchical_psum`).
SCHEDULE_ALGORITHMS = ("ring", "rhd", "hier")


def synthesize_collective_candidates(unit: str, axes, intra_axes=(),
                                     inter_axes=(), payload_elems: int = 0,
                                     wire_dtype: str = "fp32",
                                     var_names=()):
    """The candidate stage compositions for one ``reduce`` sync unit over
    named mesh ``axes`` (the JAX function): ``{algorithm: (CollectiveOp,
    ...)}`` for the three algorithms the lowering can execute; ``hier``
    exists only when both an intra- and an inter-host axis are named.
    Every candidate is reduction-equivalent to the flat reduce it
    replaces (:func:`reduction_equivalent`, which the ADT522 lint
    re-checks)."""
    axes = tuple(axes)
    intra = tuple(a for a in (intra_axes or ()) if a in axes)
    inter = tuple(a for a in (inter_axes or ()) if a in axes)
    names = tuple(var_names)

    def op(kind, over, elems=payload_elems):
        return CollectiveOp(kind=kind, unit=unit, axes=tuple(over),
                            var_names=names, payload_elems=int(elems),
                            wire_dtype=wire_dtype)

    out = {
        "ring": (op("reduce", axes),),
        "rhd": (op("reduce_scatter", axes),
                op("all_gather", axes)),
    }
    if intra and inter:
        out["hier"] = (op("reduce_scatter", intra),
                       op("reduce", inter),
                       op("all_gather", intra))
    return out


def reduction_equivalent(stages, target) -> bool:
    """True when a stage composition computes exactly the reduction
    ``target`` (a ``reduce`` :class:`CollectiveOp`, or anything with
    ``.axes``) does — the ADT522 contract, as in JAX: it reduces over
    exactly the target's axes, each once; every reduce_scatter is matched
    by a later all_gather over the same axes; nothing else is
    interleaved."""
    want = tuple(target.axes)
    ops = tuple(stages)
    if not ops:
        return False
    reduced = []           # axes whose reduction has been applied
    open_scatters = []     # reduce_scatter axes awaiting their all_gather
    for op in ops:
        if op.kind == "reduce":
            reduced.extend(op.axes)
        elif op.kind == "reduce_scatter":
            reduced.extend(op.axes)
            open_scatters.append(tuple(op.axes))
        elif op.kind == "all_gather":
            if not open_scatters or open_scatters[-1] != tuple(op.axes):
                return False  # gathers a shard nothing scattered
            open_scatters.pop()
        else:
            return False
    if open_scatters:
        return False  # a shard never came back: not an all-reduce
    return sorted(reduced) == sorted(want) and len(set(reduced)) == len(
        reduced)
