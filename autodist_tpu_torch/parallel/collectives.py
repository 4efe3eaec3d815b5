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
  f32 dequant-accumulate, a requantize and an ``all_gather``.

The JAX codec is plain XLA outside any Pallas kernel; its counterpart
here is plain torch ops. The collectives run on the process group they
are given, on whatever device the tensors are on: the same calls serve
NCCL and gloo (gloo runs ``all_to_all_single``, ``all_gather`` and
``all_reduce`` on CUDA tensors by staging them through the host).

The schedule IR, the hierarchical and recursive halving/doubling psums
and the ring variants of the JAX module are not ported yet.
"""
import dataclasses
from typing import Dict, List, Tuple

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


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    tel.counter_add("sync.wire_bytes", x.numel() * x.element_size())
    return out


def _all_gather(x: torch.Tensor, group, n: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    tel.counter_add("sync.wire_bytes", x.numel() * x.element_size())
    return torch.stack(parts)


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

    Chunks are padded to whole scale blocks, so every chunk's scales are
    its own. Exactly two quantizations of any element; pair with error
    feedback (``Int8CompressorEF``) for training."""
    block = block or wire_block_size()
    if n <= 1:
        return x
    L = x.shape[0]
    chunk = -(-(-(-L // n)) // block) * block
    nb = chunk // block
    xp = F.pad(x.to(torch.float32), (0, n * chunk - L)).reshape(n, nb, block)
    q, scale = _quant_rows(xp)
    q = _all_to_all(q, group)
    s = _all_to_all(scale, group)
    acc = (q.to(torch.float32) * s[:, :, None]).sum(dim=0)   # [nb, block]
    q2, s2 = quant_i8_block(acc.reshape(-1), block)
    q2g = _all_gather(q2, group, n)                            # [n, nb, block]
    s2g = _all_gather(s2, group, n)                            # [n, nb]
    out = q2g.to(torch.float32) * s2g[:, :, None]
    return out.reshape(-1)[:L]


def int8_multi_axis_all_reduce(x: torch.Tensor, axes_sizes, block: int = 0):
    """Sum a flat f32 vector over several process groups in order, one
    two-phase quantized all-reduce each (``axes_sizes``: ``((group,
    size), ...)``). The port has one data axis, so one entry."""
    for group, n in axes_sizes:
        if n > 1:
            x = int8_block_all_reduce(x, group, n, block)
    return x
