"""Gradient compressors for all-reduce (PyTorch counterpart of
``autodist_tpu/kernel/synchronization/compressor.py``).

A strategy-pattern wrapper around the collective: ``NoneCompressor``
(passthrough), ``HorovodCompressor`` (reduced-precision transfer: a bf16
wire, as in the JAX package), ``HorovodCompressorEF`` (the same with an
error-feedback residual), ``Int8Compressor``/``Int8CompressorEF`` (the
blockwise int8 two-phase all-reduce, ``parallel/collectives.py``) and
``PowerSGDCompressor`` (rank-r power iteration, arXiv 1905.13727).

A compressor transforms the payload *around* the all-reduce:
``compress -> psum -> decompress``. Stateful compressors (error feedback,
PowerSGD's warm-started Q) carry their state in the train state's
``sync_state`` (``"bucket"`` / ``"var"``), one copy per rank.
"""
from typing import Callable, Dict, Optional, Tuple

import torch

from autodist_tpu_torch.kernel.synchronization.collective_key import \
    CollectiveKey


def _dtype(dtype) -> torch.dtype:
    return dtype if isinstance(dtype, torch.dtype) else getattr(
        torch, str(dtype))


class Compressor:
    """Base: stateless passthrough. ``state_init(grad_shape, dtype)``
    returns the state carried across steps (None when stateless)."""

    name = "NoneCompressor"

    def __init__(self, var_name: str = ""):
        self.var_name = var_name

    def state_init(self, grad_shape, dtype):
        return None

    def reduce(self, grad: torch.Tensor, state,
               psum: Callable) -> Tuple[torch.Tensor, object]:
        """Return (sum-reduced gradient, new state). ``psum`` is the
        group-bound sum-reduction supplied by the synchronizer, which
        normalizes to a mean afterwards."""
        return psum(grad), state


class NoneCompressor(Compressor):
    pass


class HorovodCompressor(Compressor):
    """Cast the payload to a smaller dtype for the wire, cast back after.
    The reference compresses fp64 -> fp32; the JAX package's gradients are
    fp32, so its halving cast is bf16, and so is the port's."""

    name = "HorovodCompressor"
    wire_dtype = torch.bfloat16

    def reduce(self, grad, state, psum):
        orig = grad.dtype
        if grad.dtype in (torch.float32, torch.float64):
            reduced = psum(grad.to(self.wire_dtype)).to(orig)
        else:
            reduced = psum(grad)
        return reduced, state


class HorovodCompressorEF(Compressor):
    """Reduced-precision all-reduce with error feedback: this step's
    quantization error is added back into the next step's gradient,
    preserving the sum of updates over time."""

    name = "HorovodCompressorEF"
    wire_dtype = torch.bfloat16

    def state_init(self, grad_shape, dtype):
        return torch.zeros(tuple(grad_shape), dtype=_dtype(dtype))

    def reduce(self, grad, state, psum):
        orig = grad.dtype
        compensated = grad + state
        wire = compensated.to(self.wire_dtype)
        new_state = compensated - wire.to(orig)  # local quantization error
        reduced = psum(wire).to(orig)
        return reduced, new_state


class Int8Compressor(Compressor):
    """Blockwise-scaled int8 wire through the explicit two-phase quantized
    all-reduce (EQuARX, arXiv 2506.17615): quantize -> reduce-scatter the
    int8 payload (one all_to_all) -> local dequant-accumulate in f32 ->
    quantize -> all-gather. The bucketing layer arms ``ring_axes`` —
    ``((process_group, size), ...)``, one two-phase reduce each, run in
    order. Unarmed (a degenerate one-replica reduction), the payload falls
    back to the bf16 psum."""

    name = "Int8Compressor"
    wire_dtype = torch.bfloat16  # fallback wire when unarmed

    def __init__(self, var_name: str = ""):
        super().__init__(var_name)
        self.ring_axes = ()

    def _wire_reduce(self, grad):
        from autodist_tpu_torch.parallel import collectives
        flat = grad.reshape(-1).to(torch.float32)
        out = collectives.int8_multi_axis_all_reduce(flat, self.ring_axes)
        return out.reshape(grad.shape).to(grad.dtype)

    def reduce(self, grad, state, psum):
        if not self.ring_axes:
            return HorovodCompressor.reduce(self, grad, state, psum)
        return self._wire_reduce(grad), state


class Int8CompressorEF(Int8Compressor):
    """The blockwise int8 two-phase all-reduce with error feedback. The
    compensated gradient goes to the collective directly; the residual is
    taken against the blockwise quantized image of the whole compensated
    vector (the first phase's wire error), with no second quantize round
    trip on the payload. Unarmed, this is exactly BF16CompressorEF."""

    name = "Int8CompressorEF"

    def state_init(self, grad_shape, dtype):
        return torch.zeros(tuple(grad_shape), dtype=_dtype(dtype))

    def reduce(self, grad, state, psum):
        if not self.ring_axes:
            return HorovodCompressorEF.reduce(self, grad, state, psum)
        from autodist_tpu_torch.parallel.collectives import (
            dequant_i8_block, quant_i8_block)
        compensated = grad + state
        flat = compensated.reshape(-1).to(torch.float32)
        q, s = quant_i8_block(flat)
        wire_image = dequant_i8_block(q, s, flat.shape[0]).reshape(
            grad.shape).to(grad.dtype)
        new_state = compensated - wire_image
        return self._wire_reduce(compensated), new_state


class PowerSGDCompressor(Compressor):
    """Rank-r PowerSGD (arXiv 1905.13727) with error feedback and a
    warm-started Q factor. Communicates P (n x r) + Q (m x r) instead of
    the full n x m gradient. Matrices only; lower-rank tensors pass
    through. Per variable: not concatable into a bucket."""

    name = "PowerSGDCompressor"

    def __init__(self, var_name: str = "", rank: int = 1):
        super().__init__(var_name)
        self.rank = rank

    def _matrix_shape(self, shape):
        if len(shape) < 2:
            return None
        m = 1
        for d in shape[1:]:
            m *= d
        return shape[0], m

    def state_init(self, grad_shape, dtype):
        nm = self._matrix_shape(tuple(grad_shape))
        if nm is None:
            return None
        n, m = nm
        # md5-derived seed: every rank builds the identical Q (builtin
        # hash() is randomized per process)
        gen = torch.Generator().manual_seed(
            CollectiveKey.instance_key(self.var_name))
        q = torch.randn((m, self.rank), generator=gen, dtype=_dtype(dtype))
        return {"error": torch.zeros(tuple(grad_shape), dtype=_dtype(dtype)),
                "q": q}

    def reduce(self, grad, state, psum):
        nm = self._matrix_shape(tuple(grad.shape))
        if nm is None or state is None:
            return psum(grad), state
        n, m = nm
        mat = (grad + state["error"]).reshape(n, m)
        q = state["q"]
        # power iteration: P = M Q (all-reduced), orthonormalize, Q = M^T P
        p = psum(mat @ q)
        p, _ = torch.linalg.qr(p)
        q_new = psum(mat.T @ p)
        approx = (p @ q_new.T).reshape(grad.shape)
        # the all-reduced approx is a sum over ranks already; error is local
        new_error = (grad + state["error"]) - (p @ (mat.T @ p).T).reshape(
            grad.shape)
        return approx, {"error": new_error, "q": q_new}


_REGISTRY: Dict[str, type] = {
    c.name: c for c in
    (NoneCompressor, HorovodCompressor, HorovodCompressorEF,
     Int8Compressor, Int8CompressorEF, PowerSGDCompressor)
}
# the JAX package's TPU-flavored aliases
_REGISTRY["BF16Compressor"] = HorovodCompressor
_REGISTRY["BF16CompressorEF"] = HorovodCompressorEF


def parse_name(name: str) -> "tuple[str, Optional[int]]":
    """Split a serializable compressor name into (base, rank).

    The one place that knows the ``"PowerSGDCompressor:4"`` wire format;
    rank is None when the name carries no argument. Raises ValueError for
    a dangling ``:``, a non-integer rank, a rank < 1, or an argument on a
    compressor that takes none.
    """
    base, sep, arg = name.partition(":")
    if not sep:
        return base, None
    if base not in _REGISTRY:
        raise ValueError("unknown compressor %r (have %s)"
                         % (name, sorted(_REGISTRY)))
    if _REGISTRY[base] is not PowerSGDCompressor:
        raise ValueError("compressor %r takes no argument" % name)
    try:
        rank = int(arg)
    except ValueError:
        raise ValueError("compressor %r: rank must be an integer" % name)
    if rank < 1:
        raise ValueError("compressor %r: rank must be >= 1" % name)
    return base, rank


def known_names() -> "tuple[str, ...]":
    """Every serializable compressor name (aliases included)."""
    return tuple(sorted(_REGISTRY))


def validate_name(name: str) -> "tuple[str, Optional[int]]":
    """Full validation of a serializable compressor name: format (via
    :func:`parse_name`) and registry membership."""
    base, rank = parse_name(name)
    if base not in _REGISTRY:
        raise ValueError("unknown compressor %r (have %s)"
                         % (name, sorted(_REGISTRY)))
    return base, rank


def create(name: Optional[str], var_name: str = "") -> Compressor:
    """Factory by class name. PowerSGD's rank rides in the serializable
    name: ``"PowerSGDCompressor:4"``."""
    if not name:
        return NoneCompressor(var_name)
    base, rank = validate_name(name)
    cls = _REGISTRY[base]
    if rank is not None:
        return cls(var_name, rank=rank)
    return cls(var_name)
