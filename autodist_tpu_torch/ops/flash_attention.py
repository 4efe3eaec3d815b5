"""Flash attention: exact fused attention through hand-written CUDA
kernels for Hopper, forward and backward.

PyTorch counterpart of ``autodist_tpu/ops/flash_attention.py``, whose three
Pallas kernels each have a counterpart here:

- :func:`flash_fwd` wraps ``csrc/flash_fwd.cu`` (sm_90a), which replaces
  ``_fwd_kernel``: the online-softmax forward and the per-row log-sum-exp,
  with the causal flag, optional ``(q_seg, kv_seg)`` segment ids,
  ``NEG_INF = -1e30`` masking and the empty-row rule (a row with no
  visible key gives 0 and lse 0). Decode reads each live K/V row once and
  the kernel skips tiles past every row's cursor; its times against its
  byte bound are in ``PERF.md``.
- :func:`flash_bwd_dq` and :func:`flash_bwd_dkdv` wrap the two kernels of
  ``csrc/flash_bwd.cu``, which replace ``_dq_kernel`` and ``_dkdv_kernel``
  with their rounding points (dS rounded to k's dtype for dQ; P rounded
  to dO's dtype for dV and dS to q's dtype for dK).
- ``flash_*_reference`` are their plain PyTorch versions: the same tile
  loops in f32, the same masks, rounding points and empty-row rule.

Each kernel comes in designs (variants), picked by a fixed rule on the
dtype in one pure function per kernel: :func:`_fwd_variant`,
:func:`_dq_variant`, :func:`_dkdv_variant`. All three run
``"mma.sync bf16"`` in bf16 (64-row tiles on the tensor cores, ``csrc/
mma_bf16.cuh``) and ``"scalar f32"`` in f32 (tensor cores would round f32
operands to TF32, and the f32 paths are held to 2e-5). Nothing picks a
design on a failure.

Each wrapper takes the plain version only for CPU tensors. For CUDA
tensors it launches the kernel or raises; nothing falls back. Each launch
adds one to the wrapper's ``launches`` count and to its
``launches_by_variant[variant]``; a replayed CUDA graph adds the
launches its capture recorded (:func:`add_launch_counts`).
:func:`flash_attention` is differentiable: its autograd function runs the
forward kernel, then delta = rowsum(dO * O) in f32 and the two backward
kernels, as the JAX ``custom_vjp`` does; segment ids get no gradient.

Layout: ``[batch, seq, heads, head_dim]``; segment ids ``[batch, seq]``;
lse and delta ``[batch, heads, seq]`` float32.
"""
import ctypes
import math

import torch

NEG_INF = -1e30    # finite stand-in for -inf, as in the TPU kernel
HEAD_DIM = 64      # the head width the CUDA kernel is compiled for
BLOCK_K = 64       # kv rows per tile, in the kernels and their plain versions
BLOCK_Q = 64       # query rows per tile of the dK/dV kernel and its plain version


def _pick_block(seq: int, want: int) -> int:
    """Largest power-of-two block <= want that divides seq (0 if none >= 8)
    — the JAX module's rule for which lengths its kernel tiles."""
    b = min(want, seq)
    while b & (b - 1):
        b &= b - 1
    while b >= 8 and seq % b:
        b //= 2
    return b if b >= 8 else 0


def _check(q, k, v, q_seg, kv_seg):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes [B, S, H, D] q, k, v; got "
                         "%s %s %s"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    B, _, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2] != H \
            or k.shape[3] != D:
        raise ValueError("k/v %s %s do not match q %s"
                         % (tuple(k.shape), tuple(v.shape), tuple(q.shape)))
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k, v dtypes differ: %s %s %s"
                         % (q.dtype, k.dtype, v.dtype))
    if (q_seg is None) != (kv_seg is None):
        raise ValueError("pass both q_seg and kv_seg, or neither")
    if q_seg is not None and (tuple(q_seg.shape) != (B, q.shape[1])
                              or tuple(kv_seg.shape) != (B, k.shape[1])):
        raise ValueError("segment ids must be [B, Sq] and [B, Sk], got %s %s"
                         % (tuple(q_seg.shape), tuple(kv_seg.shape)))


def _masked(s, q0, k0, causal, q_seg, kv_seg):
    """Score tile ``s`` [B, H, nq, nk] for query rows ``q0 + i`` and key
    rows ``k0 + j`` with its invisible entries set to ``NEG_INF`` (the
    TPU kernels' ``_mask_val``)."""
    nq, nk = s.shape[-2:]
    dev = s.device
    mask = torch.ones((nq, nk), dtype=torch.bool, device=dev)
    if causal:
        rows = torch.arange(q0, q0 + nq, device=dev)[:, None]
        cols = torch.arange(k0, k0 + nk, device=dev)[None, :]
        mask = rows >= cols
    if q_seg is not None:
        mask = mask & (q_seg[:, None, q0:q0 + nq, None]
                       == kv_seg[:, None, None, k0:k0 + nk])
    return torch.where(mask, s, torch.full_like(s, NEG_INF))


def flash_fwd_reference(q, k, v, q_seg=None, kv_seg=None,
                        causal: bool = False):
    """Plain PyTorch version of :func:`flash_fwd`: the kernel's tile loop
    over kv blocks of ``BLOCK_K`` rows, f32 online softmax, the same masks
    and empty-row rule, p rounded to the value dtype before P.V. Returns
    ``(out [B, Sq, H, D] in q's dtype, lse [B, H, Sq] f32)``."""
    _check(q, k, v, q_seg, kv_seg)
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    qf = q.permute(0, 2, 1, 3).float()                    # [B, H, Sq, D]
    kt = k.permute(0, 2, 1, 3)
    vt = v.permute(0, 2, 1, 3)
    m = torch.full((B, H, Sq, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Sq, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=dev)
    for k0 in range(0, Sk, BLOCK_K):
        kb = kt[:, :, k0:k0 + BLOCK_K].float()
        vb = vt[:, :, k0:k0 + BLOCK_K]
        s = torch.matmul(qf, kb.transpose(-1, -2)) * scale  # [B, H, Sq, bk]
        s = _masked(s, 0, k0, causal, q_seg, kv_seg)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        p = torch.where(m_new > NEG_INF * 0.5, p, torch.zeros_like(p))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(p.to(v.dtype).float(), vb.float())
        m = m_new
    out = (acc / l.clamp_min(1e-30)).to(q.dtype).permute(0, 2, 1, 3)
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)),
                      torch.zeros_like(l))[..., 0]
    return out.contiguous(), lse


def _check_bwd(q, k, v, do, lse, delta, q_seg, kv_seg):
    _check(q, k, v, q_seg, kv_seg)
    B, Sq, H, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError("dout %s %s must match q %s %s"
                         % (tuple(do.shape), do.dtype, tuple(q.shape),
                            q.dtype))
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (B, H, Sq) or t.dtype != torch.float32:
            raise ValueError("%s must be float32 [B, H, Sq] = %s, got %s %s"
                             % (name, (B, H, Sq), tuple(t.shape), t.dtype))


def flash_bwd_delta(out, do):
    """delta = rowsum(dO * O) in f32, ``[B, H, Sq]`` — what the JAX
    ``_bwd`` computes outside its kernels."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_bwd_dq_reference(q, k, v, do, lse, delta, q_seg=None, kv_seg=None,
                           causal: bool = False):
    """Plain PyTorch version of :func:`flash_bwd_dq` (``_dq_kernel``): for
    every query row, loop over kv tiles of ``BLOCK_K`` rows, recompute
    p = exp(s - lse), form ds = (p * (dp - delta) * scale) rounded to k's
    dtype and accumulate dq += ds k in f32. Returns dq ``[B, Sq, H, D]``
    in q's dtype."""
    _check_bwd(q, k, v, do, lse, delta, q_seg, kv_seg)
    Sk, D = k.shape[1], q.shape[3]
    scale = 1.0 / math.sqrt(D)
    qf = q.permute(0, 2, 1, 3).float()                    # [B, H, Sq, D]
    dof = do.permute(0, 2, 1, 3).float()
    kt, vt = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    lse_, delta_ = lse[..., None], delta[..., None]       # [B, H, Sq, 1]
    acc = torch.zeros(qf.shape, dtype=torch.float32, device=q.device)
    for k0 in range(0, Sk, BLOCK_K):
        kb = kt[:, :, k0:k0 + BLOCK_K].float()
        vb = vt[:, :, k0:k0 + BLOCK_K].float()
        s = _masked(torch.matmul(qf, kb.transpose(-1, -2)) * scale, 0, k0,
                    causal, q_seg, kv_seg)
        p = torch.exp(s - lse_)
        dp = torch.matmul(dof, vb.transpose(-1, -2))
        ds = (p * (dp - delta_) * scale).to(k.dtype).float()
        acc = acc + torch.matmul(ds, kb)
    return acc.to(q.dtype).permute(0, 2, 1, 3).contiguous()


def flash_bwd_dkdv_reference(q, k, v, do, lse, delta, q_seg=None,
                             kv_seg=None, causal: bool = False):
    """Plain PyTorch version of :func:`flash_bwd_dkdv` (``_dkdv_kernel``):
    for every kv row, loop over query tiles of ``BLOCK_Q`` rows, recompute
    e = exp(s - lse), accumulate dv += p^T dO with p = e rounded to dO's
    dtype, and dk += ds^T q with ds = (e * (dp - delta) * scale) rounded to
    q's dtype, both in f32. Returns ``(dk, dv)`` ``[B, Sk, H, D]`` in k's
    and v's dtype."""
    _check_bwd(q, k, v, do, lse, delta, q_seg, kv_seg)
    Sq, D = q.shape[1], q.shape[3]
    scale = 1.0 / math.sqrt(D)
    qt, dot = q.permute(0, 2, 1, 3), do.permute(0, 2, 1, 3)
    kf = k.permute(0, 2, 1, 3).float()                    # [B, H, Sk, D]
    vf = v.permute(0, 2, 1, 3).float()
    dk = torch.zeros(kf.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(kf.shape, dtype=torch.float32, device=q.device)
    for q0 in range(0, Sq, BLOCK_Q):
        qb = qt[:, :, q0:q0 + BLOCK_Q].float()
        dob = dot[:, :, q0:q0 + BLOCK_Q].float()
        lse_ = lse[:, :, q0:q0 + BLOCK_Q, None]
        delta_ = delta[:, :, q0:q0 + BLOCK_Q, None]
        s = _masked(torch.matmul(qb, kf.transpose(-1, -2)) * scale, q0, 0,
                    causal, q_seg, kv_seg)                # [B, H, bq, Sk]
        e = torch.exp(s - lse_)
        p = e.to(do.dtype).float()
        dv = dv + torch.matmul(p.transpose(-1, -2), dob)
        dp = torch.matmul(dob, vf.transpose(-1, -2))
        ds = (e * (dp - delta_) * scale).to(q.dtype).float()
        dk = dk + torch.matmul(ds.transpose(-1, -2), qb)
    return (dk.to(k.dtype).permute(0, 2, 1, 3).contiguous(),
            dv.to(v.dtype).permute(0, 2, 1, 3).contiguous())


# the designs the C entry points take, by their variant code
VARIANT_CODE = {"scalar f32": 0, "mma.sync bf16": 2}


def _fwd_variant(dtype) -> str:
    """The forward's design for q of ``dtype``: the tensor-core kernel for
    bf16 at every length (at the lm1b decode step, Sq = 1, it measured
    faster than the scalar design it replaced; ``PERF.md``), the scalar
    one for f32."""
    return "mma.sync bf16" if dtype == torch.bfloat16 else "scalar f32"


def _dq_variant(dtype) -> str:
    """dQ's design: the tensor-core kernel for bf16, the scalar one for
    f32."""
    return "mma.sync bf16" if dtype == torch.bfloat16 else "scalar f32"


def _dkdv_variant(dtype) -> str:
    """dK/dV's design: the tensor-core kernel for bf16, the scalar one for
    f32."""
    return "mma.sync bf16" if dtype == torch.bfloat16 else "scalar f32"


def _count(fn, variant):
    fn.launches += 1
    fn.launches_by_variant[variant] = \
        fn.launches_by_variant.get(variant, 0) + 1


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C signature of each entry point: (library, function, argtypes)
_ENTRY = {
    "flash_fwd": ("flash_fwd", "adt_flash_fwd",
                  [_I] + [_P] * 7 + [_I] * 5 + [_LL] * 9
                  + [_I, ctypes.c_float, _P]),
    "flash_bwd_dq": ("flash_bwd", "adt_flash_bwd_dq",
                     [_I] + [_P] * 9 + [_I] * 5 + [_LL] * 12
                     + [_I, ctypes.c_float, _P]),
    "flash_bwd_dkdv": ("flash_bwd", "adt_flash_bwd_dkdv",
                       [_I] + [_P] * 10 + [_I] * 5 + [_LL] * 12
                       + [_I, ctypes.c_float, _P]),
}
_fns = {}


def _kernel(name):
    """Entry point ``name`` of its built library, C signature declared
    (the first use builds ``csrc/<library>.cu`` with nvcc)."""
    fn = _fns.get(name)
    if fn is None:
        from autodist_tpu_torch.utils import cuda_build
        lib, sym, argtypes = _ENTRY[name]
        fn = getattr(cuda_build.load(lib), sym)
        fn.argtypes = argtypes
        fn.restype = _I
        _fns[name] = fn
    return fn


def _kernel_view(x):
    """``x`` if the kernel can read it in place (d contiguous, rows 16-byte
    aligned), else a contiguous copy."""
    es = x.element_size()
    ok = (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
          and all((s * es) % 16 == 0 for s in x.stride()[:3]))
    return x if ok else x.contiguous()


def _cuda_args(name, q, k, v, q_seg, kv_seg, *more):
    """Checks shared by the wrappers on the CUDA route, after their shape
    checks; returns the segment ids as contiguous int32 (or None)."""
    if q.device.type != "cuda":
        raise ValueError("%s runs on cuda or cpu tensors, got %s"
                         % (name, q.device))
    D = q.shape[3]
    if D != HEAD_DIM:
        raise ValueError("the CUDA %s kernel is built for head_dim %d, got %d"
                         % (name, HEAD_DIM, D))
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("the CUDA %s kernel takes float32 or bfloat16, got "
                         "%s" % (name, q.dtype))
    segs = () if q_seg is None else (q_seg, kv_seg)
    if any(t.device != q.device for t in (k, v, *segs, *more)):
        raise ValueError("%s inputs must share one device" % name)
    if q_seg is None:
        return None, None
    return (q_seg.to(torch.int32).contiguous(),
            kv_seg.to(torch.int32).contiguous())


def _launch(name, *args):
    rc = _kernel(name)(*args)
    if rc != 0:
        raise RuntimeError("%s kernel launch failed (cudaError %d)"
                           % (name, rc))


def _ptr(t):
    return None if t is None else t.data_ptr()


def flash_fwd(q, k, v, q_seg=None, kv_seg=None, causal: bool = False):
    """Flash-attention forward: ``(out [B, Sq, H, D], lse [B, H, Sq] f32)``
    for q ``[B, Sq, H, D]`` and k/v ``[B, Sk, H, D]`` (f32 or bf16, D = 64
    on CUDA; any strides with d contiguous), optional int32 segment ids
    ``[B, Sq]``/``[B, Sk]``. CPU tensors take :func:`flash_fwd_reference`;
    CUDA tensors launch ``csrc/flash_fwd.cu`` in the design
    :func:`_fwd_variant` picks (each launch adds one to
    ``flash_fwd.launches`` and ``flash_fwd.launches_by_variant``)."""
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, q_seg, kv_seg, causal)
    _check(q, k, v, q_seg, kv_seg)
    q_seg, kv_seg = _cuda_args("flash_fwd", q, k, v, q_seg, kv_seg)
    variant = _fwd_variant(q.dtype)
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if B == 0 or Sq == 0 or H == 0:
        return out, lse
    if Sk == 0:
        raise ValueError("flash_fwd needs at least one key row")
    q, k, v = _kernel_view(q), _kernel_view(k), _kernel_view(v)
    _launch("flash_fwd", VARIANT_CODE[variant], q.data_ptr(), k.data_ptr(),
            v.data_ptr(), _ptr(q_seg), _ptr(kv_seg), out.data_ptr(),
            lse.data_ptr(), B, H, Sq, Sk, D, *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], int(bool(causal)),
            1.0 / math.sqrt(D), torch.cuda.current_stream(q.device).cuda_stream)
    _count(flash_fwd, variant)
    return out, lse


flash_fwd.launches = 0
flash_fwd.launches_by_variant = {}


def _bwd_launch_args(name, q, k, v, do, lse, delta, q_seg, kv_seg):
    """Checked, kernel-readable inputs of a backward launch, or None when
    there is nothing to compute."""
    _check_bwd(q, k, v, do, lse, delta, q_seg, kv_seg)
    q_seg, kv_seg = _cuda_args(name, q, k, v, q_seg, kv_seg, do, lse, delta)
    if q.shape[1] == 0 or k.shape[1] == 0 or q.shape[0] == 0 \
            or q.shape[2] == 0:
        return None
    q, k, v, do = (_kernel_view(t) for t in (q, k, v, do))
    return (q, k, v, do, lse.contiguous(), delta.contiguous(), q_seg, kv_seg)


def _bwd_tail(q, k, v, do, causal):
    B, Sq, H, D = q.shape
    return (B, H, Sq, k.shape[1], D, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *do.stride()[:3], int(bool(causal)),
            1.0 / math.sqrt(D),
            torch.cuda.current_stream(q.device).cuda_stream)


def flash_bwd_dq(q, k, v, do, lse, delta, q_seg=None, kv_seg=None,
                 causal: bool = False):
    """dQ of flash attention (``_dq_kernel``) from the forward's inputs,
    its lse ``[B, H, Sq]`` and delta = rowsum(dO * O) ``[B, H, Sq]`` (both
    f32). CPU tensors take :func:`flash_bwd_dq_reference`; CUDA tensors
    launch ``csrc/flash_bwd.cu``'s dQ kernel in the design
    :func:`_dq_variant` picks (each launch adds one to
    ``flash_bwd_dq.launches`` and ``flash_bwd_dq.launches_by_variant``)."""
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, q_seg, kv_seg,
                                      causal)
    args = _bwd_launch_args("flash_bwd_dq", q, k, v, do, lse, delta, q_seg,
                            kv_seg)
    if args is None:
        return torch.zeros(q.shape, dtype=q.dtype, device=q.device)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)  # every row
    q, k, v, do, lse, delta, q_seg, kv_seg = args
    variant = _dq_variant(q.dtype)
    _launch("flash_bwd_dq", VARIANT_CODE[variant], q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            _ptr(q_seg), _ptr(kv_seg), dq.data_ptr(),
            *_bwd_tail(q, k, v, do, causal))
    _count(flash_bwd_dq, variant)
    return dq


flash_bwd_dq.launches = 0
flash_bwd_dq.launches_by_variant = {}


def flash_bwd_dkdv(q, k, v, do, lse, delta, q_seg=None, kv_seg=None,
                   causal: bool = False):
    """``(dK, dV)`` of flash attention (``_dkdv_kernel``), inputs as
    :func:`flash_bwd_dq`. CPU tensors take
    :func:`flash_bwd_dkdv_reference`; CUDA tensors launch
    ``csrc/flash_bwd.cu``'s dK/dV kernel in the design
    :func:`_dkdv_variant` picks (each launch adds one to
    ``flash_bwd_dkdv.launches`` and ``flash_bwd_dkdv.launches_by_variant``)."""
    if q.device.type == "cpu":
        return flash_bwd_dkdv_reference(q, k, v, do, lse, delta, q_seg,
                                        kv_seg, causal)
    args = _bwd_launch_args("flash_bwd_dkdv", q, k, v, do, lse, delta, q_seg,
                            kv_seg)
    if args is None:
        return (torch.zeros(k.shape, dtype=k.dtype, device=k.device),
                torch.zeros(v.shape, dtype=v.dtype, device=v.device))
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)  # every row
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    q, k, v, do, lse, delta, q_seg, kv_seg = args
    variant = _dkdv_variant(q.dtype)
    _launch("flash_bwd_dkdv", VARIANT_CODE[variant], q.data_ptr(),
            k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), _ptr(q_seg), _ptr(kv_seg), dk.data_ptr(),
            dv.data_ptr(), *_bwd_tail(q, k, v, do, causal))
    _count(flash_bwd_dkdv, variant)
    return dk, dv


flash_bwd_dkdv.launches = 0
flash_bwd_dkdv.launches_by_variant = {}


# the wrappers that count their kernels' launches
COUNTED = (flash_fwd, flash_bwd_dq, flash_bwd_dkdv)


def launch_counts() -> dict:
    """``{wrapper name: {design: launches}}``, a copy."""
    return {fn.__name__: dict(fn.launches_by_variant) for fn in COUNTED}


def set_launch_counts(counts: dict):
    """Set every wrapper's counts to ``counts`` (as
    :func:`launch_counts` gives them)."""
    for fn in COUNTED:
        fn.launches_by_variant = dict(counts.get(fn.__name__, {}))
        fn.launches = sum(fn.launches_by_variant.values())


def add_launch_counts(counts: dict):
    """Add launches the wrappers did not see: those of a replayed CUDA
    graph, which launches the kernels its capture recorded
    (``kernel/superstep.py``)."""
    for fn in COUNTED:
        for variant, n in counts.get(fn.__name__, {}).items():
            fn.launches += n
            fn.launches_by_variant[variant] = \
                fn.launches_by_variant.get(variant, 0) + n


class _FlashAttention(torch.autograd.Function):
    """The JAX ``_flash`` custom_vjp: the forward kernel saves q, k, v, out
    and lse; the backward forms delta in f32 and runs the dQ and dK/dV
    kernels. Segment ids and the causal flag get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, causal):
        out, lse = flash_fwd(q, k, v, q_seg, kv_seg, causal)
        ctx.save_for_backward(q, k, v, out, lse, q_seg, kv_seg)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, q_seg, kv_seg = ctx.saved_tensors
        do = do.to(q.dtype)
        delta = flash_bwd_delta(out, do)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, q_seg, kv_seg, ctx.causal)
        dk, dv = flash_bwd_dkdv(q, k, v, do, lse, delta, q_seg, kv_seg,
                                ctx.causal)
        return dq, dk, dv, None, None, None


def _tileable(q, k, block_q, block_k):
    return bool(_pick_block(q.shape[1], block_q)) and \
        bool(_pick_block(k.shape[1], block_k))


def flash_attention(q, k, v, causal: bool = False, segment_ids=None,
                    block_q: int = 128, block_k: int = 128):
    """Exact fused attention. q,k,v: [B, S, H, D] -> [B, S, H, D].

    ``segment_ids``: [B, S] int (shared q/kv) or a ``(q_seg, kv_seg)``
    pair — attention is allowed iff the ids are equal. Composes with
    ``causal``. The JAX contract holds: a length the JAX kernel cannot
    tile (``_pick_block`` finds no block of at least 8 rows) goes through
    :func:`~autodist_tpu_torch.ops.attention.reference_attention`, whose
    empty rows are a uniform average rather than 0 — the reference's own
    semantics, not a fallback on failure. ``block_q``/``block_k`` only
    decide that; the kernel tiles on its own."""
    if segment_ids is None:
        q_seg = kv_seg = None
    elif isinstance(segment_ids, (tuple, list)):
        q_seg = torch.as_tensor(segment_ids[0], device=q.device).int()
        kv_seg = torch.as_tensor(segment_ids[1], device=q.device).int()
    else:
        q_seg = kv_seg = torch.as_tensor(segment_ids, device=q.device).int()
    if not _tileable(q, k, block_q, block_k):
        from autodist_tpu_torch.ops.attention import reference_attention
        mask = None
        if causal:
            rows = torch.arange(q.shape[1], device=q.device)[:, None]
            cols = torch.arange(k.shape[1], device=q.device)[None, :]
            mask = (rows >= cols)[None, None]
        if q_seg is not None:
            seg_mask = (q_seg[:, :, None] == kv_seg[:, None, :])[:, None]
            mask = seg_mask if mask is None else (mask & seg_mask)
        return reference_attention(q, k, v, mask)
    return _FlashAttention.apply(q, k, v, q_seg, kv_seg, bool(causal))


def make_flash_attn_fn(causal: bool = True, block_q: int = 128,
                       block_k: int = 128):
    """(q, k, v, mask) -> out adapter for model layers' ``attn_fn`` slot.

    A key-padding mask (boolean, [B, 1, 1, S] or [B, S]) becomes segment
    ids (valid=1, pad=0). Arbitrary dense masks are not expressible as
    segments and raise."""
    def attn(q, k, v, mask=None):
        if mask is None:
            return flash_attention(q, k, v, causal, None, block_q, block_k)
        m = torch.as_tensor(mask)
        if m.dim() == 4 and m.shape[1] == 1 and m.shape[2] == 1:
            m = m[:, 0, 0, :]
        elif m.dim() != 2:
            raise ValueError(
                "flash attention supports key-padding masks ([B, S] or "
                "[B, 1, 1, S]) via segment ids; got mask shape %s"
                % (tuple(mask.shape),))
        return flash_attention(q, k, v, causal, m.int(), block_q, block_k)
    return attn
