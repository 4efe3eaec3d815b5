"""Flash attention: exact fused attention through a hand-written CUDA
kernel for Hopper.

PyTorch counterpart of ``autodist_tpu/ops/flash_attention.py``. The JAX
module holds three Pallas kernels; this slice ports the forward:

- :func:`flash_fwd` wraps ``csrc/flash_fwd.cu`` (sm_90a), which replaces
  ``autodist_tpu/ops/flash_attention.py::_fwd_kernel``. It computes the
  online-softmax forward and the per-row log-sum-exp, with the causal flag,
  optional ``(q_seg, kv_seg)`` segment ids, ``NEG_INF = -1e30`` masking and
  the empty-row rule (a row with no visible key gives 0 and lse 0). Decode
  is bound by bytes: it reads each live K/V row once — 33.5 MB a layer at
  32 slots x 256 rows x 16 heads x 64 dims in bf16, about 10 us at
  3.35 TB/s — and the kernel skips tiles past every row's cursor.
- :func:`flash_fwd_reference` is its plain PyTorch version: the same tile
  loop (64 kv rows a tile) in f32, the same masks and empty-row rule.

The wrapper takes the plain version only for CPU tensors. For CUDA tensors
it launches the kernel or raises; nothing falls back. The backward kernels
(``_dq_kernel``, ``_dkdv_kernel``) come with the training slice, so the
port's :func:`flash_attention` is forward-only for now.

Layout: ``[batch, seq, heads, head_dim]``; segment ids ``[batch, seq]``.
"""
import ctypes
import math

import torch

NEG_INF = -1e30    # finite stand-in for -inf, as in the TPU kernel
HEAD_DIM = 64      # the head width the CUDA kernel is compiled for
BLOCK_K = 64       # kv rows per tile, in the kernel and its plain version


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
        raise ValueError("flash_fwd takes [B, S, H, D] q, k, v; got %s %s %s"
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
    rows = torch.arange(Sq, device=dev)[:, None]
    for k0 in range(0, Sk, BLOCK_K):
        kb = kt[:, :, k0:k0 + BLOCK_K].float()
        vb = vt[:, :, k0:k0 + BLOCK_K]
        s = torch.matmul(qf, kb.transpose(-1, -2)) * scale  # [B, H, Sq, bk]
        mask = torch.ones(s.shape[-2:], dtype=torch.bool, device=dev)
        if causal:
            cols = torch.arange(k0, k0 + kb.shape[2], device=dev)[None, :]
            mask = rows >= cols
        if q_seg is not None:
            mask = mask & (q_seg[:, None, :, None]
                           == kv_seg[:, None, None, k0:k0 + kb.shape[2]])
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
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


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _kernel():
    """The built library with its C signature declared (first use builds
    ``csrc/flash_fwd.cu`` with nvcc)."""
    global _lib
    if _lib is None:
        from autodist_tpu_torch.utils import cuda_build
        lib = cuda_build.load("flash_fwd")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.adt_flash_fwd.argtypes = ([i] + [p] * 7 + [i] * 5 + [ll] * 9
                                      + [i, ctypes.c_float, p])
        lib.adt_flash_fwd.restype = i
        _lib = lib
    return _lib


def _kernel_view(x):
    """``x`` if the kernel can read it in place (d contiguous, rows 16-byte
    aligned), else a contiguous copy."""
    es = x.element_size()
    ok = (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
          and all((s * es) % 16 == 0 for s in x.stride()[:3]))
    return x if ok else x.contiguous()


def flash_fwd(q, k, v, q_seg=None, kv_seg=None, causal: bool = False):
    """Flash-attention forward: ``(out [B, Sq, H, D], lse [B, H, Sq] f32)``
    for q ``[B, Sq, H, D]`` and k/v ``[B, Sk, H, D]`` (f32 or bf16, D = 64
    on CUDA; any strides with d contiguous), optional int32 segment ids
    ``[B, Sq]``/``[B, Sk]``. CPU tensors take :func:`flash_fwd_reference`;
    CUDA tensors launch ``csrc/flash_fwd.cu`` (each launch adds one to
    ``flash_fwd.launches``)."""
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, q_seg, kv_seg, causal)
    if q.device.type != "cuda":
        raise ValueError("flash_fwd runs on cuda or cpu tensors, got %s"
                         % q.device)
    _check(q, k, v, q_seg, kv_seg)
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if D != HEAD_DIM:
        raise ValueError("the CUDA flash_fwd kernel is built for head_dim "
                         "%d, got %d" % (HEAD_DIM, D))
    if q.dtype not in _DTYPE_CODE:
        raise ValueError("the CUDA flash_fwd kernel takes float32 or "
                         "bfloat16, got %s" % q.dtype)
    if any(t.device != q.device for t in (k, v)) or (
            q_seg is not None and (q_seg.device != q.device
                                   or kv_seg.device != q.device)):
        raise ValueError("flash_fwd inputs must share one device")
    if q_seg is not None:
        q_seg = q_seg.to(torch.int32).contiguous()
        kv_seg = kv_seg.to(torch.int32).contiguous()
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if B == 0 or Sq == 0 or H == 0:
        return out, lse
    if Sk == 0:
        raise ValueError("flash_fwd needs at least one key row")
    q, k, v = _kernel_view(q), _kernel_view(k), _kernel_view(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _kernel().adt_flash_fwd(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        q_seg.data_ptr() if q_seg is not None else None,
        kv_seg.data_ptr() if kv_seg is not None else None,
        out.data_ptr(), lse.data_ptr(), B, H, Sq, Sk, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        int(bool(causal)), 1.0 / math.sqrt(D), stream)
    if rc != 0:
        raise RuntimeError("flash_fwd kernel launch failed (cudaError %d)"
                           % rc)
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0


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
    return flash_fwd(q, k, v, q_seg, kv_seg, causal)[0]


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
