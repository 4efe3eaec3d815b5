"""Attention ops (PyTorch counterpart of ``autodist_tpu/ops/attention.py``).

The reference paths, the decode-shape attention against a KV cache, and
the sequence-parallel variants, which run with the sequence dimension
sharded over the ``seq`` mesh axis (``parallel/mesh.py``):

- :func:`ring_attention`: blockwise attention with the online
  (flash-style) softmax; the K/V blocks rotate around the ring, one
  ``ppermute`` of K and V together a rotation, N - 1 rotations (Liu et
  al., Ring Attention, arXiv 2310.01889);
- :func:`ulysses_attention`: an all-to-all from seq-sharded to
  head-sharded, full-sequence attention on H/N heads, and an all-to-all
  back (DeepSpeed Ulysses, arXiv 2309.14509).

Both are exact, and plain PyTorch as the JAX functions are plain XLA
(einsums and a softmax, no Pallas kernel). Inputs are this rank's chunks
``[B, C, H, D]``, chunk r holding global positions ``[r*C, (r+1)*C)``.
Unbound (one process, tracing) each computes the one-rank function: the
chunk is the whole sequence.
"""
import math
from typing import List, Optional

import torch

from autodist_tpu_torch import const
from autodist_tpu_torch.parallel import mesh


def reference_attention(q, k, v, mask=None):
    """Plain softmax attention. [B, S, H, D] -> [B, S, H, D].
    mask: broadcastable to [B, H, Sq, Sk], True = attend. The softmax runs
    in f32, and its weights are cast back to the input dtype before the
    second product (as in the JAX function). As there, the logits are
    float32 whatever the input dtype: the JAX function scales by a numpy
    float64 scalar, which promotes a bfloat16 product to float32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if mask is not None:
        logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
    weights = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def cached_attention(q, k_cache, v_cache, cursor):
    """Decode-shape attention against a KV cache (continuous batching).

    ``q`` [B, H, D] is the current token's query, ``k_cache``/``v_cache``
    [B, T, H, D] the slot caches, ``cursor`` [B] the row the current token
    was written to. Rows ``<= cursor`` are live; later rows hold garbage
    from evicted sequences and are masked out, which is what makes slot
    reuse safe without zeroing the cache. Logits are float32 (the JAX
    function's numpy-scalar promotion), the softmax runs in float32 and
    its weights are cast back to the input dtype before the second
    product."""
    T = k_cache.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bhd,bthd->bht", q, k_cache).float() * scale
    mask = (torch.arange(T, device=q.device)[None, None, :]
            <= cursor.to(q.device)[:, None, None])
    logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
    weights = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bht,bthd->bhd", weights, v_cache)


def flash_cached_attention(q, k_cache, v_cache, cursor):
    """Decode-shape attention through the flash-attention kernel
    (``ops/flash_attention.flash_fwd``).

    The cursor mask is expressed as segment ids, as in the JAX function
    (the query gets segment 1; cache rows ``<= cursor`` get 1, dead rows
    0). The JAX kernel tiles query blocks of at least 8 rows, so the JAX
    function broadcasts the query to 8 rows and keeps row 0; this kernel
    masks ragged edges itself, so the one query goes in as Sq = 1 — the
    same result as the JAX function's row 0. The kernel skips every kv
    tile past a slot's cursor, so a slot reads only its live prefix, and
    it reads ``k_cache``/``v_cache`` through their strides (a layer's view
    of the layer-stacked cache is not copied)."""
    from autodist_tpu_torch.ops.flash_attention import flash_fwd
    B, T = k_cache.shape[0], k_cache.shape[1]
    q_seg = torch.ones((B, 1), dtype=torch.int32, device=q.device)
    kv_seg = (torch.arange(T, device=q.device)[None, :]
              <= cursor.to(q.device)[:, None]).int()
    out, _ = flash_fwd(q[:, None], k_cache, v_cache, q_seg, kv_seg,
                       causal=False)
    return out[:, 0]



def _block_update(q, k_blk, v_blk, acc, m, l, blk_mask, scale):
    """One online-softmax accumulation step (the flash-attention
    recurrence), the JAX function's numerics: the q-k product in the input
    dtype, then float32; masked logits ``-inf``, and the guards that keep
    a row with no live key yet at ``m = -inf`` finite (and its gradient
    zero); P·V in float32."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k_blk).float() * scale
    if blk_mask is not None:
        logits = torch.where(blk_mask, logits, -math.inf)
    m_blk = logits.amax(dim=-1)
    m_new = torch.maximum(m, m_blk)
    # rows with no allowed keys yet keep m = -inf; guard the exp
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    p = torch.exp(logits - m_safe[..., None])
    p = torch.where(torch.isfinite(logits), p, 0.0)
    corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum(
        "bhqk,bkhd->bhqd", p, v_blk.float())
    return acc_new, m_new, l_new


def _ring_blocks(q, kv, b, causal, keep: bool):
    """The ring's forward: N block updates, N - 1 rotations of the stacked
    ``kv`` ``[2, B, C, H, D]`` (the last block updates without the
    trailing rotation, whose result nothing reads). Returns the output
    and, with ``keep``, the block each step held, as a leaf of the kept
    graph."""
    n, r = (1, 0) if b is None else (b.size, b.index)
    B, C, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    q_pos = r * C + torch.arange(C, device=dev)
    acc = torch.zeros((B, H, C, D), dtype=torch.float32, device=dev)
    m = torch.full((B, H, C), -math.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, C), dtype=torch.float32, device=dev)
    perm = [(i, (i + 1) % n) for i in range(n)]
    held: List[torch.Tensor] = []
    for t in range(n):
        blk = kv.detach().requires_grad_() if keep else kv
        held.append(blk)
        # after t forward rotations this rank holds rank r - t's block
        src = (r - t) % n
        mask = None
        if causal:
            k_pos = src * C + torch.arange(C, device=dev)
            mask = (q_pos[:, None] >= k_pos[None, :])[None, None]
        acc, m, l = _block_update(q, blk[0], blk[1], acc, m, l, mask, scale)
        if t < n - 1:
            kv = mesh._permute(kv, perm, kv, b)
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return torch.einsum("bhqd->bqhd", out).to(q.dtype), held


class _Ring(torch.autograd.Function):
    """Ring attention as one autograd function: the forward keeps each
    block step's graph (its block a leaf), the backward takes every local
    gradient at once, then walks the rotations in reverse, moving the
    accumulated K/V cotangent one hop back a rotation (the transpose of
    the forward's ppermutes). Every rank issues the same N - 1 moves in
    the same order, whatever the autograd engine's readiness order."""

    @staticmethod
    def forward(ctx, q, k, v, b, causal):
        with torch.enable_grad():
            q_ = q.detach().requires_grad_(q.requires_grad)
            out, held = _ring_blocks(q_, torch.stack([k, v]).detach(), b,
                                     causal, keep=True)
        ctx.q, ctx.out, ctx.held, ctx.b = q_, out, held, b
        return out.detach()

    @staticmethod
    def backward(ctx, grad):
        b, held = ctx.b, ctx.held
        inputs = ([ctx.q] if ctx.q.requires_grad else []) + held
        gs = torch.autograd.grad(ctx.out, inputs, grad, allow_unused=True)
        dq = gs[0] if ctx.q.requires_grad else None
        dkv = [g if g is not None else torch.zeros_like(h)
               for g, h in zip(gs[len(gs) - len(held):], held)]
        n = len(held)
        back = mesh._inverse([(i, (i + 1) % n) for i in range(n)])
        g = dkv[n - 1]
        for t in range(n - 1, 0, -1):
            g = mesh._permute(g, back, g, b) + dkv[t - 1]
        ctx.q = ctx.out = ctx.held = None
        return dq, g[0], g[1], None, None


def ring_attention(q, k, v, axis_name: str = const.SEQUENCE_AXIS,
                   causal: bool = False):
    """Exact attention over a sequence sharded along ``axis_name``.

    q, k, v: this rank's chunks [B, C, H, D] (C = global_seq / axis
    size). Returns this rank's output chunk. Under ``causal`` a block
    whose keys all lie after this rank's queries is computed fully masked
    (``-inf``), as in the JAX function."""
    b = mesh.binding(axis_name)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        return _Ring.apply(q, k, v, b, causal)
    return _ring_blocks(q, torch.stack([k, v]), b, causal, keep=False)[0]


def ulysses_attention(q, k, v, axis_name: str = const.SEQUENCE_AXIS,
                      causal: bool = False,
                      mask: Optional[torch.Tensor] = None):
    """Ulysses sequence parallelism: an all-to-all from seq-sharded to
    head-sharded, full-sequence :func:`reference_attention` on H/N heads,
    an all-to-all back. Needs H % axis size == 0. Q, K and V move as one
    payload (one all-to-all, where the JAX function makes three of the
    same bytes)."""
    b = mesh.binding(axis_name)
    n = 1 if b is None else b.size
    H = q.shape[2]
    if H % n != 0:
        raise ValueError("ulysses needs heads %% axis_size == 0 (H=%d)" % H)
    # [3, B, C, H, D] -> [3, B, S, H/N, D]
    qg, kg, vg = mesh.all_to_all(torch.stack([q, k, v]), axis_name,
                                 split_axis=3, concat_axis=2).unbind(0)
    S = qg.shape[1]
    attn_mask = mask
    if causal:
        cm = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        cm = cm[None, None]
        attn_mask = cm if attn_mask is None else (attn_mask & cm)
    out = reference_attention(qg, kg, vg, attn_mask)
    return mesh.all_to_all(out, axis_name, split_axis=1, concat_axis=2)


def make_attn_fn(kind: str = "ring", axis_name: str = const.SEQUENCE_AXIS,
                 causal: bool = False):
    """An attention implementation for a model layer's ``attn_fn(q, k, v,
    mask)`` slot: ``ring``, ``ulysses``, ``flash`` (the single-device
    kernels, ``ops/flash_attention.make_flash_attn_fn``) or
    ``reference``."""
    if kind == "ring":
        def ring_fn(q, k, v, mask=None):
            if mask is not None:
                # silently dropping the model's padding mask would let
                # every token attend PAD positions with no error
                raise ValueError(
                    "ring attention cannot apply a dense mask (the K/V "
                    "blocks rotate); use kind='ulysses' (full-sequence "
                    "attention per head group honors masks) or pack "
                    "sequences without padding")
            return ring_attention(q, k, v, axis_name, causal=causal)
        return ring_fn
    if kind == "ulysses":
        return lambda q, k, v, mask=None: ulysses_attention(
            q, k, v, axis_name, causal=causal, mask=mask)
    if kind == "flash":
        from autodist_tpu_torch.ops.flash_attention import make_flash_attn_fn
        return make_flash_attn_fn(causal=causal)
    if kind == "reference":
        return lambda q, k, v, mask=None: reference_attention(q, k, v, mask)
    raise ValueError("unknown attention kind %r" % kind)
