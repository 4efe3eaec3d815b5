"""Attention ops (PyTorch counterpart of ``autodist_tpu/ops/attention.py``).

The reference paths and the decode-shape attention against a KV cache.
The sequence-parallel ring/Ulysses variants are a later slice.
"""
import math

import torch


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

