"""Shared model layers (PyTorch counterpart of ``autodist_tpu/models/layers.py``).

The modules mirror flax's: parameters stay float32 and each layer casts
them to its compute ``dtype`` (flax ``param_dtype`` vs ``dtype``), layer
norms use flax's epsilon 1e-6 with float32 statistics, and the MLP uses
the tanh GELU (flax ``nn.gelu`` defaults to ``approximate=True``).
Submodules carry flax's names (``LayerNorm_0``, ``MultiHeadAttention_0``,
``Dense_0``, ...) so ``convert.params_from_jax`` maps names one to one.

Modules are built on the ``meta`` device and applied with
``torch.func.functional_call`` over a ``{name: tensor}`` params mapping —
the counterpart of flax's ``model.apply(params, ...)``.
"""
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn


def causal_mask(seq_len: int, device=None) -> torch.Tensor:
    return torch.tril(torch.ones((1, 1, seq_len, seq_len), dtype=torch.bool,
                                 device=device))


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape), requires_grad=False)


def lecun_normal_(t: torch.Tensor, fan_in: int, gen: torch.Generator):
    """flax's default kernel init (``lecun_normal``): a normal truncated at
    two standard deviations, scaled so that the variance is 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                 generator=gen)


class Dense(nn.Module):
    """flax ``nn.Dense``/``DenseGeneral`` over the flattened feature axes:
    ``weight [out, in]`` and ``bias [out]`` in float32, computed in
    ``dtype``."""

    def __init__(self, in_features: int, out_features: int,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = _param(out_features, in_features)
        self.bias = _param(out_features)

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: epsilon 1e-6, float32 statistics, output in
    ``dtype``."""

    EPS = 1e-6

    def __init__(self, features: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = _param(features)
        self.bias = _param(features)

    def forward(self, x):
        return F.layer_norm(x.float(), (x.shape[-1],), self.weight.float(),
                            self.bias.float(), self.EPS).to(self.dtype)


class SparseEmbed(nn.Module):
    """Embedding table lookup (``embedding [num, features]``) cast to
    ``dtype``. The JAX layer routes the lookup through a named tap for the
    sparse gradient wire; the port's slice has dense variables only, so
    this is a plain lookup."""

    def __init__(self, num_embeddings: int, features: int,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.embedding = _param(num_embeddings, features)

    def forward(self, ids):
        return F.embedding(ids.long(), self.embedding).to(self.dtype)


class MultiHeadAttention(nn.Module):
    """Standard MHA with an injectable attention implementation, in the
    JAX layer's three modes:

    - training/eval (default): full-sequence attention, optionally
      through ``attn_fn``;
    - prefill (``return_kv=True``): same, also returning the projected
      ``(k, v)`` [B, S, H, D] to seed a decode cache;
    - decode (``cache=(k_cache, v_cache)`` + ``cursor``): x is [B, 1, d];
      the new K/V row is written at ``cursor`` (gated by ``alive`` so dead
      slots never change their cache) and attention runs against the
      live prefix via ``ops.attention.cached_attention``, or the flash
      kernel when ``decode_attn="flash"``. The JAX layer returns new
      caches; this one writes the row into the given caches IN PLACE
      and returns them.
    """

    def __init__(self, d_model: int, num_heads: int, head_dim: int,
                 dtype=torch.float32, attn_fn: Optional[Callable] = None,
                 decode_attn: str = "reference"):
        super().__init__()
        if decode_attn not in ("reference", "flash"):
            raise ValueError("decode_attn must be 'reference' or 'flash', "
                             "got %r" % (decode_attn,))
        self.num_heads, self.head_dim = num_heads, head_dim
        self.dtype = dtype
        self.attn_fn = attn_fn
        self.decode_attn = decode_attn
        width = num_heads * head_dim
        self.query = Dense(d_model, width, dtype)
        self.key = Dense(d_model, width, dtype)
        self.value = Dense(d_model, width, dtype)
        self.out = Dense(width, d_model, dtype)

    def flax_shapes(self) -> dict:
        """flax's shapes of the projections, DenseGeneral over the heads:
        q/k/v kernels ``[d, H, D]`` and biases ``[H, D]``, the ``out``
        kernel ``[H, D, d]``."""
        d, heads = self.out.weight.shape[0], (self.num_heads, self.head_dim)
        out = {"out.weight": heads + (d,)}
        for proj in ("query", "key", "value"):
            out[proj + ".weight"] = (d,) + heads
            out[proj + ".bias"] = heads
        return out

    def forward(self, x, mask=None, cache=None, cursor=None, alive=None,
                return_kv=False):
        B, S = x.shape[0], x.shape[1]
        heads = (B, S, self.num_heads, self.head_dim)
        q = self.query(x).view(heads)
        k = self.key(x).view(heads)
        v = self.value(x).view(heads)
        new_cache = None
        if cache is not None:
            from autodist_tpu_torch.ops.attention import (
                cached_attention, flash_cached_attention)
            if cursor is None:
                raise ValueError("decode mode needs a cursor with the cache")
            k_cache, v_cache = cache
            T = k_cache.shape[1]
            cur = cursor.long()
            # the JAX layer's one-hot write: a cursor outside [0, T) or a
            # dead slot writes nothing (the row keeps its own value)
            write = (cur >= 0) & (cur < T)
            if alive is not None:
                write = write & alive.bool()
            rows = cur.clamp(0, T - 1)
            slot = torch.arange(B, device=x.device)
            sel = write[:, None, None]
            k_cache[slot, rows] = torch.where(
                sel, k[:, 0].to(k_cache.dtype), k_cache[slot, rows])
            v_cache[slot, rows] = torch.where(
                sel, v[:, 0].to(v_cache.dtype), v_cache[slot, rows])
            attn = (flash_cached_attention if self.decode_attn == "flash"
                    else cached_attention)
            out = attn(q[:, 0], k_cache, v_cache, cursor)[:, None]
            new_cache = (k_cache, v_cache)
        elif self.attn_fn is not None:
            out = self.attn_fn(q, k, v, mask)
        else:
            # float32 logits: the JAX layer scales by a numpy float64
            # scalar, which promotes a bfloat16 product to float32
            scale = 1.0 / math.sqrt(self.head_dim)
            logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
            if mask is not None:
                logits = torch.where(mask, logits,
                                     torch.finfo(logits.dtype).min)
            weights = torch.softmax(logits, dim=-1).to(self.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", weights, v)
        out = self.out(out.reshape(B, S, self.num_heads * self.head_dim))
        if cache is not None:
            return out, new_cache
        if return_kv:
            return out, (k, v)
        return out


class TransformerBlock(nn.Module):
    """Pre-LN transformer block: x + MHA(LN(x)), then x + MLP(LN(x))."""

    # a repeated block: remat recomputes each one on its own
    recompute_unit = True

    def __init__(self, d_model: int, num_heads: int, head_dim: int,
                 mlp_dim: int, dtype=torch.float32,
                 attn_fn: Optional[Callable] = None,
                 decode_attn: str = "reference"):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(d_model, dtype)
        self.MultiHeadAttention_0 = MultiHeadAttention(
            d_model, num_heads, head_dim, dtype, attn_fn, decode_attn)
        self.LayerNorm_1 = LayerNorm(d_model, dtype)
        self.Dense_0 = Dense(d_model, mlp_dim, dtype)
        self.Dense_1 = Dense(mlp_dim, d_model, dtype)

    def forward(self, x, mask=None, cache=None, cursor=None, alive=None,
                return_kv=False):
        kv = None
        h = self.MultiHeadAttention_0(self.LayerNorm_0(x), mask, cache=cache,
                                      cursor=cursor, alive=alive,
                                      return_kv=return_kv)
        if cache is not None or return_kv:
            h, kv = h
        x = x + h
        h = self.Dense_1(F.gelu(self.Dense_0(self.LayerNorm_1(x)),
                                approximate="tanh"))
        x = x + h
        if cache is not None or return_kv:
            return x, kv
        return x


def flax_shapes(model: nn.Module) -> dict:
    """``{param name: flax shape}`` of the leaves of ``model`` that flax
    shapes otherwise than ``convert.flax_shape``'s generic rule: its
    attention projections (:meth:`MultiHeadAttention.flax_shapes`)."""
    out = {}
    for prefix, mod in model.named_modules():
        if isinstance(mod, MultiHeadAttention):
            out.update({"%s.%s" % (prefix, k): v
                        for k, v in mod.flax_shapes().items()})
    return out


def apply(module: nn.Module, params: dict, *args, **kwargs):
    """flax-style ``model.apply(params, *args, **kwargs)``: run ``module``
    with the ``{name: tensor}`` mapping as its parameters
    (``torch.func.functional_call``, strict). The call swaps the module's
    parameters for its duration, so calls on one module are serialized
    through the module's ``apply_lock``."""
    with module.apply_lock:
        return torch.func.functional_call(module, params, args, kwargs,
                                          strict=True)
