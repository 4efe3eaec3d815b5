"""Decoder-only language model, the lm1b family (PyTorch counterpart of
``autodist_tpu/models/lm.py``).

Same architecture and the same numerics contract as the flax model: an
untied token embedding and ``lm_head``, learned positions, pre-LN blocks,
a float32 ``lm_head``. One detail of the JAX model that the port keeps:
``x * np.sqrt(d_model)`` promotes the embedding to float32 (a numpy
scalar is not weakly typed in JAX), so the residual stream is float32 in
every ``dtype`` while the layers compute in ``dtype``.

Parameters are a flat ``{name: tensor}`` mapping; :func:`make_train_setup`
initializes one from a seeded ``torch.Generator`` (the values differ from
flax's initializers — tests feed both packages the same numbers through
``convert.params_from_jax``).
"""
import dataclasses
import math
import threading
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from autodist_tpu_torch.convert import FlaxParams
from autodist_tpu_torch.models.layers import (Dense, LayerNorm, SparseEmbed,
                                              TransformerBlock, apply,
                                              causal_mask, flax_shapes)
from autodist_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class LMConfig:
    vocab_size: int = 32000
    d_model: int = 512
    num_layers: int = 6
    num_heads: int = 8
    mlp_dim: int = 2048
    max_seq_len: int = 256
    dtype: Any = torch.float32

    @classmethod
    def lm1b(cls, **kw):
        return cls(vocab_size=793470 // 8, d_model=1024, num_layers=8,
                   num_heads=16, mlp_dim=4096, **kw)

    @classmethod
    def tiny(cls, **kw):
        return cls(vocab_size=128, d_model=32, num_layers=2, num_heads=2,
                   mlp_dim=64, max_seq_len=64, **kw)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


class TransformerLM(nn.Module):
    """The lm1b transformer. ``forward(*args, method=...)`` dispatches to
    :meth:`logits` (default), :meth:`hidden`, :meth:`prefill` or
    :meth:`decode_step`, so ``layers.apply(model, params, ...,
    method="prefill")`` reads like flax's ``model.apply(params, ...,
    method=TransformerLM.prefill)``."""

    def __init__(self, config: LMConfig, attn_fn=None,
                 decode_attn: str = "reference", seq_parallel: bool = False):
        super().__init__()
        cfg = self.config = config
        self.attn_fn = attn_fn
        # offset positions by the seq shard (parallel/sequence.py)
        self.seq_parallel = seq_parallel
        self.apply_lock = threading.Lock()
        self.embed = SparseEmbed(cfg.vocab_size, cfg.d_model, cfg.dtype)
        self.pos_embed = SparseEmbed(cfg.max_seq_len, cfg.d_model, cfg.dtype)
        for i in range(cfg.num_layers):
            self.add_module("layer_%d" % i, TransformerBlock(
                cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.mlp_dim,
                cfg.dtype, attn_fn, decode_attn))
        self.final_ln = LayerNorm(cfg.d_model, cfg.dtype)
        self.lm_head = Dense(cfg.d_model, cfg.vocab_size, torch.float32)

    def _blocks(self):
        return [getattr(self, "layer_%d" % i)
                for i in range(self.config.num_layers)]

    def forward(self, *args, method: str = "logits"):
        if method not in ("logits", "hidden", "prefill", "decode_step"):
            raise ValueError("unknown TransformerLM method %r" % (method,))
        return getattr(self, method)(*args)

    def _embed(self, ids, positions):
        x = self.embed(ids).float() * math.sqrt(self.config.d_model)
        return x + self.pos_embed(positions)

    def hidden(self, input_ids):
        """Final-layer-norm hidden states [B, S, d]; under
        ``seq_parallel`` ``S`` is the local chunk and positions start at
        the shard's offset. With an ``attn_fn`` the causal structure is
        the attention's own (a local mask would be wrong)."""
        seq_len = input_ids.shape[-1]
        positions = torch.arange(seq_len, device=input_ids.device)
        if self.seq_parallel:
            from autodist_tpu_torch.parallel import sequence
            positions = positions + sequence.position_offset(seq_len)
        x = self._embed(input_ids, positions[None])
        mask = (None if self.attn_fn is not None
                else causal_mask(seq_len, input_ids.device))
        for block in self._blocks():
            x = block(x, mask)
        return self.final_ln(x)

    def logits(self, input_ids):
        return self.lm_head(self.hidden(input_ids))

    def prefill(self, input_ids, length):
        """Prompt pass seeding a decode KV cache: ``input_ids`` [B, P]
        right-padded prompts, ``length`` [B] real lengths. Returns the
        last-real-position logits [B, vocab] and per-layer K/V caches
        [B, layers, max_seq_len, heads, head_dim] in ``dtype``."""
        cfg = self.config
        seq_len = input_ids.shape[-1]
        dev = input_ids.device
        x = self._embed(input_ids, torch.arange(seq_len, device=dev)[None])
        mask = None if self.attn_fn is not None else causal_mask(seq_len, dev)
        ks, vs = [], []
        for block in self._blocks():
            x, (k, v) = block(x, mask, return_kv=True)
            pad = (0, 0, 0, 0, 0, cfg.max_seq_len - seq_len)
            ks.append(F.pad(k, pad))
            vs.append(F.pad(v, pad))
        x = self.final_ln(x)
        idx = (length.long() - 1).clamp(0, seq_len - 1)
        last = x[torch.arange(x.shape[0], device=dev), idx]
        return self.lm_head(last), torch.stack(ks, 1), torch.stack(vs, 1)

    def decode_step(self, token_ids, k_cache, v_cache, cursor, alive=None):
        """One cached decode step: ``token_ids`` [B], caches [B, layers,
        max_seq_len, heads, head_dim], ``cursor`` [B] the row each token
        writes, ``alive`` [B] gating cache writes. Returns next-token
        logits [B, vocab] and the caches, updated in place. Positions are
        clipped to the table, as in the JAX model (``jnp.take`` would
        fill out-of-range rows silently; ``F.embedding`` raises)."""
        cfg = self.config
        x = self._embed(token_ids[:, None],
                        cursor.long().clamp(0, cfg.max_seq_len - 1)[:, None])
        for i, block in enumerate(self._blocks()):
            x, _ = block(x, cache=(k_cache[:, i], v_cache[:, i]),
                         cursor=cursor, alive=alive)
        x = self.final_ln(x)
        return self.lm_head(x[:, 0]), k_cache, v_cache


def init_params(config: LMConfig, seed: int = 0) -> dict:
    """A float32 :class:`~autodist_tpu_torch.convert.FlaxParams` init
    (``{name: tensor}`` with the attention projections' flax shapes) on
    the CPU from a seeded ``torch.Generator``: normal weights with std
    1/sqrt(fan_in) (tables: 1/sqrt(features)), zero biases, unit
    layer-norm scales."""
    with torch.device("meta"):
        model = TransformerLM(config)
    names = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    gen = torch.Generator().manual_seed(int(seed))
    params = {}
    for name, shape in names:
        if name.endswith("bias"):
            t = torch.zeros(shape)
        elif ".LayerNorm_" in name or name.startswith("final_ln"):
            t = torch.ones(shape)
        else:
            t = torch.randn(shape, generator=gen) / math.sqrt(shape[1])
        params[name] = t
    return FlaxParams(params, flax_shapes=flax_shapes(model))


def make_model(config: LMConfig, attn_fn=None,
               decode_attn: str = "reference",
               seq_parallel: bool = False) -> TransformerLM:
    """A parameterless (``meta``) model to apply params through."""
    with torch.device("meta"):
        return TransformerLM(config, attn_fn=attn_fn, decode_attn=decode_attn,
                             seq_parallel=seq_parallel)


def make_train_setup(config: Optional[LMConfig] = None, seq_len: int = 128,
                     batch_size: int = 32, seed: int = 0,
                     attention: str = "auto", lean_head="auto"):
    """``(loss_fn, params, example_batch, apply_fn)`` as in the JAX module.

    ``attention``: "flash" routes every layer through the flash kernels
    (forward and both backward kernels); "auto" and "default" use the
    reference attention. The JAX "auto" switch to flash at seq >= 8192
    was measured on a TPU; the port sets its own switch from H100 runs
    later. ``lean_head``: True routes the loss through the chunked
    cross-entropy (``ops.xent.chunked_softmax_xent``) on the hidden
    states, so the [tokens, vocab] f32 logits never materialize; "auto"
    (default) engages it at vocab >= 32768. Same math to float
    tolerance."""
    from autodist_tpu_torch.ops.flash_attention import make_flash_attn_fn
    from autodist_tpu_torch.ops.xent import chunked_softmax_xent
    cfg = config or LMConfig()
    if lean_head == "auto":
        lean_head = cfg.vocab_size >= 32768
    elif not isinstance(lean_head, bool):
        raise ValueError("lean_head must be True, False or 'auto', got %r"
                         % (lean_head,))
    if seq_len > cfg.max_seq_len:
        raise ValueError("seq_len %d exceeds config.max_seq_len %d"
                         % (seq_len, cfg.max_seq_len))
    if attention not in ("auto", "flash", "default"):
        raise ValueError("attention must be auto|flash|default, got %r"
                         % attention)
    attn_fn = make_flash_attn_fn(causal=True) if attention == "flash" else None
    model = make_model(cfg, attn_fn=attn_fn)
    params = init_params(cfg, seed)

    def loss_fn(params, batch):
        tokens = torch.as_tensor(batch["tokens"])
        targets = tokens[:, 1:].long()
        if lean_head:
            h = apply(model, params, tokens[:, :-1], method="hidden")
            # the port's Dense weight is [out, in]; the chunked head takes
            # the JAX kernel layout [in, out], read in place through .t()
            nll = chunked_softmax_xent(
                h.reshape(-1, cfg.d_model),
                params["lm_head.weight"].float().t(),
                params["lm_head.bias"].float(), targets.reshape(-1))
            return nll.mean()
        logits = apply(model, params, tokens[:, :-1])
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
        return nll.mean()

    npr = np.random.RandomState(seed)
    example_batch = {"tokens": npr.randint(
        0, cfg.vocab_size, (batch_size, seq_len + 1)).astype(np.int32)}

    def apply_fn(p, ids):
        return apply(model, p, torch.as_tensor(ids))
    return loss_fn, params, example_batch, apply_fn


def make_sp_train_setup(config: Optional[LMConfig] = None,
                        seq_len: int = 128, batch_size: int = 32,
                        seed: int = 0, attention: str = "ring"):
    """The sequence-parallel train setup (the JAX ``make_sp_train_setup``):
    tokens arrive ``[B, S]`` with S sharded over the ``seq`` mesh axis
    (``strategy.SequenceParallelAR``); attention runs ring or Ulysses
    (``ops.attention.make_attn_fn``, causal); next-token targets cross
    shard boundaries through ``sequence.shift_left``; the final global
    position is masked out with the SP-exact weighted mean."""
    from autodist_tpu_torch import const
    from autodist_tpu_torch.ops.attention import make_attn_fn
    from autodist_tpu_torch.parallel import sequence

    cfg = config or LMConfig()
    if seq_len > cfg.max_seq_len:
        raise ValueError("seq_len %d exceeds config.max_seq_len %d"
                         % (seq_len, cfg.max_seq_len))
    attn_fn = make_attn_fn(attention, const.SEQUENCE_AXIS, causal=True)
    model = make_model(cfg, seq_parallel=True)
    sp_model = make_model(cfg, attn_fn=attn_fn, seq_parallel=True)
    params = init_params(cfg, seed)

    def loss_fn(params, batch):
        tokens = torch.as_tensor(batch["tokens"])     # the local chunk [B, C]
        local_len = tokens.shape[1]
        logits = apply(sp_model, params, tokens)
        targets = sequence.shift_left(tokens, const.SEQUENCE_AXIS, axis=1)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
        # mask the final GLOBAL position (its target wrapped around)
        pos = torch.arange(local_len, device=tokens.device) + \
            sequence.position_offset(local_len, const.SEQUENCE_AXIS)
        total_len = local_len * sequence.axis_size(const.SEQUENCE_AXIS)
        weights = (pos < total_len - 1).to(nll.dtype)[None, :]
        weights = weights.expand(nll.shape)
        return sequence.global_weighted_mean(nll, weights,
                                             const.SEQUENCE_AXIS)

    npr = np.random.RandomState(seed)
    example_batch = {"tokens": npr.randint(
        0, cfg.vocab_size, (batch_size, seq_len)).astype(np.int32)}

    def apply_fn(p, ids):
        return apply(model, p, torch.as_tensor(ids))
    return loss_fn, params, example_batch, apply_fn


def make_decode_setup(config: Optional[LMConfig] = None,
                      decode_attn: str = "reference",
                      return_logits: bool = False):
    """Continuous-batching decode functions (``serving/decode.py``
    DecodeEngine) over the params :func:`make_train_setup` makes.

    ``decode_attn="flash"`` routes the decode inner loop through the flash
    kernel (``ops.attention.flash_cached_attention``); greedy argmax runs
    on the device so the per-step readback is one int32 per slot.
    ``return_logits`` adds the [slots, vocab] logits to the step fetches
    (parity tests)."""
    from autodist_tpu_torch.serving.decode import DecodeSetup

    cfg = config or LMConfig()
    model = make_model(cfg, decode_attn=decode_attn)

    def prefill_fn(params, batch):
        logits, k, v = apply(model, params, batch["tokens"], batch["length"],
                             method="prefill")
        return {"next_token": torch.argmax(logits, dim=-1).int(),
                "k": k, "v": v}

    def decode_fn(params, dstate):
        logits, k, v = apply(model, params, dstate["token"], dstate["k"],
                             dstate["v"], dstate["cursor"], dstate["alive"],
                             method="decode_step")
        out = {"k": k, "v": v,
               "next_token": torch.argmax(logits, dim=-1).int()}
        if return_logits:
            out["logits"] = logits
        return out

    def init_dstate(slots: int, device=None):
        # the entry points' device rule: None is cuda, which raises
        # without a card rather than build the cache on the CPU
        device = resolve_device(device)
        cache_shape = (slots, cfg.num_layers, cfg.max_seq_len,
                       cfg.num_heads, cfg.head_dim)
        return {"k": torch.zeros(cache_shape, dtype=cfg.dtype, device=device),
                "v": torch.zeros(cache_shape, dtype=cfg.dtype, device=device),
                "token": torch.zeros((slots,), dtype=torch.int32,
                                     device=device),
                "cursor": torch.zeros((slots,), dtype=torch.int32,
                                      device=device),
                "alive": torch.zeros((slots,), dtype=torch.bool,
                                     device=device)}

    return DecodeSetup(prefill_fn=prefill_fn, decode_fn=decode_fn,
                       init_dstate=init_dstate, max_len=cfg.max_seq_len,
                       vocab_size=cfg.vocab_size)
