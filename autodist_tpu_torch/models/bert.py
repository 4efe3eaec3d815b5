"""BERT encoder + masked-LM pretraining (PyTorch counterpart of
``autodist_tpu/models/bert.py``).

Same architecture and numerics as the flax model: word, position and
token-type embeddings, a layer norm, N pre-LN transformer blocks, and an
untied MLM head (``mlm_transform`` -> tanh GELU -> ``mlm_ln`` ->
``mlm_output``). The residual stream and every layer compute in
``dtype``; only ``mlm_output`` and the loss run in float32. Submodules
carry flax's names, so ``convert.params_from_jax`` maps them one to one.

Parameters are a flat ``{name: tensor}`` mapping from :func:`init_params`
(a seeded ``torch.Generator``; the values differ from flax's — tests feed
both packages the same numbers through ``convert.params_from_jax``).
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
                                              lecun_normal_, flax_shapes)


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    dtype: Any = torch.float32

    @classmethod
    def base(cls, **kw):
        return cls(**kw)

    @classmethod
    def large(cls, **kw):
        return cls(hidden_size=1024, num_layers=24, num_heads=16,
                   mlp_dim=4096, **kw)

    @classmethod
    def tiny(cls, **kw):
        """Test-sized config."""
        return cls(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
                   mlp_dim=64, max_position=64, **kw)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


class BertEncoder(nn.Module):
    """Embeddings, their layer norm and the transformer blocks. A key-padding
    ``attention_mask`` [B, S] (1 real, 0 padding) reaches each block as a
    [B, 1, 1, S] boolean mask: the plain attention masks the padded keys,
    and ``make_flash_attn_fn`` turns it into segment ids."""

    def __init__(self, config: BertConfig, attn_fn=None):
        super().__init__()
        cfg = self.config = config
        self.word_embeddings = SparseEmbed(cfg.vocab_size, cfg.hidden_size,
                                           cfg.dtype)
        self.position_embeddings = SparseEmbed(cfg.max_position,
                                               cfg.hidden_size, cfg.dtype)
        self.token_type_embeddings = SparseEmbed(cfg.type_vocab_size,
                                                 cfg.hidden_size, cfg.dtype)
        self.embeddings_ln = LayerNorm(cfg.hidden_size, cfg.dtype)
        for i in range(cfg.num_layers):
            self.add_module("layer_%d" % i, TransformerBlock(
                cfg.hidden_size, cfg.num_heads, cfg.head_dim, cfg.mlp_dim,
                cfg.dtype, attn_fn))

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        seq_len = input_ids.shape[-1]
        x = self.word_embeddings(input_ids)
        x = x + self.position_embeddings(
            torch.arange(seq_len, device=input_ids.device)[None])
        if token_type_ids is not None:
            x = x + self.token_type_embeddings(token_type_ids)
        x = self.embeddings_ln(x)
        mask = None
        if attention_mask is not None:
            mask = attention_mask[:, None, None, :].bool()
        for i in range(self.config.num_layers):
            x = getattr(self, "layer_%d" % i)(x, mask)
        return x


class BertForMLM(nn.Module):
    """The encoder and the MLM head; returns float32 logits [B, S, vocab]."""

    def __init__(self, config: BertConfig, attn_fn=None):
        super().__init__()
        cfg = self.config = config
        self.apply_lock = threading.Lock()
        self.encoder = BertEncoder(cfg, attn_fn)
        self.mlm_transform = Dense(cfg.hidden_size, cfg.hidden_size,
                                   cfg.dtype)
        self.mlm_ln = LayerNorm(cfg.hidden_size, cfg.dtype)
        self.mlm_output = Dense(cfg.hidden_size, cfg.vocab_size,
                                torch.float32)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        x = self.encoder(input_ids, token_type_ids, attention_mask)
        x = F.gelu(self.mlm_transform(x), approximate="tanh")
        return self.mlm_output(self.mlm_ln(x))


def make_model(config: BertConfig, attn_fn=None) -> BertForMLM:
    """A parameterless (``meta``) model to apply params through."""
    with torch.device("meta"):
        return BertForMLM(config, attn_fn)


def init_params(config: BertConfig, seed: int = 0) -> dict:
    """A float32 :class:`~autodist_tpu_torch.convert.FlaxParams` init
    (``{name: tensor}`` with the attention projections' flax shapes) on
    the CPU from a seeded ``torch.Generator``, in flax's distributions:
    Dense weights ``lecun_normal`` (fan_in = the weight's ``in`` dim),
    embedding tables normal with std 1/sqrt(features), zero biases, unit
    layer-norm scales."""
    with torch.device("meta"):
        model = BertForMLM(config)
    names = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    gen = torch.Generator().manual_seed(int(seed))
    params = {}
    for name, shape in names:
        if name.endswith("bias"):
            t = torch.zeros(shape)
        elif name.endswith("embedding"):
            t = torch.randn(shape, generator=gen) / math.sqrt(shape[1])
        elif "_ln." in name or ".LayerNorm_" in name:
            t = torch.ones(shape)
        else:
            t = lecun_normal_(torch.empty(shape), shape[1], gen)
        params[name] = t
    return FlaxParams(params, flax_shapes=flax_shapes(model))


def make_train_setup(config: Optional[BertConfig] = None, seq_len: int = 128,
                     batch_size: int = 32, seed: int = 0,
                     attention: str = "auto"):
    """``(loss_fn, params, example_batch, apply_fn)`` for the masked-LM
    objective, as in the JAX module: ``log_softmax`` over float32 logits,
    the labels' log-probabilities gathered, weighted by ``mlm_weights``
    and divided by their sum (at least 1).

    ``attention``: "flash" routes every layer through the flash kernels
    (forward and both backward kernels, non-causal, the padding
    ``attention_mask`` as segment ids); "xla" (the JAX package's name)
    and "auto" run the plain attention of ``layers.MultiHeadAttention``.
    The JAX "auto" switch to flash at seq >= 8192 was measured on a TPU;
    the port does not inherit it. Padded query rows differ between the
    two paths (flash: they attend the padded keys; plain: the real ones);
    losses agree where ``mlm_weights`` are 0 on padding."""
    from autodist_tpu_torch.ops.flash_attention import make_flash_attn_fn
    cfg = config or BertConfig.base()
    if attention not in ("auto", "flash", "xla"):
        raise ValueError("attention must be 'auto', 'flash' or 'xla'")
    if seq_len > cfg.max_position:
        raise ValueError("seq_len %d exceeds config.max_position %d"
                         % (seq_len, cfg.max_position))
    attn_fn = make_flash_attn_fn(causal=False) if attention == "flash" \
        else None
    model = make_model(cfg, attn_fn)
    params = init_params(cfg, seed)

    def loss_fn(params, batch):
        logits = apply(model, params, torch.as_tensor(batch["input_ids"]),
                       torch.as_tensor(batch["token_type_ids"]),
                       torch.as_tensor(batch["attention_mask"]))
        logp = torch.log_softmax(logits, dim=-1)
        labels = torch.as_tensor(batch["labels"]).long()
        per_tok = -torch.gather(logp, -1, labels[..., None])[..., 0]
        weights = torch.as_tensor(batch["mlm_weights"]).to(per_tok.dtype)
        return (per_tok * weights).sum() / weights.sum().clamp_min(1.0)

    npr = np.random.RandomState(seed)
    shape = (batch_size, seq_len)
    example_batch = {
        "input_ids": npr.randint(0, cfg.vocab_size, shape).astype(np.int32),
        "token_type_ids": np.zeros(shape, np.int32),
        "attention_mask": np.ones(shape, np.int32),
        "labels": npr.randint(0, cfg.vocab_size, shape).astype(np.int32),
        "mlm_weights": (npr.rand(*shape) < 0.15).astype(np.float32),
    }

    def apply_fn(p, ids):
        return apply(model, p, torch.as_tensor(ids))
    return loss_fn, params, example_batch, apply_fn
