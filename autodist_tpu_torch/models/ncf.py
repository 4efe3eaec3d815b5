"""Neural Collaborative Filtering (NeuMF) recommender (PyTorch counterpart
of ``autodist_tpu/models/ncf.py``).

GMF and MLP towers over user and item embeddings with a binary logistic
objective (the reference's NCF/MovieLens benchmark,
``examples/benchmark/ncf.py``). The four embedding tables are
``SparseEmbed``: their gradients ride the sparse (ids, values) wire, and
Parallax routes them to load-balanced PS. Submodules carry flax's names,
so ``convert.params_from_jax`` maps the JAX model's params one to one.
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
from autodist_tpu_torch.models.layers import (Dense, SparseEmbed, apply,
                                              lecun_normal_)


@dataclasses.dataclass
class NCFConfig:
    num_users: int = 138_000
    num_items: int = 27_000
    mf_dim: int = 64
    mlp_dims: tuple = (256, 128, 64)
    dtype: Any = torch.float32

    @classmethod
    def tiny(cls, **kw):
        return cls(num_users=64, num_items=48, mf_dim=8, mlp_dims=(16, 8),
                   **kw)


class NeuMF(nn.Module):
    def __init__(self, config: NCFConfig):
        super().__init__()
        cfg = self.config = config
        self.apply_lock = threading.Lock()
        self.mf_user_embedding = SparseEmbed(cfg.num_users, cfg.mf_dim,
                                             cfg.dtype)
        self.mf_item_embedding = SparseEmbed(cfg.num_items, cfg.mf_dim,
                                             cfg.dtype)
        mlp_dim0 = cfg.mlp_dims[0] // 2
        self.mlp_user_embedding = SparseEmbed(cfg.num_users, mlp_dim0,
                                              cfg.dtype)
        self.mlp_item_embedding = SparseEmbed(cfg.num_items, mlp_dim0,
                                              cfg.dtype)
        width = 2 * mlp_dim0
        for i, d in enumerate(cfg.mlp_dims[1:]):
            self.add_module("mlp_%d" % i, Dense(width, d, cfg.dtype))
            width = d
        self.prediction = Dense(cfg.mf_dim + width, 1, torch.float32)

    def forward(self, user_ids, item_ids):
        cfg = self.config
        gmf = self.mf_user_embedding(user_ids) * \
            self.mf_item_embedding(item_ids)
        h = torch.cat([self.mlp_user_embedding(user_ids),
                       self.mlp_item_embedding(item_ids)], dim=-1)
        for i in range(len(cfg.mlp_dims) - 1):
            h = F.relu(getattr(self, "mlp_%d" % i)(h))
        return self.prediction(torch.cat([gmf, h], dim=-1))[..., 0]


def make_model(config: NCFConfig) -> NeuMF:
    """A parameterless (``meta``) model to apply params through."""
    with torch.device("meta"):
        return NeuMF(config)


def init_params(config: NCFConfig, seed: int = 0) -> FlaxParams:
    """A float32 init on the CPU from a seeded ``torch.Generator``, in
    flax's distributions: tables normal with std 1/sqrt(features), Dense
    weights ``lecun_normal``, zero biases."""
    model = make_model(config)
    gen = torch.Generator().manual_seed(int(seed))
    params = FlaxParams()
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        if name.endswith("embedding"):
            t = torch.randn(shape, generator=gen) / math.sqrt(shape[1])
        elif name.endswith("bias"):
            t = torch.zeros(shape)
        else:
            t = lecun_normal_(torch.empty(shape), shape[1], gen)
        params[name] = t
    return params


def sigmoid_xent(logits, labels):
    """Mean numerically stable sigmoid cross-entropy, as the JAX loss
    writes it."""
    labels = labels.to(torch.float32)
    return torch.mean(torch.clamp_min(logits, 0) - logits * labels
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def make_train_setup(config: Optional[NCFConfig] = None,
                     batch_size: int = 256, seed: int = 0):
    """``(loss_fn, params, example_batch, apply_fn)`` for the click
    objective; the example batch is the JAX module's (numpy seed)."""
    cfg = config or NCFConfig()
    model = make_model(cfg)
    params = init_params(cfg, seed)

    def loss_fn(params, batch):
        logits = apply(model, params, torch.as_tensor(batch["user"]),
                       torch.as_tensor(batch["item"]))
        return sigmoid_xent(logits, torch.as_tensor(batch["label"]))

    npr = np.random.RandomState(seed)
    example_batch = {
        "user": npr.randint(0, cfg.num_users, (batch_size,)).astype(np.int32),
        "item": npr.randint(0, cfg.num_items, (batch_size,)).astype(np.int32),
        "label": npr.randint(0, 2, (batch_size,)).astype(np.int32),
    }

    def apply_fn(p, u, i):
        return apply(model, p, torch.as_tensor(u), torch.as_tensor(i))
    return loss_fn, params, example_batch, apply_fn
