"""DLRM — the large-embedding recommender (PyTorch counterpart of
``autodist_tpu/models/dlrm.py``).

Dense features through a bottom MLP, one embedding table a sparse
feature, explicit pairwise dot-product interactions, and a top MLP over
[bottom output, interactions] (arXiv 1906.00091); ``wide=True`` adds
Wide&Deep's linear term (arXiv 1606.07792): a 1-wide table a feature and
a bias-free linear map of the dense features, added to the logit. The
tables dwarf the dense parameters: the sparse/PS stress case, where
Parallax sends the tables to host PS over the (ids, values) wire and the
MLPs to AllReduce. Every lookup is a ``SparseEmbed``; the interactions
are one batched matmul and the lower triangle below the diagonal in
row-major order (``torch.tril_indices(f, f, -1)``, jnp's
``tril_indices(f, k=-1)`` order). Submodules carry flax's names.
"""
import dataclasses
import math
import threading
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from autodist_tpu_torch.convert import FlaxParams
from autodist_tpu_torch.models.layers import (Dense, SparseEmbed, apply,
                                              lecun_normal_)
from autodist_tpu_torch.models.ncf import sigmoid_xent


@dataclasses.dataclass
class DLRMConfig:
    # vocab size a sparse feature (criteo-style: wildly uneven)
    table_sizes: Tuple[int, ...] = (1_000_000, 500_000, 100_000, 10_000,
                                    10_000, 1_000, 1_000, 100)
    embed_dim: int = 64
    num_dense: int = 13
    bottom_mlp: Tuple[int, ...] = (512, 256, 64)
    top_mlp: Tuple[int, ...] = (512, 256)
    wide: bool = False
    dtype: Any = torch.float32

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("table_sizes", (64, 48, 32, 16))
        kw.setdefault("embed_dim", 8)
        kw.setdefault("num_dense", 4)
        kw.setdefault("bottom_mlp", (16, 8))
        kw.setdefault("top_mlp", (16,))
        return cls(**kw)

    def __post_init__(self):
        if self.bottom_mlp[-1] != self.embed_dim:
            raise ValueError(
                "bottom_mlp must end at embed_dim (%d != %d): the bottom "
                "output joins the embeddings in the interaction"
                % (self.bottom_mlp[-1], self.embed_dim))


class DLRM(nn.Module):
    def __init__(self, config: DLRMConfig):
        super().__init__()
        cfg = self.config = config
        self.apply_lock = threading.Lock()
        width = cfg.num_dense
        for i, w in enumerate(cfg.bottom_mlp):
            self.add_module("bottom_%d" % i, Dense(width, w, cfg.dtype))
            width = w
        for t, size in enumerate(cfg.table_sizes):
            self.add_module("table_%d" % t,
                            SparseEmbed(size, cfg.embed_dim, cfg.dtype))
        f = len(cfg.table_sizes) + 1
        width = cfg.embed_dim + f * (f - 1) // 2
        for i, w in enumerate(cfg.top_mlp):
            self.add_module("top_%d" % i, Dense(width, w, cfg.dtype))
            width = w
        self.click = Dense(width, 1, torch.float32)
        if cfg.wide:
            for t, size in enumerate(cfg.table_sizes):
                self.add_module("wide_table_%d" % t,
                                SparseEmbed(size, 1, torch.float32))
            # no bias: the click head's bias covers the additive scalar
            self.wide_dense = Dense(cfg.num_dense, 1, torch.float32,
                                    use_bias=False)

    def forward(self, dense, sparse_ids):
        """dense [B, num_dense] float; sparse_ids [B, num_tables] int."""
        cfg = self.config
        x = dense.to(cfg.dtype)
        for i in range(len(cfg.bottom_mlp)):
            x = F.relu(getattr(self, "bottom_%d" % i)(x))
        embs = [getattr(self, "table_%d" % t)(sparse_ids[:, t])
                for t in range(len(cfg.table_sizes))]
        z = torch.stack([x] + embs, dim=1)                  # [B, F, d]
        inter = torch.bmm(z, z.transpose(1, 2))             # [B, F, F]
        f = z.shape[1]
        li, lj = torch.tril_indices(f, f, -1, device=z.device)
        h = torch.cat([x, inter[:, li, lj].to(cfg.dtype)], dim=-1)
        for i in range(len(cfg.top_mlp)):
            h = F.relu(getattr(self, "top_%d" % i)(h))
        logit = self.click(h)[..., 0]
        if cfg.wide:
            for t in range(len(cfg.table_sizes)):
                logit = logit + getattr(self, "wide_table_%d" % t)(
                    sparse_ids[:, t])[..., 0]
            logit = logit + self.wide_dense(dense.to(torch.float32))[..., 0]
        return logit


def make_model(config: DLRMConfig) -> DLRM:
    """A parameterless (``meta``) model to apply params through."""
    with torch.device("meta"):
        return DLRM(config)


def init_params(config: DLRMConfig, seed: int = 0) -> FlaxParams:
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


def make_train_setup(config: Optional[DLRMConfig] = None,
                     batch_size: int = 256, seed: int = 0,
                     hot_fraction: float = 0.05):
    """``(loss_fn, params, example_batch, apply_fn)`` — the click-through
    objective. The example batch is the JAX module's, from the same numpy
    seed: dense features normal, and power-law-ish ids (80% of each
    column drawn from the first ``hot_fraction`` of its vocabulary, the
    rest uniform), the id skew load balancing and the sparse wire face."""
    cfg = config or DLRMConfig()
    model = make_model(cfg)
    params = init_params(cfg, seed)

    def loss_fn(params, batch):
        logits = apply(model, params, torch.as_tensor(batch["dense"]),
                       torch.as_tensor(batch["sparse"]))
        return sigmoid_xent(logits, torch.as_tensor(batch["label"]))

    npr = np.random.RandomState(seed)
    sparse = np.stack(
        [np.where(npr.rand(batch_size) < 0.8,
                  npr.randint(0, max(1, int(size * hot_fraction)),
                              batch_size),
                  npr.randint(0, size, batch_size))
         for size in cfg.table_sizes], axis=1).astype(np.int32)
    example_batch = {
        "dense": npr.randn(batch_size, cfg.num_dense).astype(np.float32),
        "sparse": sparse,
        "label": npr.randint(0, 2, (batch_size,)).astype(np.int32),
    }

    def apply_fn(p, d, s):
        return apply(model, p, torch.as_tensor(d), torch.as_tensor(s))
    return loss_fn, params, example_batch, apply_fn
