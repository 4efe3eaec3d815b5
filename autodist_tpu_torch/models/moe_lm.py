"""Mixture-of-Experts transformer LM (the expert-parallel flagship).

PyTorch counterpart of ``autodist_tpu/models/moe_lm.py``: plain functions
on tensors over a flat ``{name: tensor}`` mapping whose names and shapes
are the JAX pytree's (``layer_0/moe/w1 [E, d, f]``;
``convert.jax_named``), so the strategy's rules, the plan and the
checkpoints are the JAX package's as they are. Transformer blocks whose
feed-forward is a top-1-routed MoE (``parallel/expert.py``): the
expert-stacked FFN weights shard over the ``expert`` mesh axis under
``ExpertParallel``, tokens route with one all-to-all each way, and the
Switch load-balance auxiliary loss keeps routing even; attention and
everything else stays dense (Switch Transformer, arXiv 2101.03961).

The token embedding and the output head are untied, so the vocab-sized
table can ride the sparse (ids, values) gradient wire
(``ops/embedding.embedding_lookup``); positions are a static slice.
``moe_lm`` is not in the model registry, as in the JAX package.
"""
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from autodist_tpu_torch import const
from autodist_tpu_torch.convert import FlaxParams, jax_named
from autodist_tpu_torch.models.tp_lm import _causal_attention, _layer_norm
from autodist_tpu_torch.parallel import expert, tensor


@dataclasses.dataclass
class MoEConfig:
    vocab_size: int = 32000
    d_model: int = 512
    num_layers: int = 4
    num_heads: int = 8
    num_experts: int = 8
    expert_dim: int = 1024
    max_seq_len: int = 256
    capacity_factor: float = 2.0
    aux_coef: float = 0.01
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("vocab_size", 64)
        kw.setdefault("d_model", 32)
        kw.setdefault("num_layers", 2)
        kw.setdefault("num_heads", 4)
        kw.setdefault("num_experts", 4)
        kw.setdefault("expert_dim", 64)
        kw.setdefault("max_seq_len", 64)
        return cls(**kw)


def init_params(cfg: MoEConfig, seed: int = 0) -> FlaxParams:
    """The full float32 params: the JAX ``init_params``'s numpy draws in
    its order, so the values are the JAX ones bit for bit."""
    rng = np.random.RandomState(seed)
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    E, f = cfg.num_experts, cfg.expert_dim

    def normal(*shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def ln(prefix):
        return {prefix + "/scale": np.ones((d,), np.float32),
                prefix + "/bias": np.zeros((d,), np.float32)}

    out_scale = 0.02 / np.sqrt(2 * cfg.num_layers)
    params = {"embed": normal(cfg.vocab_size, d, scale=0.02),
              "pos_embed": normal(cfg.max_seq_len, d, scale=0.02)}
    params.update(ln("final_ln"))
    params["lm_head"] = normal(d, cfg.vocab_size, scale=0.02)
    for i in range(cfg.num_layers):
        p = "layer_%d/" % i
        params.update(ln(p + "ln1"))
        params[p + "attn/wq"] = normal(d, h, hd, scale=0.02)
        params[p + "attn/wk"] = normal(d, h, hd, scale=0.02)
        params[p + "attn/wv"] = normal(d, h, hd, scale=0.02)
        params[p + "attn/wo"] = normal(h, hd, d, scale=out_scale)
        params[p + "attn/bo"] = np.zeros((d,), np.float32)
        params.update(ln(p + "ln2"))
        params[p + "moe/router"] = normal(d, E, scale=0.02)
        params[p + "moe/w1"] = normal(E, d, f, scale=0.02)
        params[p + "moe/b1"] = np.zeros((E, f), np.float32)
        params[p + "moe/w2"] = normal(E, f, d, scale=out_scale)
        params[p + "moe/b2"] = np.zeros((E, d), np.float32)
    return jax_named({n: torch.from_numpy(a) for n, a in params.items()})


def ep_rules(expert_axis: str = const.EXPERT_AXIS
             ) -> List[Tuple[str, Dict[int, str]]]:
    """The expert-stacked FFN weights shard dim 0 over the expert axis;
    the router (and everything else) stays replicated."""
    return [(r".*/moe/[wb][12]$", {0: expert_axis})]


def forward(params, input_ids, cfg: MoEConfig):
    """The logits and the Switch aux loss summed over the layers."""
    from autodist_tpu_torch.ops.embedding import embedding_lookup
    dt = cfg.dtype
    seq_len = input_ids.shape[-1]
    x = embedding_lookup(params["embed"], input_ids, name="embed")
    x = (x * float(np.sqrt(cfg.d_model))).to(dt)
    x = x + params["pos_embed"][:seq_len].to(dt)[None]
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.num_layers):
        p = "layer_%d/" % i
        h = _layer_norm(x, params, p + "ln1")
        q = tensor.column_parallel_dense(h, params[p + "attn/wq"].to(dt))
        k = tensor.column_parallel_dense(h, params[p + "attn/wk"].to(dt))
        v = tensor.column_parallel_dense(h, params[p + "attn/wv"].to(dt))
        o = _causal_attention(q, k, v)
        o = tensor.row_parallel_dense(o, params[p + "attn/wo"].to(dt),
                                      params[p + "attn/bo"].to(dt),
                                      contract_dims=2)
        x = x + o
        h = _layer_norm(x, params, p + "ln2")
        moe_out, aux = expert.moe_ffn(
            h, params[p + "moe/router"], params[p + "moe/w1"],
            params[p + "moe/b1"], params[p + "moe/w2"],
            params[p + "moe/b2"], capacity_factor=cfg.capacity_factor,
            dtype=dt)
        aux_total = aux_total + aux
        x = x + moe_out
    x = _layer_norm(x, params, "final_ln")
    logits = torch.tensordot(x, params["lm_head"].to(dt),
                             dims=([x.dim() - 1], [0]))
    return logits, aux_total


def make_loss(cfg: MoEConfig, aux_coef: Optional[float] = None):
    """The JAX ``make_train_setup``'s loss: the mean next-token NLL of
    ``batch["tokens"]`` ``[B, S + 1]`` plus ``aux_coef`` (the config's by
    default) times the aux loss."""
    coef = cfg.aux_coef if aux_coef is None else aux_coef

    def loss_fn(p, batch):
        tokens = torch.as_tensor(batch["tokens"])
        logits, aux = forward(p, tokens[:, :-1], cfg)
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, tokens[:, 1:].long()[..., None])[..., 0]
        return nll.mean() + coef * aux
    return loss_fn


def make_train_setup(cfg: Optional[MoEConfig] = None, seq_len: int = 128,
                     batch_size: int = 8, seed: int = 0,
                     aux_coef: Optional[float] = None):
    """(loss_fn, params, example_batch, apply_fn) for the AutoDist stack,
    the JAX function's: a ``[batch_size, seq_len + 1]`` int32 token batch
    drawn from ``seed``."""
    cfg = cfg or MoEConfig()
    params = init_params(cfg, seed)
    npr = np.random.RandomState(seed)
    example_batch = {"tokens": npr.randint(
        0, cfg.vocab_size, (batch_size, seq_len + 1)).astype(np.int32)}

    def apply_fn(p, ids):
        return forward(p, torch.as_tensor(ids), cfg)[0]
    return make_loss(cfg, aux_coef), params, example_batch, apply_fn
