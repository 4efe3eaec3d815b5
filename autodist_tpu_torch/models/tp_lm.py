"""Tensor-parallel decoder-only transformer LM (the flagship model).

PyTorch counterpart of ``autodist_tpu/models/tp_lm.py``: plain functions
on tensors over a flat ``{name: tensor}`` mapping whose names and shapes
are the JAX pytree's (``layer_0/attn/wq [d, h, hd]``, ``layer_0/attn/wo
[h, hd, d]``; ``convert.jax_named``), so the strategy's rules, the plan
and the checkpoints are the JAX package's as they are. Every op is
shape-polymorphic: the same code runs whole on one process and sharded
under ``TensorParallel``, consuming whatever slices the strategy
assigned. Model parallelism follows Megatron (arXiv 1909.08053), built
from ``parallel/tensor.py``:

- attention QKV column-parallel (heads sharded over ``model``), the
  out-projection row-parallel (one all-reduce);
- the MLP's up-projection column-parallel, its down-projection
  row-parallel (one all-reduce);
- the embedding vocab-parallel, tied with the output head
  (``vocab_parallel_logits`` + ``vocab_parallel_xent``).

``forward``'s ``attn_fn(q, k, v)`` slot takes the flash kernels
(``ops.flash_attention.make_flash_attn_fn(causal=True)``), where the JAX
package puts its Pallas flash, or ring or Ulysses attention under
sequence parallelism (``make_train_setup(attention="ring" | "ulysses")``
with ``TensorParallel(tp, rules, seq_shards=n)``): the tokens arrive
seq-sharded, positions start at the shard's offset, next-token targets
cross shard boundaries and the final global position is masked.
``tp_lm`` is not in the model registry, as in the JAX package.
"""
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from autodist_tpu_torch import const
from autodist_tpu_torch.convert import FlaxParams, jax_named
from autodist_tpu_torch.parallel import sequence, tensor


@dataclasses.dataclass
class TPLMConfig:
    vocab_size: int = 32000
    d_model: int = 512
    num_layers: int = 6
    num_heads: int = 8
    mlp_dim: int = 2048
    max_seq_len: int = 256
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
        kw.setdefault("mlp_dim", 64)
        kw.setdefault("max_seq_len", 64)
        return cls(**kw)

    @classmethod
    def flagship(cls, **kw):
        """GPT-2-medium-ish: the JAX package's benchmark configuration."""
        kw.setdefault("vocab_size", 32768)
        kw.setdefault("d_model", 1024)
        kw.setdefault("num_layers", 12)
        kw.setdefault("num_heads", 16)
        kw.setdefault("mlp_dim", 4096)
        kw.setdefault("max_seq_len", 1024)
        kw.setdefault("dtype", torch.bfloat16)
        return cls(**kw)


def init_params(cfg: TPLMConfig, seed: int = 0) -> FlaxParams:
    """The full (unsharded) float32 params: the JAX ``init_params``'s
    numpy draws in its order, so the values are the JAX ones bit for
    bit; the strategy shards storage."""
    rng = np.random.RandomState(seed)
    d, h, hd, f = cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.mlp_dim

    def normal(*shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def ln(prefix):
        return {prefix + "/scale": np.ones((d,), np.float32),
                prefix + "/bias": np.zeros((d,), np.float32)}

    params = {"embed": normal(cfg.vocab_size, d, scale=0.02),
              "pos_embed": normal(cfg.max_seq_len, d, scale=0.02)}
    params.update(ln("final_ln"))
    out_scale = 0.02 / np.sqrt(2 * cfg.num_layers)
    for i in range(cfg.num_layers):
        p = "layer_%d/" % i
        params.update(ln(p + "ln1"))
        params[p + "attn/wq"] = normal(d, h, hd, scale=0.02)
        params[p + "attn/wk"] = normal(d, h, hd, scale=0.02)
        params[p + "attn/wv"] = normal(d, h, hd, scale=0.02)
        params[p + "attn/wo"] = normal(h, hd, d, scale=out_scale)
        params[p + "attn/bo"] = np.zeros((d,), np.float32)
        params.update(ln(p + "ln2"))
        params[p + "mlp/w1"] = normal(d, f, scale=0.02)
        params[p + "mlp/b1"] = np.zeros((f,), np.float32)
        params[p + "mlp/w2"] = normal(f, d, scale=out_scale)
        params[p + "mlp/b2"] = np.zeros((d,), np.float32)
    return jax_named({n: torch.from_numpy(a) for n, a in params.items()})


def tp_rules(model_axis: str = const.MODEL_AXIS
             ) -> List[Tuple[str, Dict[int, str]]]:
    """Regex -> {dim: mesh axis} storage-sharding rules for
    ``TensorParallel`` (the JAX ``tp_rules``): QKV kernels shard dim 1
    (heads); the out-projection and the MLP down-projection their input
    dim (row-parallel); the MLP up-projection and its bias the hidden dim
    (column-parallel); the tied embedding the vocab dim. LayerNorms,
    ``pos_embed`` and the biases added after a reduce stay replicated."""
    return [
        (r".*/attn/w[qkv]$", {1: model_axis}),
        (r".*/attn/wo$", {0: model_axis}),
        (r".*/mlp/w1$", {1: model_axis}),
        (r".*/mlp/b1$", {0: model_axis}),
        (r".*/mlp/w2$", {0: model_axis}),
        (r"^embed$", {0: model_axis}),
    ]


def _layer_norm(x, params, prefix, eps=1e-6):
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * params[prefix + "/scale"]
            + params[prefix + "/bias"]).to(x.dtype)


def _causal_attention(q, k, v):
    """Plain causal attention, [B, S, H_local, D] -> [B, S, H_local, D].
    The scores are scaled in float32, as the JAX model's product with a
    numpy scalar promotes them."""
    scale = 1.0 / float(np.sqrt(q.shape[-1]))
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    s = q.shape[1]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    logits = torch.where(mask[None, None], logits,
                         torch.finfo(logits.dtype).min)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def forward(params, input_ids, cfg: TPLMConfig, attn_fn=None,
            seq_parallel: bool = False,
            model_axis: str = const.MODEL_AXIS):
    """Logits over the (possibly vocab-sharded) vocabulary.
    ``attn_fn(q, k, v)`` replaces the plain causal attention;
    ``input_ids`` is the LOCAL sequence chunk under ``seq_parallel``."""
    dt = cfg.dtype
    seq_len = input_ids.shape[-1]
    x = tensor.vocab_parallel_embed(params["embed"], input_ids, model_axis)
    x = (x * float(np.sqrt(cfg.d_model))).to(dt)
    if seq_parallel:
        # each seq shard reads its own row range (a real gather); the
        # named lookup keeps it on the sparse surface, where the cost gate
        # keeps it dense (every row is read)
        from autodist_tpu_torch.ops.embedding import embedding_lookup
        positions = torch.arange(seq_len, device=input_ids.device) + \
            sequence.position_offset(seq_len)
        x = x + embedding_lookup(params["pos_embed"], positions,
                                 name="pos_embed").to(dt)[None]
    else:
        # a static slice, not a gather: every position row is used each
        # step
        x = x + params["pos_embed"][:seq_len].to(dt)[None]
    for i in range(cfg.num_layers):
        p = "layer_%d/" % i
        h = _layer_norm(x, params, p + "ln1")
        q = tensor.column_parallel_dense(h, params[p + "attn/wq"].to(dt))
        k = tensor.column_parallel_dense(h, params[p + "attn/wk"].to(dt))
        v = tensor.column_parallel_dense(h, params[p + "attn/wv"].to(dt))
        o = attn_fn(q, k, v) if attn_fn is not None \
            else _causal_attention(q, k, v)
        o = tensor.row_parallel_dense(o, params[p + "attn/wo"].to(dt),
                                      params[p + "attn/bo"].to(dt),
                                      model_axis, contract_dims=2)
        x = x + o
        h = _layer_norm(x, params, p + "ln2")
        h = tensor.column_parallel_dense(h, params[p + "mlp/w1"].to(dt),
                                         params[p + "mlp/b1"].to(dt))
        h = F.gelu(h, approximate="tanh")
        h = tensor.row_parallel_dense(h, params[p + "mlp/w2"].to(dt),
                                      params[p + "mlp/b2"].to(dt),
                                      model_axis)
        x = x + h
    x = _layer_norm(x, params, "final_ln")
    return tensor.vocab_parallel_logits(x, params["embed"].to(dt))


def make_loss(cfg: TPLMConfig, attn_fn=None,
              model_axis: str = const.MODEL_AXIS,
              attention: Optional[str] = None):
    """The JAX ``make_train_setup``'s loss: the mean next-token NLL of
    ``batch["tokens"]`` ``[B, S + 1]``, with ``attn_fn`` in the attention
    slot. ``attention`` ``"ring"``/``"ulysses"``: the sequence-parallel
    loss over ``[B, S]`` tokens sharded over the ``seq`` axis (the final
    global position masked, ``sequence.global_weighted_mean``), with that
    attention, causal, in the slot."""
    if attention in ("ring", "ulysses"):
        from autodist_tpu_torch.ops.attention import make_attn_fn
        sp_attn = make_attn_fn(attention, const.SEQUENCE_AXIS, causal=True)

        def sp_loss(p, batch):
            tokens = torch.as_tensor(batch["tokens"])
            logits = forward(p, tokens, cfg,
                             attn_fn=lambda q, k, v: sp_attn(q, k, v, None),
                             seq_parallel=True, model_axis=model_axis)
            targets = sequence.shift_left(tokens, const.SEQUENCE_AXIS,
                                          axis=1)
            nll = tensor.vocab_parallel_xent(logits, targets, model_axis)
            local_len = tokens.shape[1]
            pos = torch.arange(local_len, device=tokens.device) + \
                sequence.position_offset(local_len)
            total = local_len * sequence.axis_size(const.SEQUENCE_AXIS)
            w = (pos < total - 1).to(nll.dtype)[None, :].expand(nll.shape)
            return sequence.global_weighted_mean(nll, w)
        return sp_loss

    def loss_fn(p, batch):
        tokens = torch.as_tensor(batch["tokens"])
        logits = forward(p, tokens[:, :-1], cfg, attn_fn=attn_fn,
                         model_axis=model_axis)
        nll = tensor.vocab_parallel_xent(logits, tokens[:, 1:], model_axis)
        return nll.mean()
    return loss_fn


def make_train_setup(cfg: Optional[TPLMConfig] = None, seq_len: int = 128,
                     batch_size: int = 8, seed: int = 0,
                     attention: Optional[str] = None,
                     model_axis: str = const.MODEL_AXIS):
    """(loss_fn, params, example_batch, apply_fn) for the AutoDist stack,
    the JAX function's: ``attention`` None, the plain causal attention
    over a ``[batch_size, seq_len + 1]`` int32 token batch drawn from
    ``seed``; ``"ring"``/``"ulysses"``, the sequence-parallel loss
    (:func:`make_loss`) over ``[batch_size, seq_len]`` tokens."""
    cfg = cfg or TPLMConfig()
    params = init_params(cfg, seed)
    seq_parallel = attention in ("ring", "ulysses")
    npr = np.random.RandomState(seed)
    extra = 0 if seq_parallel else 1
    example_batch = {"tokens": npr.randint(
        0, cfg.vocab_size, (batch_size, seq_len + extra)).astype(np.int32)}

    def apply_fn(p, ids):
        return forward(p, ids, cfg, model_axis=model_axis)
    return make_loss(cfg, model_axis=model_axis,
                     attention=attention if seq_parallel else None), \
        params, example_batch, apply_fn
