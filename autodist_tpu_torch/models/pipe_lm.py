"""Pipeline-parallel (optionally x tensor-parallel) transformer LM.

PyTorch counterpart of ``autodist_tpu/models/pipe_lm.py``: the
stacked-blocks variant of ``models/tp_lm.py``. Every block's parameters
carry a leading layer dim under the JAX names (``blocks/attn/wq [L, d, h,
hd]``, ``blocks/mlp/w1 [L, d, f]``; ``convert.jax_named``), sharded over
the ``pipe`` mesh axis (``mp_axes = {0: 'pipe'}``) and streamed by one of
``parallel/pipeline.py``'s schedules (GPipe, 1F1B, interleaved); heads and
hidden dims can shard over the ``model`` axis at the same time with the
Megatron ops of ``parallel/tensor.py``, giving dp x pp x tp meshes. The
embedding and the tied output head run replicated on every pipe rank; the
pipeline covers the uniform-shape block stack.

The block takes the ``attn_fn(q, k, v)`` slot of ``tp_lm.forward``, where
the flash kernels go (``ops.flash_attention.make_flash_attn_fn(
causal=True)``); ``None`` is the JAX model's plain causal attention.
``pipe_lm`` is not in the model registry, as in the JAX package.
"""
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from autodist_tpu_torch import const
from autodist_tpu_torch.convert import FlaxParams, jax_named
from autodist_tpu_torch.models.tp_lm import (TPLMConfig, _causal_attention,
                                             _layer_norm)
from autodist_tpu_torch.parallel import pipeline, tensor

BLOCKS = "blocks/"
SCHEDULES = ("gpipe", "1f1b", "interleaved")


def init_params(cfg: TPLMConfig, seed: int = 0) -> FlaxParams:
    """The full (unsharded) float32 params with layer-stacked blocks: the
    JAX ``init_params``'s numpy draws in its order, so the values are the
    JAX ones bit for bit; the strategy shards storage."""
    rng = np.random.RandomState(seed)
    d, h, hd, f, L = (cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.mlp_dim,
                      cfg.num_layers)

    def normal(*shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    out_scale = 0.02 / np.sqrt(2 * L)
    params = {"embed": normal(cfg.vocab_size, d, scale=0.02),
              "pos_embed": normal(cfg.max_seq_len, d, scale=0.02)}
    b = BLOCKS
    for ln in ("ln1", "ln2"):
        params[b + ln + "/scale"] = np.ones((L, d), np.float32)
        params[b + ln + "/bias"] = np.zeros((L, d), np.float32)
    for w in ("wq", "wk", "wv"):
        params[b + "attn/" + w] = normal(L, d, h, hd, scale=0.02)
    params[b + "attn/wo"] = normal(L, h, hd, d, scale=out_scale)
    params[b + "attn/bo"] = np.zeros((L, d), np.float32)
    params[b + "mlp/w1"] = normal(L, d, f, scale=0.02)
    params[b + "mlp/b1"] = np.zeros((L, f), np.float32)
    params[b + "mlp/w2"] = normal(L, f, d, scale=out_scale)
    params[b + "mlp/b2"] = np.zeros((L, d), np.float32)
    params["final_ln/scale"] = np.ones((d,), np.float32)
    params["final_ln/bias"] = np.zeros((d,), np.float32)
    return jax_named({n: torch.from_numpy(a) for n, a in params.items()})


def pp_rules(pipe_axis: str = const.PIPELINE_AXIS,
             model_axis: Optional[str] = None
             ) -> List[Tuple[str, Dict[int, str]]]:
    """The JAX ``pp_rules``: the layer stack over ``pipe``; with
    ``model_axis`` set, heads and hidden dims shard Megatron-style too
    (``tp_lm.tp_rules``'s dims shifted by one for the stack dim)."""
    if model_axis is None:
        return [(r"^blocks/", {0: pipe_axis})]
    return [
        (r"^blocks/attn/w[qkv]$", {0: pipe_axis, 2: model_axis}),
        (r"^blocks/attn/wo$", {0: pipe_axis, 1: model_axis}),
        (r"^blocks/mlp/w1$", {0: pipe_axis, 2: model_axis}),
        (r"^blocks/mlp/b1$", {0: pipe_axis, 1: model_axis}),
        (r"^blocks/mlp/w2$", {0: pipe_axis, 1: model_axis}),
        (r"^blocks/", {0: pipe_axis}),
        (r"^embed$", {0: model_axis}),
    ]


def _block(p, x, dt, model_axis, attn_fn=None):
    """One transformer block over one layer's params ``p`` (the
    ``blocks/`` names without the prefix)."""
    h = _layer_norm(x, p, "ln1")
    q = tensor.column_parallel_dense(h, p["attn/wq"].to(dt))
    k = tensor.column_parallel_dense(h, p["attn/wk"].to(dt))
    v = tensor.column_parallel_dense(h, p["attn/wv"].to(dt))
    o = attn_fn(q, k, v) if attn_fn is not None \
        else _causal_attention(q, k, v)
    o = tensor.row_parallel_dense(o, p["attn/wo"].to(dt),
                                  p["attn/bo"].to(dt), model_axis,
                                  contract_dims=2)
    x = x + o
    h = _layer_norm(x, p, "ln2")
    h = tensor.column_parallel_dense(h, p["mlp/w1"].to(dt),
                                     p["mlp/b1"].to(dt))
    h = F.gelu(h, approximate="tanh")
    h = tensor.row_parallel_dense(h, p["mlp/w2"].to(dt),
                                  p["mlp/b2"].to(dt), model_axis)
    return x + h


def _stage_fn(dt, model_axis, attn_fn):
    """The pipeline's stage body: the rank-local (chunk of the) stack,
    block after block."""
    def stage_fn(blocks, h):
        return pipeline.stacked_scan(
            lambda p, hh: _block(p, hh, dt, model_axis, attn_fn), blocks, h)
    return stage_fn


def _blocks(params) -> dict:
    return {n[len(BLOCKS):]: t for n, t in params.items()
            if n.startswith(BLOCKS)}


def _embed(params, ids, cfg, model_axis):
    dt = cfg.dtype
    x = tensor.vocab_parallel_embed(params["embed"], ids, model_axis)
    x = (x * float(np.sqrt(cfg.d_model))).to(dt)
    # a static slice, not a gather: every position row is used each step
    return x + params["pos_embed"][:ids.shape[-1]].to(dt)[None]


def forward(params, input_ids, cfg: TPLMConfig, n_microbatches: int = 1,
            pipe_axis: str = const.PIPELINE_AXIS,
            model_axis: str = const.MODEL_AXIS,
            virtual_stages: int = 1, pp_shards: int = 0,
            remat_chunks: bool = False, attn_fn=None):
    """Logits over the (possibly vocab-sharded) vocabulary, the block stack
    through GPipe (``virtual_stages`` 1) or the interleaved schedule."""
    dt = cfg.dtype
    x = _embed(params, torch.as_tensor(input_ids), cfg, model_axis)
    stage_fn = _stage_fn(dt, model_axis, attn_fn)
    if virtual_stages > 1:
        x = pipeline.pipeline_apply_interleaved(
            stage_fn, _blocks(params), x, n_microbatches, virtual_stages,
            pipe_axis, pp_shards_hint=pp_shards, remat_chunks=remat_chunks)
    else:
        x = pipeline.pipeline_apply(stage_fn, _blocks(params), x,
                                    n_microbatches, pipe_axis)
    x = _layer_norm(x, params, "final_ln")
    return tensor.vocab_parallel_logits(x, params["embed"].to(dt))


def make_loss(cfg: TPLMConfig, n_microbatches: int = 1,
              model_axis: str = const.MODEL_AXIS, schedule: str = "gpipe",
              virtual_stages: int = 2, pp_shards: int = 0,
              remat_chunks: bool = False, attn_fn=None):
    """The JAX ``make_train_setup``'s loss, the mean next-token NLL of
    ``batch["tokens"]`` ``[B, S + 1]``, under ``schedule``, with
    ``attn_fn`` in the attention slot. Raises the JAX ``ValueError``s:
    an unknown schedule, ``remat_chunks`` outside the interleaved
    schedule, and the interleaved schedule without ``pp_shards >= 2``
    (without the stage count the unbound trace cannot emulate the
    schedule's layer order, physical chunk r*V+c = logical stage c*S+r,
    and would compute another network than the pipelined program)."""
    if schedule not in SCHEDULES:
        raise ValueError("schedule must be 'gpipe', '1f1b' or 'interleaved'")
    if remat_chunks and schedule != "interleaved":
        raise ValueError("remat_chunks=True requires "
                         "schedule='interleaved' (whole-program remat: "
                         "strategy.WithRemat)")
    if schedule == "interleaved" and pp_shards < 2:
        raise ValueError("schedule='interleaved' requires pp_shards>=2 "
                         "(the intended pipeline stage count)")
    vstages = virtual_stages if schedule == "interleaved" else 1

    def loss_gpipe(p, batch):
        tokens = torch.as_tensor(batch["tokens"])
        logits = forward(p, tokens[:, :-1], cfg, n_microbatches,
                         model_axis=model_axis, virtual_stages=vstages,
                         pp_shards=pp_shards, remat_chunks=remat_chunks,
                         attn_fn=attn_fn)
        nll = tensor.vocab_parallel_xent(logits, tokens[:, 1:], model_axis)
        return nll.mean()

    def loss_1f1b(p, batch):
        dt = cfg.dtype
        tokens = torch.as_tensor(batch["tokens"])
        x = _embed(p, tokens[:, :-1], cfg, model_axis)

        def head_fn(hp, h, y):
            h = _layer_norm(h, hp, "final_ln")
            logits = tensor.vocab_parallel_logits(h, hp["embed"].to(dt))
            return tensor.vocab_parallel_xent(logits, y, model_axis).mean()

        head = {n: p[n] for n in ("final_ln/scale", "final_ln/bias",
                                  "embed")}
        return pipeline.pipeline_loss_1f1b(
            _stage_fn(dt, model_axis, attn_fn), head_fn, _blocks(p), head,
            x, tokens[:, 1:].to(x.device), n_microbatches)

    return loss_1f1b if schedule == "1f1b" else loss_gpipe


def make_train_setup(cfg: Optional[TPLMConfig] = None, seq_len: int = 128,
                     batch_size: int = 8, seed: int = 0,
                     n_microbatches: int = 1,
                     model_axis: str = const.MODEL_AXIS,
                     schedule: str = "gpipe",
                     virtual_stages: int = 2, pp_shards: int = 0,
                     remat_chunks: bool = False):
    """(loss_fn, params, example_batch, apply_fn) for the AutoDist stack,
    the JAX function's: the plain causal attention (:func:`make_loss`
    takes an ``attn_fn``), a ``[batch_size, seq_len + 1]`` int32 token
    batch drawn from ``seed``. ``schedule="1f1b"`` trains through the
    fused 1F1B pipeline (the loss head inside the pipelined region);
    ``"interleaved"`` through the virtual-stage schedule, with
    ``pp_shards`` the intended stage count."""
    cfg = cfg or TPLMConfig()
    params = init_params(cfg, seed)
    loss_fn = make_loss(cfg, n_microbatches, model_axis, schedule,
                        virtual_stages, pp_shards, remat_chunks)
    vstages = virtual_stages if schedule == "interleaved" else 1
    npr = np.random.RandomState(seed)
    example_batch = {"tokens": npr.randint(
        0, cfg.vocab_size, (batch_size, seq_len + 1)).astype(np.int32)}

    def apply_fn(p, ids):
        return forward(p, ids, cfg, n_microbatches, model_axis=model_axis,
                       virtual_stages=vstages, pp_shards=pp_shards,
                       remat_chunks=remat_chunks)
    return loss_fn, params, example_batch, apply_fn
