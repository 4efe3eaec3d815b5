"""Expert parallelism: Mixture-of-Experts with all-to-all token routing.

PyTorch counterpart of ``autodist_tpu/parallel/expert.py``. Experts are
stacked on a leading dim sharded over the ``expert`` mesh axis
(``VarConfig.mp_axes = {0: 'expert'}``); tokens go to their expert's
rank with one all-to-all each way (``parallel/mesh.py``; GShard, arXiv
2006.16668; Switch Transformer, arXiv 2101.03961). Routing is the JAX
function's dense one-hot dispatch and combine with a fixed capacity per
expert, as plain einsums: the same tokens are kept and dropped, and the
same products run, as in the JAX package, which computes them outside
any Pallas kernel.

Every helper is the one-rank function when the axis is not bound: one
process computes every expert locally.
"""
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from autodist_tpu_torch import const
from autodist_tpu_torch.parallel import mesh


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside ``[0, n)`` gives a zero
    row."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def top1_dispatch(router_probs: torch.Tensor, capacity: int):
    """Top-1 gating with capacity (Switch). router_probs [T, E] ->
    (dispatch [T, E, C] one-hot, combine [T, E, C] gated, aux_loss
    scalar). Tokens beyond an expert's capacity are dropped: their
    combine weights are zero, so they ride the residual connection
    only."""
    T, E = router_probs.shape
    dt = router_probs.dtype
    expert_idx = torch.argmax(router_probs, dim=-1)              # [T]
    gate = torch.gather(router_probs, 1, expert_idx[:, None])[:, 0]
    onehot = _one_hot(expert_idx, E, dt)                         # [T, E]
    # each token's position in its expert's queue (exact in float)
    pos = torch.cumsum(onehot, dim=0) * onehot - 1.0             # [T, E]
    keep = (pos >= 0) & (pos < capacity)
    pos_oh = _one_hot(pos.to(torch.int32), capacity, dt)         # [T, E, C]
    dispatch = pos_oh * keep.to(dt)[..., None]
    combine = dispatch * gate[:, None, None]
    # Switch aux load-balance loss: E * sum_e fraction_dispatched * mean_prob
    frac = onehot.mean(dim=0)
    mean_prob = router_probs.mean(dim=0)
    aux = E * torch.sum(frac * mean_prob)
    return dispatch, combine, aux


def _dispatch_a2a(x_ecd: torch.Tensor, axis_name: str) -> torch.Tensor:
    """[E, C, d] (inputs for every global expert, from local tokens) ->
    [E_local, N*C, d] (this rank's experts' inputs from every rank)."""
    n = mesh.binding(axis_name).size
    E, C, d = x_ecd.shape
    x = x_ecd.reshape(n, E // n, C, d)
    # rank r keeps expert group r from EVERY source rank; dim 0 of the
    # result indexes the source rank
    x = mesh.all_to_all(x, axis_name, split_axis=0, concat_axis=0)
    return x.transpose(0, 1).reshape(E // n, n * C, d)


def _combine_a2a(y_elcd: torch.Tensor, axis_name: str,
                 E: int) -> torch.Tensor:
    """The inverse of :func:`_dispatch_a2a`: [E_local, N*C, d] -> [E, C,
    d]."""
    n = mesh.binding(axis_name).size
    E_local, NC, d = y_elcd.shape
    C = NC // n
    y = y_elcd.reshape(E_local, n, C, d).transpose(0, 1)
    y = mesh.all_to_all(y.contiguous(), axis_name, split_axis=0,
                        concat_axis=0)
    return y.reshape(E, C, d)


def moe_ffn(x, router_w, w1, b1, w2, b2, capacity_factor: float = 2.0,
            axis_name: str = const.EXPERT_AXIS,
            dtype: Optional[torch.dtype] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-1 MoE feed-forward. Returns (output with x's shape, aux loss).

    - ``x``: [..., d] local activations, flattened to tokens;
    - ``router_w``: [d, E] (replicated);
    - ``w1``/``b1``/``w2``/``b2``: expert-stacked [E(, ...)]: this rank's
      shard in the step ([E_local, ...]) or the full stack outside;
    - capacity C = ceil(T_local / E * capacity_factor) tokens per expert
      per rank, so the tokens dropped depend on each rank's batch.

    The gelu is the tanh form (``jax.nn.gelu``'s default)."""
    dt = dtype or x.dtype
    d = x.shape[-1]
    lead = x.shape[:-1]
    tokens = x.reshape(-1, d)
    T = tokens.shape[0]
    b = mesh.binding(axis_name)
    n = 1 if b is None else b.size
    E = w1.shape[0] * n
    capacity = int(math.ceil(T / E * capacity_factor))

    logits = tokens.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    dispatch, combine, aux = top1_dispatch(probs, capacity)
    dispatch = dispatch.to(dt)
    combine = combine.to(dt)

    x_ecd = torch.einsum("td,tec->ecd", tokens, dispatch)        # [E, C, d]
    x_in = _dispatch_a2a(x_ecd, axis_name) if b is not None else x_ecd
    h = torch.einsum("ecd,edf->ecf", x_in, w1.to(dt)) \
        + b1.to(dt)[:, None]
    h = F.gelu(h, approximate="tanh")
    y = torch.einsum("ecf,efd->ecd", h, w2.to(dt)) + b2.to(dt)[:, None]
    if b is not None:
        y = _combine_a2a(y, axis_name, E)                        # [E, C, d]
    out = torch.einsum("tec,ecd->td", combine, y)
    return out.reshape(lead + (d,)), aux.float()
