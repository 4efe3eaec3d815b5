"""Tensor (model) parallelism: Megatron-sharded compute over the ``model``
mesh axis.

PyTorch counterpart of ``autodist_tpu/parallel/tensor.py``. Column-parallel
matmuls make sharded activations with no communication, row-parallel
matmuls sum partial products with one all-reduce over the model axis's
process group, and the embedding and the softmax run vocab-parallel
(Shoeybi et al., Megatron-LM, arXiv 1909.08053). Every helper is the
plain, unsharded function when the axis is not bound
(``parallel/mesh.py``), so one model definition serves one process,
tracing and the sharded step.

The gradient follows the JAX package's convention, not Megatron's f/g
pair: under ``shard_map`` the transpose of ``psum`` is ``psum``, so the
all-reduce's backward all-reduces the cotangent over the same group
(:class:`_AllReduce`), and a column-parallel input gets no operator of
its own. Each rank's backward then gives the gradient of the sum of all
ranks' losses with respect to its own copies, which the step's sync
divides by the total device count (``kernel/graph_transformer.py``), as
the JAX lowering's ``psum(complement) / N`` does.

The forward collectives are counted in the telemetry counters
``tp.fwd_allreduces`` and ``tp.fwd_allreduce_bytes``.
"""
import torch
import torch.distributed as dist

from autodist_tpu_torch import const
from autodist_tpu_torch.ops.embedding import embedding_lookup
from autodist_tpu_torch.parallel import mesh
from autodist_tpu_torch.telemetry import spans as tel


def _count(t: torch.Tensor) -> None:
    tel.counter_add("tp.fwd_allreduces")
    tel.counter_add("tp.fwd_allreduce_bytes", t.numel() * t.element_size())


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM):
    return mesh.all_reduce_(x.contiguous().clone(), group, op)


class _AllReduce(torch.autograd.Function):
    """Sum over the group in the forward; the backward sums the cotangent
    over the same group (the transpose of ``psum``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        _count(x)
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


def reduce_model_parallel(x: torch.Tensor,
                          axis_name: str = const.MODEL_AXIS) -> torch.Tensor:
    """All-reduce partial products over the model axis (the Megatron "g"
    in the forward), in ``x``'s dtype. The identity when unbound."""
    b = mesh.binding(axis_name)
    if b is None:
        return x
    return _AllReduce.apply(x, b.group)


def _tensordot(x, kernel, contract: int):
    """Contract the last ``contract`` dims of ``x`` with the first
    ``contract`` dims of ``kernel`` (``jnp.tensordot``)."""
    return torch.tensordot(x, kernel,
                           dims=(list(range(x.dim() - contract, x.dim())),
                                 list(range(contract))))


def column_parallel_dense(x, kernel, bias=None):
    """Column-parallel matmul: the kernel's OUTPUT dim is sharded over the
    model axis and the caller passes its local shard (which may have more
    than 2 dims: ``[d_model, heads_local, head_dim]``); contracts ``x``'s
    last dim with the kernel's first. Local compute, no communication."""
    y = _tensordot(x, kernel, 1)
    if bias is not None:
        y = y + bias
    return y


def row_parallel_dense(x, kernel, bias=None,
                       axis_name: str = const.MODEL_AXIS,
                       contract_dims: int = 1):
    """Row-parallel matmul: the kernel's INPUT dim(s) are sharded over the
    model axis and ``x`` is the matching sharded activation; the partial
    products are all-reduced, then the (replicated) bias is added.
    ``contract_dims``: how many leading kernel dims to contract (2 for an
    attention out-projection ``[heads_local, head_dim, d_model]``)."""
    y = reduce_model_parallel(_tensordot(x, kernel, contract_dims),
                              axis_name)
    if bias is not None:
        y = y + bias
    return y


def vocab_parallel_embed(table, ids, axis_name: str = const.MODEL_AXIS,
                         name: str = "embed"):
    """Lookup in a table whose vocab dim is sharded over the model axis:
    each rank looks up the ids it owns, the others contribute zeros, and
    one all-reduce assembles the rows (Megatron VocabParallelEmbedding).
    An id no rank owns gives a NaN row, as the one-process lookup of a
    bad id fails loudly. Unbound: ``ops.embedding.embedding_lookup(
    name=name)``, so the sparse-wire discovery sees the lookup."""
    b = mesh.binding(axis_name)
    ids = torch.as_tensor(ids)
    if b is None:
        return embedding_lookup(table, ids, name=name)
    v_local = table.shape[0]
    local_ids = ids.long() - b.index * v_local
    ok = (local_ids >= 0) & (local_ids < v_local)
    emb = embedding_lookup(table, local_ids.clamp(0, v_local - 1), name=name)
    emb = torch.where(ok[..., None], emb, torch.zeros((), dtype=emb.dtype,
                                                      device=emb.device))
    out = reduce_model_parallel(emb, axis_name)
    found = ok.to(out.dtype)
    _count(found)
    found = _all_reduce(found, b.group)
    return torch.where(found[..., None] > 0, out,
                       torch.full((), float("nan"), dtype=out.dtype,
                                  device=out.device))


def vocab_parallel_logits(x, table):
    """The output projection onto a vocab-sharded (tied) table: the logits'
    columns stay sharded; pair with :func:`vocab_parallel_xent`."""
    return torch.tensordot(x, table, dims=([x.dim() - 1], [1]))


def vocab_parallel_xent(logits, targets, axis_name: str = const.MODEL_AXIS):
    """Per-token negative log-likelihood of ``logits`` whose vocab (last)
    dim is sharded over the model axis: the max over the ranks (no
    gradient: it cancels in the softmax), the sum of exponentials over
    them in float32, and the target's logit from the rank that owns it
    (Megatron vocab_parallel_cross_entropy). Out-of-range targets clamp to
    a class in both branches, as ``ops/xent.py`` does. Returns float32 of
    ``targets``' shape."""
    b = mesh.binding(axis_name)
    targets = torch.as_tensor(targets, device=logits.device).long()
    if b is None:
        v_total = logits.shape[-1]
        logp = torch.log_softmax(logits.float(), dim=-1)
        t = targets.clamp(0, v_total - 1)
        return -torch.gather(logp, -1, t[..., None])[..., 0]
    # the max runs in float32: every value of the logits' dtype is one,
    # so it is the max the JAX pmax takes in that dtype
    m = logits.detach().amax(dim=-1).float()
    _count(m)
    m = _all_reduce(m, b.group, dist.ReduceOp.MAX).to(logits.dtype)
    e = torch.exp(logits.float() - m[..., None].float())
    denom = reduce_model_parallel(e.sum(dim=-1), axis_name)
    v_local = logits.shape[-1]
    targets = targets.clamp(0, v_local * b.size - 1)
    local_t = targets - b.index * v_local
    ok = (local_t >= 0) & (local_t < v_local)
    picked = torch.gather(logits, -1,
                          local_t.clamp(0, v_local - 1)[..., None])[..., 0]
    picked = torch.where(ok, picked.float(),
                         torch.zeros((), device=logits.device))
    target_logit = reduce_model_parallel(picked, axis_name)
    return m.float() + torch.log(denom) - target_logit
