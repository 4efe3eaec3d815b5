"""Memory-lean softmax cross-entropy for big-vocab LM heads (PyTorch
counterpart of ``autodist_tpu/ops/xent.py``).

The standard head materializes ``logits [N, V]`` in f32 (lm1b at batch 64,
seq 128: 8192 tokens x 99 183 vocab = 3.25 GB) plus its softmax for the
backward. Here neither pass holds more than one ``[N, C]`` vocab chunk:

- forward: a loop over vocab chunks keeps the online logsumexp (running
  max and normalizer) and picks each token's target logit as its chunk
  passes;
- backward (a ``torch.autograd.Function``): recomputes each chunk's logits
  from the saved activations, forms ``softmax - onehot`` for that chunk
  only, and accumulates dx and the chunk's dW/db slices in place.

The layout is the JAX module's: each chunk reads its weight slice in
place, and a ragged final chunk is read at the clamped offset
``v - chunk`` with its overlap with the previous chunk masked dead, so
the weight is never padded or copied. Chunk math runs in f32, and targets
outside the vocab are clamped as ``take_along_axis`` clamps them. The
JAX module loops with ``lax.scan``; this one with a Python loop of
``torch.matmul`` per chunk, which is where a plain matrix product belongs.
"""
import torch

NEG_INF = -1e30


def _layout(v: int, chunk: int):
    """(effective chunk, number of chunks). The final chunk of a ragged
    vocab is read at the clamped offset ``v - chunk`` and its overlap
    with the previous chunk is masked dead."""
    chunk = min(chunk, v)
    return chunk, (v + chunk - 1) // chunk


def _chunk_logits(xf, wt, b, ci, chunk, v):
    """Chunk ``ci``'s f32 logits ``[N, C]`` read in place from the
    ``[V, D]`` weight view ``wt`` and bias ``b``, dead overlap columns set
    to ``NEG_INF``; also the chunk's ``start``, its weight slice (f32) and
    ``off``, the first live column."""
    off = ci * chunk
    start = min(off, v - chunk)
    wc = wt[start:start + chunk].float()                  # [C, D]
    logits = torch.matmul(xf, wc.t()) + b[start:start + chunk].float()
    if off > start:
        logits[:, :off - start] = NEG_INF
    return logits, start, wc, off


def _target_cols(targets, start, off, chunk):
    """Each target's column in the chunk (clipped) and whether the target
    falls in the chunk's live range."""
    local = targets - start
    inside = (targets >= off) & (local < chunk)
    return local.clamp(0, chunk - 1)[:, None], inside


class _ChunkedXent(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, b, targets, chunk):
        n = x.shape[0]
        v = w.shape[1]
        # clamp like take_along_axis in the standard path: an out-of-vocab
        # id must not silently yield nll = lse
        targets = targets.long().clamp(0, v - 1)
        chunk, nchunks = _layout(v, chunk)
        xf = x.float()
        wt = w.t()
        dev = x.device
        m = torch.full((n,), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((n,), dtype=torch.float32, device=dev)
        tgt = torch.zeros((n,), dtype=torch.float32, device=dev)
        for ci in range(nchunks):
            logits, start, _, off = _chunk_logits(xf, wt, b, ci, chunk, v)
            m_new = torch.maximum(m, logits.amax(dim=1))
            l = l * torch.exp(m - m_new) + torch.exp(
                logits - m_new[:, None]).sum(dim=1)
            col, inside = _target_cols(targets, start, off, chunk)
            tgt = torch.where(inside, logits.gather(1, col)[:, 0], tgt)
            m = m_new
        lse = m + torch.log(l.clamp_min(1e-30))
        ctx.save_for_backward(x, w, b, targets, lse)
        ctx.chunk = chunk
        return lse - tgt

    @staticmethod
    def backward(ctx, g):
        """d nll / d logit = softmax - onehot(target), chunk by chunk; dW
        and db accumulate into their slices (dead overlap columns add
        exact zeros)."""
        x, w, b, targets, lse = ctx.saved_tensors
        n, d = x.shape
        v = w.shape[1]
        chunk, nchunks = _layout(v, ctx.chunk)
        xf = x.float()
        gf = g.float()[:, None]
        wt = w.t()
        dx = torch.zeros((n, d), dtype=torch.float32, device=x.device)
        dwt = torch.zeros((v, d), dtype=w.dtype, device=w.device)
        db = torch.zeros((v,), dtype=b.dtype, device=b.device)
        for ci in range(nchunks):
            logits, start, wc, off = _chunk_logits(xf, wt, b, ci, chunk, v)
            p = logits.sub_(lse[:, None]).exp_()              # softmax chunk
            col, inside = _target_cols(targets, start, off, chunk)
            p.scatter_add_(1, col, -inside.float()[:, None])  # - onehot
            dlog = p.mul_(gf)                                 # [N, C]
            dx += torch.matmul(dlog, wc)
            dwt[start:start + chunk] += torch.matmul(dlog.t(), xf).to(w.dtype)
            db[start:start + chunk] += dlog.sum(dim=0).to(b.dtype)
        return dx.to(x.dtype), dwt.t(), db, None, None


def chunked_softmax_xent(x, w, b, targets, chunk: int = 8192):
    """Per-token negative log-likelihood of ``targets`` under the linear
    head ``x @ w + b``, never materializing the full ``[N, V]`` logits.

    x: [N, D] activations; w: [D, V] (the JAX kernel layout; pass a
    ``Dense`` weight ``[V, D]`` as ``weight.t()``, which the chunks then
    read contiguously); b: [V]; targets: [N] int. Returns nll [N] float32,
    differentiable in x, w and b (grads in their own dtypes)."""
    return _ChunkedXent.apply(x, w, b, targets, int(chunk))
