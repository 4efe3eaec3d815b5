"""Pipeline parallelism: microbatches streamed through layer-stacked stages
over the ``pipe`` mesh axis.

PyTorch counterpart of ``autodist_tpu/parallel/pipeline.py``. The layer
stack's leading dim is sharded over the pipe axis (``VarConfig.mp_axes =
{0: 'pipe'}``); every pipe rank runs the same program on its slice, and
activations move rank to rank. Three schedules, each the JAX one tick for
tick:

- GPipe (:func:`pipeline_apply`, Huang et al. arXiv 1811.06965): M
  microbatches through S stages in M + S - 1 ticks; rank r runs
  microbatch m at tick r + m and hands its output to rank r + 1;
- interleaved virtual stages (:func:`pipeline_apply_interleaved`,
  Narayanan et al. arXiv 2104.04473): each rank holds V layer chunks,
  physical chunk ``r*V + c`` is logical stage ``c*S + r``, and the ring
  ``i -> (i+1) % S`` carries the chunk-boundary hops; M*V + S - 1 ticks;
- fused 1F1B (:func:`pipeline_loss_1f1b`): rank r runs the forward of
  microbatch m at tick ``r + 2m`` and its backward at ``2S-1-r + 2m``,
  activations go down the chain and cotangents up it on the same tick,
  and an S-slot circular stash of microbatch inputs bounds the
  activations held at S microbatches (GPipe holds M).

The rank-to-rank move is the JAX ``lax.ppermute``: :func:`ppermute`, an
autograd function whose backward moves the cotangent along the inverse
permutation (``parallel/mesh.py``, shared with the seq and expert axes).
Each move is one ``all_to_all_single`` over the pipe group with
zero-sized splits to the ranks that get nothing: a collective, so 1F1B's
two-way exchange (down and up on one tick, one call) cannot deadlock,
and gloo runs it on CUDA tensors (two ranks share one card, where NCCL
refuses them). Moves on the pipe axis are counted in the telemetry
counters ``pp.p2p_sends`` and ``pp.p2p_bytes`` (each non-empty payload a
rank sends, forward and backward).

The schedules are autograd functions of their own. GPipe and interleaved
keep each tick's stage graph from the forward and, in the backward, walk
the ticks in reverse, moving each cotangent along the inverse of the
tick's permutation (the ppermute's transpose) and calling
``torch.autograd.grad`` on that tick's graph. A tick's stage compute
that the JAX schedule runs and masks out (the bubble's, the last rank's
unused 1F1B forward) is skipped; a tick whose permutation carries
nothing on any pipe line makes no call; every other tick makes exactly
one move on every rank, so both ends always match.

Gradients follow the JAX conventions, so the lowering's complement-axes
sync (``kernel/graph_transformer.py``'s ``_mp_sync``: sum over the axes a
variable is not sharded over, divided by N) stays exact: the last
stage's outputs are broadcast to every pipe rank as the JAX ``psum`` of
``where(rank == S-1, outs, 0)``, whose backward sums the cotangents over
the pipe group, so pipe-sharded gradients come back S-inflated and dx
is nonzero on rank 0 only.

Unbound (one process, tracing, evaluation outside the step) every
function computes the JAX degenerate path: a plain sequential apply, or
for the interleaved schedule with ``pp_shards_hint`` the logical layer
order of the pipelined program.
"""
from typing import Callable, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree
from torch.utils.checkpoint import checkpoint

from autodist_tpu_torch import const
from autodist_tpu_torch.parallel import mesh
from autodist_tpu_torch.telemetry import spans as tel

Perm = mesh.Perm


def num_stages(axis_name: str = const.PIPELINE_AXIS) -> int:
    """The bound pipe axis's size (the JAX ``psum(1, axis)``); 1 when it
    is not bound."""
    b = mesh.binding(axis_name)
    return 1 if b is None else b.size


def stacked_scan(block_fn: Callable, stacked_params, h):
    """``block_fn(params_i, h) -> h`` for each leading-dim slice of the
    ``stacked_params`` tree in turn (the JAX ``lax.scan`` loop)."""
    leaves, spec = pytree.tree_flatten(stacked_params)
    for layer in zip(*(leaf.unbind(0) for leaf in leaves)):
        h = block_fn(pytree.tree_unflatten(list(layer), spec), h)
    return h


# ------------------------------------------------------------- the move
# The rank-to-rank move lives in parallel/mesh.py, shared with the seq and
# expert axes; these names are re-exported for the schedules below and
# for callers of this module.
_move, _permute, _inverse = mesh._move, mesh._permute, mesh._inverse
_PPermute, _psum = mesh._PPermute, mesh._all_reduce


def ppermute(x: torch.Tensor, perm: Perm,
             axis_name: str = const.PIPELINE_AXIS) -> torch.Tensor:
    """The JAX ``lax.ppermute`` over the bound axis ``axis_name`` (the
    pipe axis by default): :func:`parallel.mesh.ppermute`."""
    return mesh.ppermute(x, perm, axis_name)


def _broadcast_last(outs: torch.Tensor, b: mesh.AxisBinding) -> torch.Tensor:
    """The JAX ``psum(where(rank == S-1, outs, 0))``: the last pipe rank's
    ``outs`` on every rank of the line."""
    out = outs.clone() if b.index == b.size - 1 else torch.zeros_like(outs)
    dist.all_reduce(out, group=b.group)
    return out


# ------------------------------------------- GPipe and interleaved ticks


def _slot(t: int, r: int, S: int, M: int, V: int):
    """The JAX interleaved tick body's bookkeeping for rank ``r`` at tick
    ``t`` (GPipe is V = 1): ``(microbatch, chunk)``, or None when the
    rank idles."""
    q = t - r
    if not 0 <= q < M * V:
        return None
    blk = q % (V * S)
    c, j, k = blk // S, blk % S, q // (V * S)
    return k * S + j, c


def _tick_perm(t: int, S: int, M: int, V: int) -> List[Tuple[int, int]]:
    """The pairs of the tick's ring (GPipe's chain: V = 1) that carry an
    activation somebody uses: a working sender, and on the wraparound
    edge only a chunk that is not the last (the last chunk's output is
    collected, and rank 0 reads a fresh microbatch instead)."""
    perm = []
    for i in range(S):
        s = _slot(t, i, S, M, V)
        if s is None or (i == S - 1 and s[1] == V - 1):
            continue
        perm.append((i, (i + 1) % S))
    return perm


class _Schedule:
    """The static facts of one pipelined call."""

    def __init__(self, stage_fn, b, M, V, remat, spec):
        self.stage_fn, self.b, self.M, self.V = stage_fn, b, M, V
        self.remat, self.spec = remat, spec

    def chunks(self, leaves):
        """The V chunk trees of the rank-local stack (leading dim split
        into [V, L_local/V]) and their flat leaves."""
        V = self.V
        flat = [list(leaves)] if V == 1 else [
            [a.reshape((V, a.shape[0] // V) + a.shape[1:])[c]
             for a in leaves] for c in range(V)]
        return [pytree.tree_unflatten(f, self.spec) for f in flat], flat

    def apply(self, chunk, h):
        if self.remat:
            return checkpoint(self.stage_fn, chunk, h, use_reentrant=False)
        return self.stage_fn(chunk, h)


def _run_ticks(sch: _Schedule, x_mb, trees, keep: bool):
    """The forward ticks over the chunk ``trees``: the collected outputs
    (nonzero on the last rank) and, with ``keep``, each working tick's
    ``(microbatch, chunk, input, output)`` with its graph, by tick."""
    b, M, V = sch.b, sch.M, sch.V
    S, r = b.size, b.index
    outs = torch.zeros_like(x_mb)
    graphs, recv = {}, None
    for t in range(M * V + S - 1):
        slot, out = _slot(t, r, S, M, V), None
        if slot is not None:
            m, c = slot
            inp = x_mb[m] if (r == 0 and c == 0) else recv
            if keep:
                inp = inp.detach().requires_grad_()
            out = sch.apply(trees[c], inp)
            if keep:
                graphs[t] = (m, c, inp, out)
            if r == S - 1 and c == V - 1:
                outs[m] = out.detach()
        perm = _tick_perm(t, S, M, V)
        if perm:
            recv = _permute(out, perm, x_mb[0], b)
    return outs, graphs


class _Pipelined(torch.autograd.Function):
    """GPipe / interleaved over the bound pipe axis: the forward runs the
    ticks keeping each stage graph, the backward walks them in
    reverse."""

    @staticmethod
    def forward(ctx, sch, x, *leaves):
        M = sch.M
        x_mb = x.reshape((M, x.shape[0] // M) + x.shape[1:])
        with torch.enable_grad():
            params = [a.detach().requires_grad_(a.requires_grad)
                      for a in leaves]
            # the chunks are views of the leaves: grads are taken at them
            trees, flat = sch.chunks(params)
            outs, graphs = _run_ticks(sch, x_mb, trees, keep=True)
        ctx.sch, ctx.graphs, ctx.flat = sch, graphs, flat
        ctx.x_shape, ctx.leaves = x_mb.shape, [
            (tuple(a.shape), a.requires_grad) for a in params]
        return _broadcast_last(outs, sch.b).reshape(x.shape)

    @staticmethod
    def backward(ctx, grad):
        sch, graphs, flat = ctx.sch, ctx.graphs, ctx.flat
        b, M, V = sch.b, sch.M, sch.V
        S, r = b.size, b.index
        g_outs = _psum(grad, b).reshape(ctx.x_shape)
        want = [i for i, (_, rg) in enumerate(ctx.leaves) if rg]
        acc = [[None] * len(flat[0]) for _ in range(V)]
        dx = torch.zeros(ctx.x_shape, dtype=grad.dtype, device=grad.device) \
            if ctx.needs_input_grad[1] else None
        g_send = None            # the cotangent of this rank's last input
        for t in reversed(range(M * V + S - 1)):
            perm = _tick_perm(t, S, M, V)
            g_recv = _permute(g_send, _inverse(perm), g_outs[0], b) \
                if perm else None
            g_send = None
            if t not in graphs:
                continue
            m, c, inp, out = graphs.pop(t)
            g_out = g_outs[m] if (r == S - 1 and c == V - 1) else g_recv
            inputs = [inp] + [flat[c][i] for i in want]
            gs = torch.autograd.grad(out, inputs, g_out, allow_unused=True)
            for i, g in zip(want, gs[1:]):
                if g is not None:
                    acc[c][i] = g if acc[c][i] is None else acc[c][i] + g
            if r == 0 and c == 0:
                if dx is not None:
                    dx[m] = gs[0]
            else:
                g_send = gs[0]
        grads = []
        for i, (shape, rg) in enumerate(ctx.leaves):
            if not rg:
                grads.append(None)
                continue
            parts = [acc[c][i] if acc[c][i] is not None
                     else torch.zeros_like(flat[c][i]) for c in range(V)]
            grads.append(parts[0] if V == 1
                         else torch.stack(parts).reshape(shape))
        ctx.graphs = ctx.flat = None
        return (None, None if dx is None else dx.reshape(grad.shape),
                *grads)


def _pipelined(stage_fn, stage_params, x, M, V, b, remat):
    B = x.shape[0]
    if B % M != 0:
        raise ValueError("batch %d not divisible by %d microbatches"
                         % (B, M))
    leaves, spec = pytree.tree_flatten(stage_params)
    sch = _Schedule(stage_fn, b, M, V, remat, spec)
    if torch.is_grad_enabled() and (x.requires_grad or any(
            a.requires_grad for a in leaves)):
        return _Pipelined.apply(sch, x, *leaves)
    x_mb = x.reshape((M, B // M) + x.shape[1:])
    outs, _ = _run_ticks(sch, x_mb, sch.chunks(leaves)[0], keep=False)
    return _broadcast_last(outs, b).reshape(x.shape)


def pipeline_apply(stage_fn: Callable, stage_params, x,
                   n_microbatches: int,
                   axis_name: str = const.PIPELINE_AXIS):
    """Run ``x`` through the whole layer stack, pipelined over
    ``axis_name`` with the GPipe schedule (the JAX ``pipeline_apply``).

    - ``stage_fn(stage_params, h) -> h`` applies this rank's layer chunk
      (``stage_params`` leaves are its ``[L/S, ...]`` slices);
      activation shapes are uniform across stages;
    - ``x``: this data replica's activations ``[B, ...]``, the same on
      every pipe rank, split into ``n_microbatches`` along dim 0;
    - returns the last stage's output for the whole batch on every pipe
      rank. Unbound: ``stage_fn(stage_params, x)``."""
    b = mesh.binding(axis_name)
    if b is None:
        return stage_fn(stage_params, x)
    return _pipelined(stage_fn, stage_params, x, n_microbatches, 1, b,
                      False)


def pipeline_apply_interleaved(stage_fn: Callable, stage_params, x,
                               n_microbatches: int, virtual_stages: int,
                               axis_name: str = const.PIPELINE_AXIS,
                               pp_shards_hint: int = 0,
                               remat_chunks: bool = False):
    """The interleaved (virtual-stage) schedule (the JAX
    ``pipeline_apply_interleaved``): each rank runs ``virtual_stages``
    layer chunks; microbatch m's stage s runs at slot ``(s mod S) +
    (s//S)*S + (m mod S) + (m//S)*V*S``, so consecutive stages land on
    consecutive slots of ring-adjacent ranks. Needs ``n_microbatches %
    S == 0`` and the rank-local stack divisible by V.

    Unbound, with ``pp_shards_hint`` S > 1 it applies physical chunk
    ``(s % S)*V + s//S`` for logical stage s = 0..S*V-1, the layer order
    the pipelined program computes; without a hint the plain stack
    (the same network only at S = 1). ``remat_chunks`` runs each slot's
    chunk under ``torch.utils.checkpoint`` (only the slot's input is
    kept; the chunk recomputes in the backward), the same values."""
    V = int(virtual_stages)
    if V < 1:
        raise ValueError("virtual_stages must be >= 1")
    b = mesh.binding(axis_name)
    if b is None:
        S = int(pp_shards_hint)
        if S <= 1:
            return stage_fn(stage_params, x)
        leaves, spec = pytree.tree_flatten(stage_params)
        h = x
        for s in range(S * V):
            g = (s % S) * V + s // S
            chunk = [a.reshape((S * V, a.shape[0] // (S * V))
                               + a.shape[1:])[g] for a in leaves]
            h = stage_fn(pytree.tree_unflatten(chunk, spec), h)
        return h
    M = n_microbatches
    if M % b.size != 0:
        raise ValueError(
            "interleaved schedule needs n_microbatches (%d) divisible by "
            "pipeline stages (%d)" % (M, b.size))
    return _pipelined(stage_fn, stage_params, x, M, V, b, remat_chunks)


# ----------------------------------------------------------------- 1F1B


def _on(t: int, start: int, M: int):
    """The microbatch a 1F1B tick ``t`` runs for a phase starting at
    ``start`` (ticks ``start + 2m``), or None."""
    d = t - start
    if d < 0 or d % 2 or d // 2 >= M:
        return None
    return d // 2


def _run_1f1b(run, x, y, leaves, grad: bool):
    """The 1F1B ticks: (the loss, each leaf's gradient or None, dx) in the
    JAX packaging; without ``grad`` only the loss (the backward ticks of
    the last rank run the head, no cotangent moves)."""
    stage_fn, head_fn, b, M, spec_s, spec_h, n_s = run
    S, r = b.size, b.index
    is_last = r == S - 1
    B = x.shape[0]
    x_mb = x.reshape((M, B // M) + x.shape[1:])
    y_mb = torch.as_tensor(y, device=x.device)
    y_mb = y_mb.reshape((M, B // M) + y_mb.shape[1:])
    params = [a.detach().requires_grad_(grad and a.requires_grad)
              for a in leaves]
    stage_tree = pytree.tree_unflatten(params[:n_s], spec_s)
    head_tree = pytree.tree_unflatten(params[n_s:], spec_h)
    want = [a for a in params if a.requires_grad]
    acc = [torch.zeros_like(a) for a in want]
    want_x = grad and (r > 0 or x.requires_grad)
    dx = torch.zeros_like(x_mb)
    loss = torch.zeros((), dtype=torch.float32, device=x.device)
    stash: List[Optional[torch.Tensor]] = [None] * S
    live = peak = 0
    fwd_in = bwd_in = None
    like = x_mb[0]
    for t in range(2 * M + 2 * S - 2):
        sends = {}
        fm, bm = _on(t, r, M), _on(t, 2 * S - 1 - r, M)
        if fm is not None:
            inp = x_mb[fm] if r == 0 else fwd_in
            if stash[fm % S] is not None:
                raise RuntimeError("1F1B stash slot %d reused before its "
                                   "backward" % (fm % S))
            stash[fm % S] = inp
            live += 1
            peak = max(peak, live)
            if not is_last:
                # the last rank's forward output is never sent: its
                # backward tick recomputes it
                with torch.no_grad():
                    sends[r + 1] = stage_fn(stage_tree, inp)
        if bm is not None:
            h_in, stash[bm % S] = stash[bm % S], None
            live -= 1
            if grad or is_last:
                with torch.enable_grad() if grad else torch.no_grad():
                    h = h_in.detach().requires_grad_(want_x)
                    out = stage_fn(stage_tree, h)
                    if is_last:
                        loss_mb = head_fn(head_tree, out, y_mb[bm])
                        loss = loss + loss_mb.detach().float()
                        root, g_root = loss_mb, torch.ones_like(loss_mb)
                    else:
                        root, g_root = out, bwd_in
                    inputs = ([h] if want_x else []) + want
                    gs = torch.autograd.grad(root, inputs, g_root,
                                             allow_unused=True) \
                        if grad and inputs else []
                if want_x:
                    dh, gs = gs[0], gs[1:]
                    if r == 0:
                        dx[bm] = dh
                    else:
                        sends[r - 1] = dh
                for a, g in zip(acc, gs):
                    if g is not None:
                        a.add_(g)
        # activations down the chain, cotangents up it: one move
        recvs = {}
        if r > 0 and _on(t, r - 1, M) is not None:
            recvs[r - 1] = like.shape
        if grad and not is_last and _on(t, 2 * S - 2 - r, M) is not None:
            recvs[r + 1] = like.shape
        if _any_1f1b_move(t, S, M, grad):
            got = _move(sends, recvs, like, b)
            fwd_in, bwd_in = got.get(r - 1), got.get(r + 1)
    tel.gauge_set("pp.stash_slots", S)
    tel.gauge_set("pp.stash_peak", peak)
    # the JAX packaging: the loss / M broadcast from the last rank, stage
    # grads x S/M, head grads summed over the pipe ranks / M, dx x S/M on
    # rank 0 only
    loss = _broadcast_last(loss / M, b)
    if not grad:
        return loss, None, None
    it = iter(acc)
    grads = []
    for i, a in enumerate(params):
        g = next(it) if a.requires_grad else None
        if g is not None:
            g = g * (S / M) if i < n_s else _psum(g / M, b)
        grads.append(g)
    dx = dx.reshape(x.shape) * (S / M) if r == 0 else torch.zeros_like(x)
    return loss, grads, dx


class _OneFOneB(torch.autograd.Function):
    """The fused 1F1B loss: the forward runs the whole schedule once,
    forward and backward ticks, and keeps the gradients; the backward
    scales them by the incoming cotangent (the JAX custom VJP)."""

    @staticmethod
    def forward(ctx, run, x, y, *leaves):
        loss, ctx.grads, ctx.dx = _run_1f1b(run, x, y, leaves, grad=True)
        return loss

    @staticmethod
    def backward(ctx, g):
        grads = [None if a is None else (a * g).to(a.dtype)
                 for a in ctx.grads]
        dx = (ctx.dx * g).to(ctx.dx.dtype)
        ctx.grads = ctx.dx = None
        return (None, dx, None, *grads)


def _any_1f1b_move(t: int, S: int, M: int, grad: bool) -> bool:
    """Does any pipe rank send at 1F1B tick ``t``?"""
    return any((i < S - 1 and _on(t, i, M) is not None)
               or (grad and i > 0 and _on(t, 2 * S - 1 - i, M) is not None)
               for i in range(S))


def pipeline_loss_1f1b(stage_fn: Callable, head_fn: Callable, stage_params,
                       head_params, x, y, n_microbatches: int,
                       axis_name: str = const.PIPELINE_AXIS):
    """The pipelined loss under the fused 1F1B schedule (the JAX
    ``pipeline_loss_1f1b``): ``stage_fn(stage_params, h) -> h`` is this
    rank's layer chunk, ``head_fn(head_params, h, y) -> scalar`` the
    microbatch loss head, run at the last stage inside the schedule so
    that backward microbatches interleave with forward ones.
    Differentiable in ``stage_params``, ``head_params`` and ``x``; the
    loss-and-gradient costs one sweep. Unbound: ``head_fn(head_params,
    stage_fn(stage_params, x), y)``."""
    b = mesh.binding(axis_name)
    if b is None:
        return head_fn(head_params, stage_fn(stage_params, x), y)
    M = n_microbatches
    if x.shape[0] % M != 0:
        raise ValueError("batch %d not divisible by %d microbatches"
                         % (x.shape[0], M))
    s_leaves, spec_s = pytree.tree_flatten(stage_params)
    h_leaves, spec_h = pytree.tree_flatten(head_params)
    leaves = s_leaves + h_leaves
    run = (stage_fn, head_fn, b, M, spec_s, spec_h, len(s_leaves))
    if torch.is_grad_enabled() and (x.requires_grad or any(
            a.requires_grad for a in leaves)):
        return _OneFOneB.apply(run, x, y, *leaves)
    return _run_1f1b(run, x, y, leaves, grad=False)[0]
