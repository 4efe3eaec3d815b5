"""Embedding lookup with a sparse-gradient wire path (PyTorch counterpart
of ``autodist_tpu/ops/embedding.py``).

The reference synchronizes a lookup table's gradient as IndexedSlices:
AllReduce all-gathers their indices and values instead of densifying
(reference ``all_reduce_synchronizer.py:132-173``), and the PS path
ships them to the store, which splits them by index range (reference
``kernel/partitioner.py:660-684``). Autograd gives a gathered table a
DENSE gradient, so the sparse wire needs the lowering's cooperation:

**The tap trick.** ``embedding_lookup(table, ids, name=...)`` is an
ordinary ``F.embedding`` until the lowering opens a :func:`capture` that
names the table. Then the lookup computes ``F.embedding(ids,
table.detach()) + tap``, where ``tap`` is a zeros tensor shaped like the
gathered rows: the table gets NO dense gradient, while ``d loss / d
tap``, an input of the step's ``torch.autograd.grad``, IS exactly the
per-row gradient, and ``ids`` is already in hand. The step syncs the
batch-sized ``(ids, values)`` pair instead of a vocab-sized array:

- AllReduce: all-gather the pairs over the ranks (:func:`gather_pairs`)
  and scatter-add them into the update (:func:`scatter_add_dense`);
- host PS: push the pair to the store, which scatter-adds it into each
  shard's index range on the host (``parallel/ps.py``).

The JAX lowering makes the taps from a discovery trace's shapes, as
arguments of the traced step; eager PyTorch makes each tap at its lookup
(:meth:`SparseCapture.tap`), in call order, and the step differentiates
with respect to them after the forward. ``embedding_lookup`` with a
``name`` is the opt-in surface: a lookup-indexed variable whose lookups
carry no matching name syncs dense (with a warning), or raises under
``require_sparse``.
"""
import contextlib
import threading
from typing import Dict, Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from autodist_tpu_torch.telemetry import spans as tel

_TLS = threading.local()


class SparseCapture:
    """State of one step under the capture context.

    ``record=True`` (discovery): log each named lookup's ids count, so
    the lowering can tell routed tables from unrouted ones and price the
    wire. Otherwise (the step): each lookup of a table in ``names``
    makes a tap and keeps its ids."""

    def __init__(self, names: Iterable[str] = (), record: bool = False):
        self.names = frozenset(names)
        self.record = record
        self.ids: Dict[str, List[torch.Tensor]] = {}
        self.taps: Dict[str, List[torch.Tensor]] = {}
        # name -> the ids count of each lookup, in call order (record)
        self.counts: Dict[str, List[int]] = {}

    def tap(self, name: str, rows: torch.Tensor, ids: torch.Tensor):
        tap = torch.zeros_like(rows, requires_grad=True)
        self.taps.setdefault(name, []).append(tap)
        self.ids.setdefault(name, []).append(ids)
        return tap


def current_capture() -> Optional[SparseCapture]:
    return getattr(_TLS, "capture", None)


@contextlib.contextmanager
def capture(names: Iterable[str] = (), record: bool = False):
    prev = current_capture()
    cap = SparseCapture(names, record)
    _TLS.capture = cap
    try:
        yield cap
    finally:
        _TLS.capture = prev


def embedding_lookup(table: torch.Tensor, ids, name: Optional[str] = None
                     ) -> torch.Tensor:
    """Row lookup ``table[ids]`` with an optional sparse-gradient identity.

    ``name`` must be the table's parameter name (``"table_0.embedding"``)
    for the sparse wire path to engage; without it the op is exactly
    ``F.embedding(ids, table)``."""
    ids = torch.as_tensor(ids)
    cap = current_capture()
    if cap is None or name is None:
        return F.embedding(ids.long(), table)
    if cap.record:
        cap.counts.setdefault(name, []).append(int(ids.numel()))
        return F.embedding(ids.long(), table)
    if name not in cap.names:
        return F.embedding(ids.long(), table)
    rows = F.embedding(ids.long(), table.detach())
    return rows + cap.tap(name, rows, ids)


def discover(loss_fn, params, example_batch, candidate_names
             ) -> Tuple[Dict[str, List[int]], set]:
    """Trace the loss once on fake tensors (``model_item.trace_lookups``)
    under a recording capture: ``(routed, dense_uses)`` — for each
    candidate table that flowed through a named :func:`embedding_lookup`,
    the ids count of each lookup; and the variables with another
    differentiable use (a tied head, weight sharing)."""
    from autodist_tpu_torch.model_item import trace_lookups
    with capture(record=True) as cap:
        _, dense_uses = trace_lookups(loss_fn, params, example_batch)
    return ({n: c for n, c in cap.counts.items() if n in candidate_names},
            dense_uses)


def safe_sparse_names(routed, dense_uses) -> set:
    """The routed tables whose only gradient path is their lookups: a
    table with another differentiable use gets a real dense gradient that
    the sparse wire would drop, so it stays on the dense path."""
    return set(routed) - set(dense_uses)


def make_taps(cap: SparseCapture, names) -> List[torch.Tensor]:
    """The taps a step's capture made for ``names``, in name then call
    order: the inputs ``torch.autograd.grad`` differentiates for them."""
    return [t for n in names for t in cap.taps.get(n, [])]


def flatten_pairs(ids_list: List[torch.Tensor],
                  tap_grads: List[Optional[torch.Tensor]]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge a table's per-lookup (ids, values) into one flat pair: ids
    ``[L]`` int32, values ``[L, features]`` float32 (a lookup whose rows
    the loss never read has a zero gradient)."""
    flat_ids, flat_vals = [], []
    for ids, vals in zip(ids_list, tap_grads):
        n = int(ids.numel())
        flat_ids.append(ids.reshape(-1).to(torch.int32))
        flat_vals.append(vals.reshape(n, -1).to(torch.float32))
    return torch.cat(flat_ids), torch.cat(flat_vals, dim=0)


def gather_pairs(ids: torch.Tensor, vals: torch.Tensor, n: int,
                 group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-gather an (ids, values) pair over the ``n`` ranks of ``group``
    (None: the default group), concatenated in rank order — the sparse
    wire, batch-shaped (reference ``all_reduce_synchronizer.py:155-169``;
    the JAX ``all_gather(..., tiled=True)``). Counts the payload in
    ``sync.wire_bytes`` and in ``sync.sparse_wire_bytes``."""
    out = []
    for x in (ids, vals):
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        payload = x.numel() * x.element_size()
        tel.counter_add("sync.wire_bytes", payload)
        tel.counter_add("sync.sparse_wire_bytes", payload)
        out.append(torch.cat(parts))
    return out[0], out[1]


def scatter_add_dense(ids: torch.Tensor, vals: torch.Tensor, vocab: int,
                      feat_shape: Tuple[int, ...]) -> torch.Tensor:
    """(ids, values) -> the dense gradient (the densify after the wire).
    ``index_put_`` with ``accumulate=True`` sums a repeated id's rows in
    one order on every rank (on CUDA it sorts the ids; ``index_add_``'s
    atomics would not), so the replicas' updates stay bit-equal."""
    feat = 1
    for d in feat_shape:
        feat *= int(d)
    dense = torch.zeros((vocab, feat), dtype=vals.dtype, device=vals.device)
    dense.index_put_((ids.long(),), vals.reshape(-1, feat), accumulate=True)
    return dense.reshape((vocab,) + tuple(feat_shape))
