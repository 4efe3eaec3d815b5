"""GraphTransformer — turns a compiled Strategy into the programs a Runner
executes.

PyTorch counterpart of ``autodist_tpu/kernel/graph_transformer.py``. JAX
lowers the plan to jitted SPMD programs; the port runs eagerly on one
device, so a "program" here is a Python callable that executes under
``torch.inference_mode()`` with the same ``(state, ps_vals, batch)``
signature the JAX programs have. This slice carries the serving programs
(:meth:`DistributedStep.predict_program`, :meth:`DistributedStep.
decode_program`); the training step, its gradient all-reduce and the
optimizer apply are the next slice.
"""
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from autodist_tpu_torch.strategy.base import Strategy
from autodist_tpu_torch.telemetry import spans as tel
from autodist_tpu_torch.train_state import TrainState


def _leading_rows(tree) -> int:
    """Leading dim of the first array leaf with one (0 if none)."""
    for leaf in pytree.tree_leaves(tree):
        shape = np.shape(leaf)
        if len(shape) >= 1:
            return int(shape[0])
    return 0


def _classify(out, rows: int):
    """Per-leaf batch mask: True for leaves whose leading dim is the
    feed's row count (per-example outputs), False for the rest — the
    rule the JAX lowering applies to its abstract output shapes."""
    return pytree.tree_map(
        lambda a: bool(rows) and np.ndim(a) >= 1 and np.shape(a)[0] == rows,
        out)


class ForwardProgram:
    """A forward-only fetch program plus its per-leaf batch classification
    (the JAX ``ForwardProgram``).

    ``batch_mask`` mirrors the fetch tree with one bool per leaf: True for
    per-example rows, False for anything else. Serving's padded-row
    masking and per-request fan-out consult it instead of comparing
    shapes at each call. JAX classifies from abstract shapes at lowering
    time; the eager port classifies at the first call (``classify``)."""

    def __init__(self, fn: Callable, classify: Callable):
        self.fn = fn
        self._classify = classify
        self._mask = None

    def __call__(self, state, ps_vals, batch):
        out = self.fn(state, ps_vals, batch)
        if self._mask is None:
            self._mask = self._classify(state, ps_vals, batch, out)
        return out

    @property
    def batch_mask(self):
        if self._mask is None:
            raise RuntimeError("a program's batch_mask is known after its "
                               "first call")
        return self._mask


class DistributedStep:
    """The executable plan on one device: parameter state init, and the
    serving programs built from user functions."""

    def __init__(self, *, strategy: Strategy, model_item, device,
                 metadata: Optional[dict] = None):
        self.strategy = strategy
        self.model_item = model_item
        self.device = torch.device(device)
        self.metadata = metadata or {}
        self.num_replicas = 1
        # no host-resident parameter-server variables in this slice: the
        # serving engine's snapshot is always the empty mapping
        self.ps_store = None
        self._predict_progs: Dict[tuple, ForwardProgram] = {}
        self._decode_progs: Dict[tuple, ForwardProgram] = {}

    def init_state(self, params, opt_state=None) -> TrainState:
        """Place ``params`` (``{name: tensor or numpy}``) on the device as
        float32 masters — the JAX package keeps f32 params and casts at
        compute (flax ``param_dtype``), and so does the port."""
        missing = set(self.model_item.var_infos) - set(params)
        if missing:
            raise ValueError("init params lack variables %s"
                             % sorted(missing))
        placed = {}
        for name, value in params.items():
            t = torch.as_tensor(value)
            if t.is_floating_point():
                t = t.float()
            placed[name] = t.to(self.device).contiguous()
        return TrainState(step=0, params=placed, opt_state=opt_state,
                          sync_state={})

    def gather_params(self, state: TrainState) -> dict:
        """The full params in their original names (one device holds them
        whole, so this is the state's own mapping, copied shallowly)."""
        return dict(state.params)

    def pull_ps(self) -> dict:
        """Current host-PS values: none in this slice."""
        return {}

    def _run(self, fn, state, payload):
        with torch.inference_mode(), tel.span("dstep.dispatch", "dstep",
                                              fused=False):
            out = fn(state.params, payload)
        tel.counter_add("dstep.dispatches")
        return out

    def predict_program(self, serve_fn: Callable,
                        donate_batch: bool = True,
                        example_batch=None) -> ForwardProgram:
        """The forward-only FETCH program behind the serving engine:
        ``serve_fn(full_params, batch)`` with no grads. Returns
        ``fn(state, ps_vals, batch) -> outputs`` with outputs left on the
        device.

        ``example_batch`` fixes the feed structure and classifies the
        outputs: an output leaf whose leading dim equals the example's
        row count is per-example, judged on the example's own outputs
        (the JAX lowering judges the same rule on abstract shapes; a
        large example makes the leading dim distinctive). ``donate_batch``
        is accepted for signature parity: eager programs free a request's
        buffers when the caller drops them."""
        del donate_batch
        if example_batch is None:
            example_batch = self.model_item.example_batch
        _, spec = pytree.tree_flatten(example_batch)
        key = (serve_fn, str(spec))
        if key not in self._predict_progs:
            rows = _leading_rows(example_batch)

            def run(state, ps_vals, batch):
                return self._run(serve_fn, state, batch)

            def classify(state, ps_vals, batch, out):
                if _leading_rows(batch) != rows:
                    from autodist_tpu_torch.remapper import Remapper
                    out = run(state, ps_vals,
                              Remapper(self.device).remap_feed(example_batch))
                return _classify(out, rows)
            self._predict_progs[key] = ForwardProgram(run, classify)
        return self._predict_progs[key]

    def decode_program(self, decode_fn: Callable,
                       example_dstate) -> ForwardProgram:
        """The decode-STEP program behind continuous batching:
        ``decode_fn(full_params, dstate)`` where ``dstate`` carries the
        slot-major KV caches and per-slot token/cursor/alive. The caches
        are updated IN PLACE (the JAX program donates them and returns
        new buffers; eager PyTorch writes the new rows into the same
        storage, so steady-state decode holds one cache allocation).
        Output leaves whose leading dim is the slot count are per-slot."""
        _, spec = pytree.tree_flatten(example_dstate)
        key = (decode_fn, str(spec))
        if key not in self._decode_progs:
            slots = _leading_rows(example_dstate)
            self._decode_progs[key] = ForwardProgram(
                lambda state, ps_vals, dstate: self._run(decode_fn, state,
                                                         dstate),
                lambda state, ps_vals, dstate, out: _classify(out, slots))
        return self._decode_progs[key]


class GraphTransformer:
    """Builds the :class:`DistributedStep` for a compiled strategy on one
    device (the JAX ``GraphTransformer.transform``)."""

    def __init__(self, compiled_strategy: Strategy, model_item, device):
        self._strategy = compiled_strategy
        self._item = model_item
        self._device = device

    def transform(self) -> DistributedStep:
        replicas = len(self._strategy.graph_config.replicas)
        if replicas > 1:
            raise NotImplementedError(
                "the port runs one replica on one device so far (plan has "
                "%d); multi-device data parallelism is a later slice"
                % replicas)
        return DistributedStep(strategy=self._strategy,
                               model_item=self._item, device=self._device,
                               metadata={"replicas": 1})
