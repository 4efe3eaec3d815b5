"""Sequence-parallel strategy builder.

PyTorch counterpart of
``autodist_tpu/strategy/sequence_parallel_strategy.py``: the AllReduce
data-parallel plan with a second mesh axis, ``seq``, over which the
sequence dimension of the batch is sharded. The plan is framework-free,
so the builder emits the JAX builder's plan, byte for byte, for the same
variable list and spec.

The model must be SP-aware: attention through
``ops.attention.make_attn_fn`` (ring or Ulysses) and positions and losses
through ``parallel/sequence.py`` (``models/lm.py``'s
``make_sp_train_setup``, ``models/tp_lm.py``'s ``make_train_setup(
attention="ring" | "ulysses")``).
"""
from autodist_tpu_torch import const
from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce
from autodist_tpu_torch.strategy.base import Strategy


class SequenceParallelAR(AllReduce):
    """A ``{data, seq}`` mesh: the batch's rows over data, a sequence
    leaf's dim 1 over seq. ``seq_keys`` names the batch leaves whose dim 1
    is the sequence (None: every leaf of rank two or more; set it when the
    batch mixes token arrays with other such leaves, e.g. one-hot
    labels). ``attention`` is metadata: which attention the model
    should use."""

    def __init__(self, seq_shards: int, attention: str = "ring",
                 chunk_size: int = 128, all_reduce_spec: str = "AUTO",
                 compressor: str = "NoneCompressor", seq_keys=None):
        super().__init__(chunk_size, all_reduce_spec, compressor)
        if seq_shards < 1:
            raise ValueError("seq_shards must be >= 1")
        self.seq_shards = seq_shards
        self.attention = attention
        self.seq_keys = list(seq_keys) if seq_keys else None

    def build(self, model_item, resource_spec) -> Strategy:
        strategy = super().build(model_item, resource_spec)
        n_devices = len(strategy.graph_config.replicas)
        if n_devices % self.seq_shards != 0:
            raise ValueError("%d devices not divisible by seq_shards=%d"
                             % (n_devices, self.seq_shards))
        strategy.graph_config.mesh_shape = {
            const.DATA_AXIS: n_devices // self.seq_shards,
            const.SEQUENCE_AXIS: self.seq_shards,
        }
        strategy.graph_config.seq_axis = const.SEQUENCE_AXIS
        strategy.graph_config.seq_feed_keys = self.seq_keys
        return strategy
