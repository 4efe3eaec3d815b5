"""AllReduce synchronizer kernel (PyTorch counterpart of the unpartitioned
path of ``autodist_tpu/kernel/synchronization/all_reduce_synchronizer.py``).

Replaces each replica's gradient with the mean over the replicas: the
compressor's reduce around ``dist.all_reduce`` (SUM) on the process
group, divided by the replica count. ``wire_dtype="int8"`` substitutes
the ``Int8CompressorEF`` wire codec when no compressor is named; the
bucketing layer arms it (``parallel/collectives.py::bucket_reduce``).
``group`` (the bucket id), ``spec`` and ``schedule`` are recorded for the
bucketing layer; the lowering refuses the schedules the port has not
reached (``kernel/graph_transformer.py``).
"""
from autodist_tpu_torch.kernel.synchronization import \
    compressor as compressor_lib
from autodist_tpu_torch.kernel.synchronization.synchronizer import \
    Synchronizer


class AllReduceSynchronizer(Synchronizer):
    def __init__(self, var_name, config, num_replicas, process_group=None,
                 collective_name: str = ""):
        super().__init__(var_name, config, num_replicas, process_group)
        # PowerSGD seeds its Q from the name: the JAX spelling, so every
        # rank (and the JAX package) derives it from the same string
        key_name = collective_name or var_name
        self.compressor = compressor_lib.create(
            getattr(config, "compressor", None), key_name)
        self.wire_dtype = getattr(config, "wire_dtype", "fp32") or "fp32"
        if (self.wire_dtype == "int8"
                and self.compressor.name == "NoneCompressor"):
            self.compressor = compressor_lib.create("Int8CompressorEF",
                                                    key_name)
        self.group = getattr(config, "group", 0)
        self.spec = getattr(config, "spec", "AUTO")
        self.schedule = (getattr(config, "schedule", "auto")
                         or "auto").lower()

    def state_init(self, grad_shape, dtype):
        return self.compressor.state_init(grad_shape, dtype)

    def sync(self, grad, state):
        reduced, new_state = self.compressor.reduce(grad, state, self.psum)
        return reduced / self.num_replicas, new_state
