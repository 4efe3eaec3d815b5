"""PS synchronizer kernel for the PROXIED case (PyTorch counterpart of
``autodist_tpu/kernel/synchronization/ps_synchronizer.py``).

A PS variable with ``local_replication=False`` (no proxy) takes the host
data path of ``parallel/ps.py`` and never instantiates this kernel. A
proxied one (``local_replication=True``, the reference's worker-local
cache) rests on the device, and the reference's synchronous dance — push
the gradients, the owner averages them over the workers and applies,
the workers wait for its token — is one mean all-reduce followed by the
same update on every replica: every rank leaves the step with the
identical value. A partitioned proxied variable reduce-scatters to its
shard instead. The kernel is the AllReduce kernel's plain path: no
compressor and the fp32 wire, whatever the config says (an int8 wire or
``sync=False`` on a proxy is warned and ignored, as in the JAX kernel).
"""
from autodist_tpu_torch.kernel.synchronization import \
    compressor as compressor_lib
from autodist_tpu_torch.kernel.synchronization.all_reduce_synchronizer \
    import AllReduceSynchronizer
from autodist_tpu_torch.kernel.synchronization.synchronizer import \
    Synchronizer
from autodist_tpu_torch.utils import logging


class PSSynchronizer(AllReduceSynchronizer):
    def __init__(self, var_name, config, num_replicas, process_group=None,
                 collective_name: str = "", layout=None):
        Synchronizer.__init__(self, var_name, config, num_replicas,
                              process_group)
        self.layout = layout
        self.compressor = compressor_lib.create(None, collective_name
                                                or var_name)
        self.wire_dtype = "fp32"
        self.group, self.spec, self.schedule = 0, "AUTO", "auto"
        self.reduction_destination = getattr(config, "reduction_destination",
                                             "")
        self.local_replication = getattr(config, "local_replication", False)
        self.sync_mode = getattr(config, "sync", True)
        self.staleness = getattr(config, "staleness", 0)
        if (getattr(config, "wire_dtype", "fp32") or "fp32") == "int8":
            logging.warning(
                "var %s: wire_dtype=int8 with local_replication=True is "
                "ignored — a proxied PS var is device-resident and its "
                "sync is an on-device all-reduce, no host wire exists "
                "(ADT310)", var_name)
        if not self.sync_mode:
            logging.warning(
                "var %s: sync=False with local_replication=True is "
                "contradictory — a device-cached proxy updates in lockstep; "
                "drop the proxy to get the async host-PS path", var_name)
