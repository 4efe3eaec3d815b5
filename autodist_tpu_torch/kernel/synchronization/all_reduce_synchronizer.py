"""AllReduce synchronizer kernel (PyTorch counterpart of
``autodist_tpu/kernel/synchronization/all_reduce_synchronizer.py``).

Replaces each replica's gradient with the mean over the replicas: the
compressor's reduce around ``dist.all_reduce`` (SUM) on the process
group, divided by the replica count. ``wire_dtype="int8"`` substitutes
the ``Int8CompressorEF`` wire codec when no compressor is named; the
bucketing layer arms it (``parallel/collectives.py::bucket_reduce``).
A partitioned variable (``layout.partitioned``) takes the
reduce-scatter path instead: each rank receives the summed gradient of
its own shard (``kernel/partitioner.py``) over the data axis's group
(``data_group``, ``n_data``), then its sum over the groups of the mesh's
other axes of size > 1 (``extra_groups``), divided by every process (the
JAX kernel's ``psum_extra`` of the reduce-scatter); a compressor or the
int8 wire is ignored there, with a warning, as in the JAX kernel.
``group`` (the bucket id), ``spec`` and ``schedule`` are recorded for the
bucketing layer, and pick this variable's sum (:meth:`psum`, the JAX
kernel's): ``schedule="rhd"`` is the reduce-scatter + all-gather
composition, ``spec="DCN"`` or ``schedule="hier"`` the hierarchical sum
over the resource spec's hosts (``host_groups``, set by the lowering
when the ranks span hosts; on one host it is the ring).

:meth:`AllReduceSynchronizer.launch` issues the collective and returns a
``collectives.Pending``; :meth:`sync` is launch-and-wait. The plain
(NoneCompressor) all-reduce and the reduce-scatter can be asynchronous
(the overlapped schedule launches them from backward hooks); a
compressor's reduce runs at launch, as it interleaves collectives with
local arithmetic.
"""
from autodist_tpu_torch.kernel.synchronization import \
    compressor as compressor_lib
from autodist_tpu_torch.kernel.synchronization.synchronizer import \
    Synchronizer
from autodist_tpu_torch.parallel import collectives
from autodist_tpu_torch.utils import logging


class AllReduceSynchronizer(Synchronizer):
    # the hosts' groups of the hierarchical schedule (set by the lowering
    # when the ranks span more than one host)
    host_groups = None

    def __init__(self, var_name, config, num_replicas, process_group=None,
                 collective_name: str = "", layout=None, *, n_data: int,
                 data_group=None, extra_groups=()):
        super().__init__(var_name, config, num_replicas, process_group)
        self.layout = layout
        self._set_data_axis(data_group, n_data, extra_groups)
        partitioned = layout is not None and layout.partitioned
        # PowerSGD seeds its Q from the name: the JAX spelling, so every
        # rank (and the JAX package) derives it from the same string
        key_name = collective_name or var_name
        self.compressor = compressor_lib.create(
            getattr(config, "compressor", None), key_name)
        self.wire_dtype = getattr(config, "wire_dtype", "fp32") or "fp32"
        if (self.wire_dtype == "int8" and not partitioned
                and self.compressor.name == "NoneCompressor"):
            self.compressor = compressor_lib.create("Int8CompressorEF",
                                                    key_name)
        self.group = getattr(config, "group", 0)
        self.spec = getattr(config, "spec", "AUTO")
        self.schedule = (getattr(config, "schedule", "auto")
                         or "auto").lower()
        if partitioned and self.compressor.name != "NoneCompressor":
            logging.warning("var %s: compressor %s is ignored on the "
                            "partitioned (reduce-scatter) path", var_name,
                            self.compressor.name)
        if partitioned and self.wire_dtype == "int8":
            logging.warning("var %s: wire_dtype=int8 is ignored on the "
                            "partitioned (reduce-scatter) path (ADT310)",
                            var_name)

    def _set_data_axis(self, data_group, n_data, extra_groups):
        """Where a partitioned variable's reduce-scatter runs: over the
        data axis (``n_data`` ranks of ``data_group``, None: the default
        group), then the sum over each extra axis's group."""
        self.data_group, self.n_data = data_group, int(n_data)
        self.extra_groups = tuple(extra_groups)

    def psum(self, x):
        """The sum over the replicas this variable's schedule names (the
        JAX kernel's ``psum``): ``DCN`` or ``hier`` across hosts lowers
        to the hierarchical form, ``rhd`` to reduce-scatter + all-gather,
        anything else (``hier`` on one host included) to the ring."""
        if (self.spec == "DCN" or self.schedule == "hier") \
                and self.host_groups is not None:
            return collectives.hierarchical_psum(x, self.host_groups)
        if self.schedule == "rhd":
            return collectives.rhd_psum(x, self.process_group,
                                        self.num_replicas)
        return super().psum(x)

    def _scheduled(self) -> bool:
        return self.schedule == "rhd" or (
            self.host_groups is not None
            and (self.spec == "DCN" or self.schedule == "hier"))

    def state_init(self, grad_shape, dtype):
        if self.layout is not None and self.layout.partitioned:
            return None
        return self.compressor.state_init(grad_shape, dtype)

    def launch(self, grad, state, async_op: bool = False):
        """Issue this variable's collective: a ``collectives.Pending`` of
        (the mean-reduced gradient — this rank's shard of it when
        partitioned —, the new state)."""
        N = self.num_replicas
        if self.layout is not None and self.layout.partitioned:
            pending = self.layout.reduce_scatter_grad_launch(
                grad, self.data_group, self.n_data, async_op)

            def finish():
                local = pending.wait()
                for extra in self.extra_groups:
                    local = collectives.all_reduce_sum_launch(
                        local, extra).wait()
                return local / N, state
            return collectives.Pending((), finish)
        if self.compressor.name == "NoneCompressor" and self._scheduled():
            return collectives.done((self.psum(grad) / N, state))
        if self.compressor.name == "NoneCompressor":
            pending = collectives.all_reduce_sum_launch(
                grad, self.process_group, async_op)
            return collectives.Pending((), lambda: (pending.wait() / N,
                                                    state))
        reduced, new_state = self.compressor.reduce(grad, state, self.psum)
        return collectives.done((reduced / N, new_state))

    def sync(self, grad, state):
        return self.launch(grad, state).wait()
