"""Device-name resolution.

Analog of reference ``autodist/kernel/device/resolver.py:25-67``, which maps
AutoDist ``ip:GPU:0`` strings to TF ``/job:worker/task:i/device:GPU:0``
strings via the cluster spec. A copy of ``autodist_tpu/kernel/device/resolver.py``;
the canonical form is the normalized ``host:TYPE:index`` string plus
a deterministic *global ordinal* — the index of that device in the
deterministic device ordering used to build the mesh
(``parallel/mesh.py``). Determinism across independently-launched processes
is what makes every worker lower the same strategy identically (the
reference leans on sorted ip:port ordering the same way,
``cluster.py:73-82``).
"""
from typing import List

from autodist_tpu_torch.resource_spec import DeviceSpec, ResourceSpec


class DeviceResolver:
    def __init__(self, resource_spec: ResourceSpec):
        self._spec = resource_spec
        self._ordered: List[str] = [d.name_string() for d in resource_spec.devices]
        self._index = {name: i for i, name in enumerate(self._ordered)}

    def resolve(self, name: str) -> str:
        """Normalize a device string and validate it exists in the cluster."""
        canonical = DeviceSpec.from_string(name).name_string()
        if canonical not in self._index:
            # CPU host devices are allowed as PS destinations even when the
            # compute devices are accelerators (host-offloaded parameters).
            cpu_names = {d.name_string() for d in self._spec.cpu_devices}
            if canonical in cpu_names:
                return canonical
            raise ValueError("unknown device %r (cluster has %s)" % (name, self._ordered))
        return canonical

    def resolve_many(self, names) -> List[str]:
        return [self.resolve(n) for n in names]

    def global_ordinal(self, name: str) -> int:
        """Deterministic position of this device in the mesh device order."""
        canonical = DeviceSpec.from_string(name).name_string()
        if canonical in self._index:
            return self._index[canonical]
        # host CPU destinations map to the ordinal of the first compute
        # device on the same host (its owning process)
        host = DeviceSpec.from_string(name).host
        for i, dev in enumerate(self._ordered):
            if dev.split(":")[0] == host:
                return i
        raise ValueError("no device on host %s" % host)

    @property
    def ordered_devices(self) -> List[str]:
        return list(self._ordered)
