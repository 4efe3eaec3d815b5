"""ProxyVariable — worker-local parameter caching.

A copy of ``autodist_tpu/kernel/common/proxy_variable.py`` (reference
``autodist/kernel/common/proxy_variable.py:74-191``). Where a
PS-synchronized variable rests between steps, and so which program the
step runs, follows ``local_replication``:

- ``cached=True`` (the reference's proxy, ``local_replication=True``):
  the variable rests on the device and the optimizer updates it there;
  only its gradient crosses the wire, as a mean all-reduce (a
  reduce-scatter when partitioned), ``kernel/synchronization/
  ps_synchronizer.py``;
- ``cached=False`` (no proxy, the reference's default): the variable and
  its optimizer state rest in HOST memory (``parallel/ps.py:PSStore``);
  every step pulls the value to the device and pushes the reduced
  gradient back, where the update applies on the host CPU.
"""
import dataclasses


@dataclasses.dataclass
class ProxyPlan:
    var_name: str
    cached: bool          # True: device-resident; False: host-PS-resident


class ProxyVariable:
    @staticmethod
    def plan(var_name: str, ps_config) -> ProxyPlan:
        """The at-rest placement of a PS-synchronized variable:
        ``local_replication`` toggles device-cached and host-resident."""
        return ProxyPlan(var_name,
                         cached=bool(getattr(ps_config, "local_replication",
                                             False)))
