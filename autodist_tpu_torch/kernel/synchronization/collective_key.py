"""Deterministic collective keys (a copy of
``autodist_tpu/kernel/synchronization/collective_key.py``).

The reference generates group keys sequentially per device-set and
instance keys as md5(var_name) mod INT32, so that every worker, building
its program independently, agrees on collective identities without
communicating. ``torch.distributed`` orders collectives by issue order,
so these keys are the ordering authority: gradient buckets are
concatenated in instance-key order, which must be identical on every
rank for the bytes on the wire to line up. The port keys them on the
JAX package's variable names (``VarInfo.collective_name``), so both
packages lay a bucket out in the same member order.
"""
import hashlib

from autodist_tpu_torch.const import MAX_INT32


class CollectiveKey:
    _instance = None

    def __init__(self, group_leader: str = ""):
        self._group_keys = {}
        self._next_group = 1
        self.group_leader = group_leader

    @classmethod
    def get(cls) -> "CollectiveKey":
        if cls._instance is None:
            cls._instance = CollectiveKey()
        return cls._instance

    @classmethod
    def reset(cls):
        cls._instance = None

    def group_key(self, device_set) -> int:
        """Sequential key per canonical device set."""
        canon = ",".join(sorted(str(d) for d in device_set))
        if canon not in self._group_keys:
            self._group_keys[canon] = self._next_group
            self._next_group += 1
        return self._group_keys[canon]

    @staticmethod
    def instance_key(var_name: str) -> int:
        digest = hashlib.md5(var_name.encode()).hexdigest()
        return int(digest, 16) % MAX_INT32
