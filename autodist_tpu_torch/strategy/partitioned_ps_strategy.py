"""Shard-count helpers of ``autodist_tpu/strategy/partitioned_ps_strategy.py``.

The partitioned AllReduce builders split a variable into the smallest
divisor of the split dimension above 1, capped by the replica count, and
record the split as a partitioner string. The PartitionedPS builder
itself comes with the PS family (ROADMAP A item 8).
"""


def smallest_divisor_shards(dim0: int, max_shards: int) -> int:
    """Smallest divisor of dim0 in (1, max_shards]; 1 when none exists."""
    if dim0 <= 1 or max_shards <= 1:
        return 1
    best = 1
    for k in range(2, max_shards + 1):
        if dim0 % k == 0:
            return k
    return best


def make_partition_str(rank: int, axis: int, num_shards: int) -> str:
    counts = ["1"] * max(rank, 1)
    counts[axis] = str(num_shards)
    return ",".join(counts)
