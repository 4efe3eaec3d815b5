"""Collectives over ``torch.distributed``: buckets and the int8 wire."""
