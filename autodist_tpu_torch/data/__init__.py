"""Input pipeline: native record loading + device prefetch.

PyTorch counterpart of ``autodist_tpu/data/``:

- ``RecordFileWriter`` / ``RecordFileDataset``: fixed-shape binary record
  files read by the port's copy of the native C++ loader
  (``native/dataloader/``): mmap'd IO, per-epoch shuffling, and batch
  assembly on C++ threads that never take the GIL.
- ``DevicePrefetcher``: wraps any host-batch iterator and keeps the next
  batches' copies to the device in flight (pinned buffers and a side
  stream on ``cuda``) while the current step computes.
- ``text``: real text to LM record files.
"""
from autodist_tpu_torch.data.record_dataset import (RecordFileDataset,
                                                    RecordFileWriter)
from autodist_tpu_torch.data.prefetch import DevicePrefetcher

__all__ = ["RecordFileDataset", "RecordFileWriter", "DevicePrefetcher"]
