"""Fixed-shape record files + the ctypes binding to the native loader.

PyTorch counterpart of ``autodist_tpu/data/record_dataset.py``, with the
same format and the same batches. Format "ADT1" (see
``native/dataloader/dataloader.cc``): a 20-byte header (magic,
n_records, record_bytes) followed by packed fixed-size records; a
``<path>.json`` sidecar describes the per-record field layout (name,
dtype, shape) so batches slice into a dict of numpy arrays. A file either
package writes reads in the other, and one seed gives the same batches in
the same order in both.

The loader is the port's own copy of the C++ source
(``autodist_tpu_torch/native/dataloader/dataloader.cc``), built at first
use with ``g++ -O2 -std=c++17 -shared -fPIC -pthread`` into the
git-ignored ``autodist_tpu_torch/build/``, named by a hash of the source
and flags (:func:`build_library`). Nothing builds at import time.
"""
import ctypes
import hashlib
import json
import os
import struct
import subprocess
import threading
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

from autodist_tpu_torch.utils import logging

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "native", "dataloader", "dataloader.cc")
BUILD_DIR = os.path.join(_PKG, "build")
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

_MAGIC = b"ADT1"
_HEADER = struct.Struct("<4sQQ")
_lock = threading.Lock()


def library_path() -> str:
    """The library the loader's source builds into: its name hashes the
    source and the compiler flags."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, "libadt_dataloader-%s.so"
                        % digest.hexdigest()[:16])


def build_library() -> str:
    """Compile the native loader with ``g++`` unless its library exists;
    returns the library's path. Raises with the compiler's output when
    the build fails."""
    path = library_path()
    if os.path.isfile(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    cxx = os.environ.get("CXX", "g++")
    tmp = "%s.tmp.%d" % (path, os.getpid())
    logging.info("building the native dataloader (%s)", SOURCE)
    out = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError("native dataloader build failed (%s exit %d):\n%s"
                           % (cxx, out.returncode, out.stderr))
    os.replace(tmp, path)
    return path


_DLL = None


def _dll():
    global _DLL
    with _lock:
        if _DLL is None:
            dll = ctypes.CDLL(build_library())
            dll.adl_open_sharded.restype = ctypes.c_void_p
            dll.adl_open_sharded.argtypes = [
                ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int,
                ctypes.c_uint64, ctypes.c_int, ctypes.c_uint64,
                ctypes.c_uint64, ctypes.c_uint64]
            dll.adl_next_batch.restype = ctypes.POINTER(ctypes.c_uint8)
            dll.adl_next_batch.argtypes = [ctypes.c_void_p,
                                           ctypes.POINTER(ctypes.c_uint64)]
            dll.adl_release_batch.argtypes = [ctypes.c_void_p,
                                              ctypes.c_uint64]
            dll.adl_close.argtypes = [ctypes.c_void_p]
            for f in (dll.adl_record_bytes, dll.adl_num_records,
                      dll.adl_batches_per_epoch):
                f.restype = ctypes.c_uint64
                f.argtypes = [ctypes.c_void_p]
            _DLL = dll
    return _DLL


class _Field:
    def __init__(self, name: str, dtype, shape: Sequence[int]):
        self.name = name
        self.dtype = np.dtype(dtype)
        self.shape = tuple(int(s) for s in shape)
        self.nbytes = int(self.dtype.itemsize * np.prod(self.shape or (1,)))

    def to_dict(self):
        return {"name": self.name, "dtype": self.dtype.str,
                "shape": list(self.shape)}


class RecordFileWriter:
    """Writes an ADT1 record file from dicts of fixed-shape arrays.

    >>> with RecordFileWriter("/tmp/train.adt",
    ...         fields=[("image", np.float32, (32, 32, 3)),
    ...                 ("label", np.int32, ())]) as w:
    ...     for image, label in samples:
    ...         w.write({"image": image, "label": label})
    """

    def __init__(self, path: str, fields: Sequence[Tuple]):
        self.path = path
        self.fields = [_Field(*f) for f in fields]
        self.record_bytes = sum(f.nbytes for f in self.fields)
        self._n = 0
        self._f = open(path, "wb")
        self._f.write(_HEADER.pack(_MAGIC, 0, self.record_bytes))

    def write(self, sample: Dict[str, np.ndarray]):
        buf = bytearray()
        for f in self.fields:
            # asarray, not ascontiguousarray, which makes a 0-d scalar 1-d
            arr = np.asarray(sample[f.name], dtype=f.dtype)
            if arr.shape != f.shape:
                raise ValueError("field %r: shape %s != declared %s"
                                 % (f.name, arr.shape, f.shape))
            buf += arr.tobytes()
        self._f.write(buf)
        self._n += 1

    def write_batch(self, samples: Dict[str, np.ndarray]):
        """Write N records in one call: each field is ``[N, *shape]``,
        packed through a structured array (no alignment padding)."""
        n = int(np.asarray(samples[self.fields[0].name]).shape[0])
        dt = np.dtype([(f.name, f.dtype, f.shape) for f in self.fields])
        assert dt.itemsize == self.record_bytes
        packed = np.empty(n, dt)
        for f in self.fields:
            arr = np.asarray(samples[f.name], dtype=f.dtype)
            if arr.shape != (n,) + f.shape:
                raise ValueError("field %r: shape %s != %s"
                                 % (f.name, arr.shape, (n,) + f.shape))
            packed[f.name] = arr
        self._f.write(packed.tobytes())
        self._n += n

    def close(self):
        if self._f is None:
            return
        self._f.seek(0)
        self._f.write(_HEADER.pack(_MAGIC, self._n, self.record_bytes))
        self._f.close()
        self._f = None
        with open(self.path + ".json", "w") as f:
            json.dump({"fields": [fl.to_dict() for fl in self.fields],
                       "n_records": self._n}, f, indent=1)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter may be shutting down
            pass


class RecordFileDataset:
    """Infinite shuffled batch stream over an ADT1 file, assembled by the
    native loader's worker threads.

    Batches are dicts of numpy arrays ``[batch, *field_shape]``. By default
    each batch owns its memory (one memcpy out of the native ring slot:
    safe to hold across steps and to hand to an asynchronous copy to the
    device). ``copy=False`` yields zero-copy views into the ring slot,
    valid only until the NEXT ``__next__`` call. Trailing records that do
    not fill a batch are dropped each epoch.

    ``shard=(index, count)`` restricts this loader to the strided record
    subset {i : i % count == index}: each rank loads its own disjoint
    1/count of the records (its shard of the global batch, which
    ``Remapper.remap_feed_local`` places).
    """

    def __init__(self, path: str, batch_size: int, shuffle: bool = True,
                 seed: int = 0, num_threads: int = 2, ring_slots: int = 4,
                 copy: bool = True, shard: Tuple[int, int] = (0, 1)):
        with open(path + ".json") as f:
            meta = json.load(f)
        self.fields = [_Field(d["name"], d["dtype"], d["shape"])
                       for d in meta["fields"]]
        self.batch_size = int(batch_size)
        self.shard = (int(shard[0]), int(shard[1]))
        self._handle = _dll().adl_open_sharded(
            path.encode(), self.batch_size, int(shuffle), seed, num_threads,
            ring_slots, self.shard[0], self.shard[1])
        if not self._handle:
            raise ValueError("could not open record file %s" % path)
        # the records THIS loader iterates (i % count == index)
        self.num_records = int(_dll().adl_num_records(self._handle))
        with open(path, "rb") as hf:
            _, n_global, _ = _HEADER.unpack(hf.read(_HEADER.size))
        self.num_records_global = int(n_global)
        self.batches_per_epoch = int(
            _dll().adl_batches_per_epoch(self._handle))
        self.record_bytes = int(_dll().adl_record_bytes(self._handle))
        self._copy = copy
        self._pending: Optional[int] = None

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        if self._handle is None:
            raise ValueError("dataset is closed")
        if self._pending is not None:
            _dll().adl_release_batch(self._handle, self._pending)
            self._pending = None
        idx = ctypes.c_uint64()
        ptr = _dll().adl_next_batch(self._handle, ctypes.byref(idx))
        if not ptr:
            raise StopIteration  # closed under our feet
        self._pending = idx.value
        flat = np.ctypeslib.as_array(
            ptr, shape=(self.batch_size * self.record_bytes,))
        batch, off = {}, 0
        # records are packed [record0, record1, ...]: view them as
        # [batch, record_bytes], then slice each field's byte range
        rows = flat.reshape(self.batch_size, self.record_bytes)
        for f in self.fields:
            raw = rows[:, off:off + f.nbytes]
            if self._copy:
                raw = raw.copy()   # owns its memory
            elif not raw.flags.c_contiguous:
                raw = np.ascontiguousarray(raw)
            batch[f.name] = raw.view(f.dtype).reshape(
                (self.batch_size,) + f.shape)
            off += f.nbytes
        if self._copy:
            _dll().adl_release_batch(self._handle, self._pending)
            self._pending = None
        return batch

    def close(self):
        if self._handle is not None:
            if self._pending is not None:
                _dll().adl_release_batch(self._handle, self._pending)
                self._pending = None
            _dll().adl_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        # release the worker threads, the mmap and the fd of a dataset
        # dropped without close()
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter may be shutting down
            pass
