"""Build the port's CUDA kernels with ``nvcc`` at first use and load them
with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), named
by a hash of its source, every ``csrc/*.cuh`` header it may include and
the nvcc flags, under ``autodist_tpu_torch/build/`` (git-ignored).
:func:`build` starts one ``nvcc`` per source, all at once, and waits for
them; :func:`load` builds what is missing and returns the loaded library.
Nothing here runs at import time.
"""
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
KERNELS = ("flash_fwd", "flash_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# nvcc's output of the builds this process ran (ptxas register and
# shared-memory report included), by kernel name
build_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME, or put nvcc on PATH): "
                       "the port's CUDA kernels build from source at first use")


def library_path(name: str, csrc_dir: str = CSRC_DIR) -> str:
    """The library that ``csrc_dir/<name>.cu`` builds into: its name hashes
    the source, every header of ``csrc_dir`` (a header edit must not reuse
    a stale library) and the nvcc flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [os.path.join(csrc_dir, name + ".cu")] + \
            sorted(glob.glob(os.path.join(csrc_dir, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, "lib%s-%s.so" % (name,
                                                    digest.hexdigest()[:16]))


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    per source, all started together. Returns ``{name: library path}``;
    raises with nvcc's output when any build fails."""
    names = list(names)
    paths = {n: library_path(n) for n in names}
    todo = [n for n in names if not os.path.isfile(paths[n])]
    if not todo:
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for n in todo:
        tmp = "%s.tmp.%d" % (paths[n], os.getpid())
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, n + ".cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_logs[n] = out
        if proc.returncode != 0:
            failed.append("%s (nvcc exit %d):\n%s" % (n, proc.returncode, out))
            continue
        os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[name])
            _libs[name] = lib
        return lib
