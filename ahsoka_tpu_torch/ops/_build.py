"""Build and load the port's CUDA kernels (plain C interface + ctypes).

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into
``build/ahsoka_tpu_torch/lib<name>.so`` at the repository root (the
``build/`` directory is git-ignored).  The library is built at first use
and rebuilt when its source is newer, so a fresh checkout needs nothing
but the CUDA toolkit.  Sources never include PyTorch's headers: pointers
and the CUDA stream cross the boundary as ``c_void_p`` from
``tensor.data_ptr()`` and ``torch.cuda.current_stream().cuda_stream``,
which keeps a build to seconds.  Builds hold a file lock and replace the
library atomically (``utils/native.build_locked``), so concurrent
processes build each library once.

``--fmad=false`` keeps every float add and multiply a separately rounded
IEEE operation, the way the plain PyTorch versions round them.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

from ahsoka_tpu_torch.utils.native import REPO, build_locked

CSRC = os.path.join(REPO, "ahsoka_tpu_torch", "csrc")
BUILD_DIR = os.path.join(REPO, "build", "ahsoka_tpu_torch")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()                 # guards _NAME_LOCKS
_NAME_LOCKS: Dict[str, threading.Lock] = {}
# seconds spent in nvcc by this process, per library (0.0 when the
# library was already built and only loaded)
build_seconds: Dict[str, float] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build from source "
                       "and need the CUDA toolkit (nvcc on PATH or "
                       "/usr/local/cuda/bin)")


def load(name: str, extra_flags=()) -> ctypes.CDLL:
    """The loaded ``lib<name>.so``, building it first when it is missing
    or older than ``csrc/<name>.cu``.  Builds of different libraries may
    run at once (one lock per library)."""
    with _LOCK:
        lock = _NAME_LOCKS.setdefault(name, threading.Lock())
    with lock:
        if name in _LIBS:
            return _LIBS[name]
        src = os.path.join(CSRC, f"{name}.cu")
        lib_path = os.path.join(BUILD_DIR, f"lib{name}.so")
        build_seconds[name] = build_locked(
            lib_path, [src], lambda out: [nvcc_path(), *NVCC_FLAGS,
                                          *extra_flags, "-o", out, src])
        lib = ctypes.CDLL(lib_path)
        _LIBS[name] = lib
        return lib


def load_all(names) -> Dict[str, ctypes.CDLL]:
    """Load several libraries, running their nvcc builds in parallel."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(load, names)))
