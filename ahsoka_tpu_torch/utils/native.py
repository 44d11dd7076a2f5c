"""Build the port's shared libraries at first use, safely across processes.

The native C++ helpers (``native/*.cpp`` at the repository root, read by
path) compile with g++ into ``build/ahsoka_tpu_torch/native/``, and the
CUDA kernels (``ahsoka_tpu_torch/csrc``) with nvcc into
``build/ahsoka_tpu_torch/`` (``ops/_build.py``); ``build/`` is
git-ignored.  A library is rebuilt when it is missing or older than one
of its sources.  Each build holds an ``fcntl.flock`` on a lock file beside
the library, so concurrent processes (test workers, a worker pool) build
it once and wait for each other, and the compiler writes a temporary file
that ``os.replace`` moves into place, so no process ever loads a
half-written library.  A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import time
from typing import Callable, List, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(_PKG)
NATIVE_SRC = os.path.join(REPO, "native")
NATIVE_BUILD = os.path.join(REPO, "build", "ahsoka_tpu_torch", "native")


def _up_to_date(lib: str, sources: Sequence[str]) -> bool:
    return (os.path.exists(lib) and os.path.getmtime(lib)
            >= max(os.path.getmtime(s) for s in sources))


def build_locked(lib: str, sources: Sequence[str],
                 command: Callable[[str], List[str]]) -> float:
    """Make ``lib`` from ``sources`` unless it is up to date;
    ``command(out)`` is the compiler call writing ``out``.  Returns the
    seconds spent compiling (0.0 when nothing was built)."""
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    with open(lib + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _up_to_date(lib, sources):
            return 0.0
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = command(tmp)
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(f"build of {os.path.basename(lib)} failed "
                               f"({' '.join(cmd)}):\n{proc.stdout}\n"
                               f"{proc.stderr}")
        os.replace(tmp, lib)
        return time.perf_counter() - t0


def load_native(name: str, sources: Sequence[str],
                flags: Sequence[str] = ("-O3",)) -> ctypes.CDLL:
    """``lib<name>.so`` built from ``native/<source>`` files with g++."""
    lib = os.path.join(NATIVE_BUILD, f"lib{name}.so")
    srcs = [os.path.join(NATIVE_SRC, s) for s in sources]
    build_locked(lib, srcs, lambda out: ["g++", *flags, "-shared", "-fPIC",
                                         "-std=c++17", "-o", out, *srcs])
    return ctypes.CDLL(lib)
