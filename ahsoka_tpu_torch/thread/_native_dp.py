"""ctypes loader for the native sequential DP baseline
(native/dp_baseline.cpp): the single-core reference point of the threading
DP and a second oracle for the DP tests.

Counterpart of ``ahsoka_tpu/thread/_native_dp.py``.  The library is built
with g++ at first use into ``build/ahsoka_tpu_torch/native/`` under the
port's file lock (``utils/native.py``); a failed build raises, where the
JAX package's loader returns None.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from ahsoka_tpu_torch.utils.native import load_native

_lib = None


def _load():
    """The library, built with g++ at first use (raises when the build
    fails)."""
    global _lib
    if _lib is None:
        lib = load_native("ahsoka_dp", ["dp_baseline.cpp"],
                          ["-O3", "-march=native"])
        lib.ahsoka_dp_baseline.restype = ctypes.c_int64
        lib.ahsoka_dp_baseline.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.POINTER(ctypes.c_int32)]
        _lib = lib
    return _lib


def native_dp_available() -> bool:
    """True once the library is built and loaded (a failed build
    raises)."""
    return _load() is not None


def run_native_dp(candidates: np.ndarray, num_candidates: np.ndarray,
                  coverage: np.ndarray, consensus: np.ndarray,
                  genotypes: np.ndarray, ploidy: int,
                  switch_cost: float, affine_cost: float,
                  cov_w: float = 1.0, geno_w: float = 1.0
                  ) -> Optional[Tuple[int, np.ndarray]]:
    """Returns (dp_cells, per-position state indices [P] int32) of one
    chain's DP inputs: candidates / consensus [P, M] int32, num_candidates
    [P], coverage [P, M] and genotypes [P, A] float32."""
    lib = _load()
    P, M = candidates.shape
    A = genotypes.shape[1]
    if num_candidates.shape != (P,) or coverage.shape != (P, M) \
            or consensus.shape != (P, M) or genotypes.shape[0] != P:
        raise ValueError("DP inputs disagree in positions or slots")
    c = np.ascontiguousarray(candidates, dtype=np.int32)
    nc = np.ascontiguousarray(num_candidates, dtype=np.int32)
    cov = np.ascontiguousarray(coverage, dtype=np.float32)
    cons = np.ascontiguousarray(consensus, dtype=np.int32)
    gen = np.ascontiguousarray(genotypes, dtype=np.float32)
    out = np.zeros(P, dtype=np.int32)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    cells = lib.ahsoka_dp_baseline(
        ptr(c, ctypes.c_int32), ptr(nc, ctypes.c_int32),
        ptr(cov, ctypes.c_float), ptr(cons, ctypes.c_int32),
        ptr(gen, ctypes.c_float), P, M, A, ploidy,
        switch_cost, affine_cost, cov_w, geno_w,
        ptr(out, ctypes.c_int32))
    return int(cells), out
