"""ctypes loader for the native coverage-cap greedy (native/covcap.cpp)."""

from __future__ import annotations

import ctypes

import numpy as np

from ahsoka_tpu_torch.utils.native import load_native

_lib = None


def _load():
    """The library, built with g++ at first use (raises when the build
    fails)."""
    global _lib
    if _lib is None:
        lib = load_native("ahsoka_covcap", ["covcap.cpp"],
                          ["-O3", "-march=native"])
        lib.ahsoka_covcap.restype = ctypes.c_int64
        lib.ahsoka_covcap.argtypes = [
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8)]
        _lib = lib
    return _lib


def native_covcap(r_nz: np.ndarray, p_nz: np.ndarray, R: int, P: int,
                  cap: int) -> np.ndarray:
    """keep mask (bool [R]) from row-major COO of covered entries."""
    lib = _load()
    r = np.ascontiguousarray(r_nz, dtype=np.int64)
    p = np.ascontiguousarray(p_nz, dtype=np.int64)
    cov = np.zeros(P, dtype=np.int32)
    keep = np.zeros(R, dtype=np.uint8)
    lib.ahsoka_covcap(
        r.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(r), R, P, cap,
        cov.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        keep.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return keep.astype(bool)
