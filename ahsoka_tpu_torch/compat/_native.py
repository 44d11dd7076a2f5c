"""ctypes loader for the native compat helper (native/stdcompat.cpp),
built with g++ at first use (the build raises on failure)."""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

from ahsoka_tpu_torch.utils.native import load_native

_lib: Optional[ctypes.CDLL] = None


def _ensure_built() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load_native("ahsoka_compat", ["stdcompat.cpp"], ["-O2"])
        lib.ahsoka_stdmap_order.restype = ctypes.c_int64
        lib.ahsoka_stdmap_order.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64)]
        _lib = lib
    return _lib


def stdmap_order(keys: Sequence[int]) -> List[int]:
    lib = _ensure_built()
    n = len(keys)
    arr = (ctypes.c_int64 * n)(*keys)
    out = (ctypes.c_int64 * n)()
    k = lib.ahsoka_stdmap_order(arr, n, out)
    return list(out[:k])
