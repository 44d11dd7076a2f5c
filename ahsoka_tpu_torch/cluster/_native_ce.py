"""ctypes loader for native cluster editing (native/cluster_editing.cpp)."""

from __future__ import annotations

import ctypes
from typing import List

import numpy as np

from ahsoka_tpu_torch.utils.native import load_native

_lib = None


def _load():
    """The library, built with g++ at first use (raises when the build
    fails)."""
    global _lib
    if _lib is None:
        lib = load_native("ahsoka_ce", ["cluster_editing.cpp",
                                        "cluster_editing_sparse.cpp"],
                          ["-O3", "-march=native"])
        lib.ahsoka_cluster_editing.restype = ctypes.c_int64
        lib.ahsoka_cluster_editing.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32)]
        lib.ahsoka_cluster_editing_wh.restype = ctypes.c_int64
        lib.ahsoka_cluster_editing_wh.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32)]
        lib.ahsoka_cluster_editing_sparse.restype = ctypes.c_int64
        lib.ahsoka_cluster_editing_sparse.argtypes = [
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_double), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32)]
        lib.ahsoka_cluster_editing_sparse_wh.restype = ctypes.c_int64
        lib.ahsoka_cluster_editing_sparse_wh.argtypes = [
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_double), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32)]
        _lib = lib
    return _lib


def cluster_editing_sparse(num_nodes: int, edges_u: np.ndarray,
                           edges_v: np.ndarray, weights: np.ndarray,
                           exact_priorities: bool = False,
                           mode: str = "whatshap"
                           ) -> List[List[int]]:
    """Sparse-graph variant (native/cluster_editing_sparse.cpp).

    ``mode="whatshap"`` runs the published decision rule with two lazy
    heaps; ``mode="fresh"`` this repo's single-heap greedy.  For both,
    ``exact_priorities=True`` reproduces the dense oracle's selection
    order exactly (quadratic merge refresh; used by parity tests); the
    default approximate mode refreshes only merged-node edges, which is
    the update policy of the reference's WhatsHap EdgeHeap
    (divergence quantified in scripts/quantify_fastpaths.py)."""
    lib = _load()
    if num_nodes == 0:
        return []
    eu = np.ascontiguousarray(edges_u, dtype=np.int32)
    ev = np.ascontiguousarray(edges_v, dtype=np.int32)
    ew = np.ascontiguousarray(weights, dtype=np.float64)
    assign = np.zeros(num_nodes, dtype=np.int32)
    if mode == "whatshap":
        k = lib.ahsoka_cluster_editing_sparse_wh(
            num_nodes, len(ew),
            eu.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ev.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ew.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            1 if exact_priorities else 0,
            assign.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    else:
        k = lib.ahsoka_cluster_editing_sparse(
            num_nodes, len(ew),
            eu.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ev.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ew.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            1 if exact_priorities else 0,
            assign.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    clusters: List[List[int]] = [[] for _ in range(k)]
    for i, c in enumerate(assign):
        clusters[int(c)].append(i)
    return clusters


def cluster_editing_native(weights: np.ndarray, mode: str = "whatshap"
                           ) -> List[List[int]]:
    lib = _load()
    n = weights.shape[0]
    if n == 0:
        return []
    W = np.ascontiguousarray(weights, dtype=np.float64).copy()
    assign = np.zeros(n, dtype=np.int32)
    fn = (lib.ahsoka_cluster_editing_wh if mode == "whatshap"
          else lib.ahsoka_cluster_editing)
    k = fn(W.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n,
           assign.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    clusters: List[List[int]] = [[] for _ in range(k)]
    for i, c in enumerate(assign):
        clusters[int(c)].append(i)
    return clusters
