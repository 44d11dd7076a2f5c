"""ctypes loader for the native GAF parser (native/gaf_parser.cpp)."""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from ahsoka_tpu_torch.utils.native import load_native

_lib = None


def _load():
    """The library, built with g++ at first use (raises when the build
    fails)."""
    global _lib
    if _lib is None:
        lib = load_native("ahsoka_io", ["gaf_parser.cpp", "gfa_parser.cpp"])
        lib.ahsoka_gaf_parse.restype = ctypes.c_void_p
        lib.ahsoka_gaf_parse.argtypes = [ctypes.c_char_p]
        for fn in ("ahsoka_gaf_num_records", "ahsoka_gaf_num_nodes",
                   "ahsoka_gaf_name_bytes", "ahsoka_gaf_seg_bytes",
                   "ahsoka_gaf_blocklen_bytes"):
            getattr(lib, fn).restype = ctypes.c_int64
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        lib.ahsoka_gaf_fill_sidefile.restype = None
        lib.ahsoka_gaf_fill_sidefile.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64)]
        lib.ahsoka_gaf_fill.restype = None
        lib.ahsoka_gaf_fill.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_float)]
        lib.ahsoka_gaf_free.restype = None
        lib.ahsoka_gaf_free.argtypes = [ctypes.c_void_p]
        lib.ahsoka_gfa_parse.restype = ctypes.c_void_p
        lib.ahsoka_gfa_parse.argtypes = [ctypes.c_char_p]
        for fn in ("ahsoka_gfa_num_segs", "ahsoka_gfa_num_edges",
                   "ahsoka_gfa_num_touches"):
            getattr(lib, fn).restype = ctypes.c_int64
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        lib.ahsoka_gfa_fill.restype = None
        lib.ahsoka_gfa_fill.argtypes = [ctypes.c_void_p] + \
            [ctypes.POINTER(ctypes.c_int64)] * 4 + \
            [ctypes.POINTER(ctypes.c_uint8)] * 2 + \
            [ctypes.POINTER(ctypes.c_int64)] * 2
        lib.ahsoka_gfa_free.restype = None
        lib.ahsoka_gfa_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def parse_gaf_native(path: str) -> Optional[dict]:
    """Parse a GAF file into flat numpy arrays; None when the file is
    malformed (the caller falls back to the Python parser for the precise
    error)."""
    lib = _load()
    h = lib.ahsoka_gaf_parse(path.encode())
    if not h:
        return None
    try:
        n_rec = lib.ahsoka_gaf_num_records(h)
        n_nodes = lib.ahsoka_gaf_num_nodes(h)
        n_bytes = lib.ahsoka_gaf_name_bytes(h)
        names = ctypes.create_string_buffer(max(n_bytes, 1))
        name_offsets = np.zeros(n_rec + 1, dtype=np.int64)
        node_ids = np.zeros(max(n_nodes, 1), dtype=np.int64)
        node_dirs = np.zeros(max(n_nodes, 1), dtype=np.uint8)
        path_offsets = np.zeros(n_rec + 1, dtype=np.int64)
        starts = np.zeros(max(n_rec, 1), dtype=np.int64)
        ends = np.zeros(max(n_rec, 1), dtype=np.int64)
        identities = np.zeros(max(n_rec, 1), dtype=np.float32)
        ptr = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))
        lib.ahsoka_gaf_fill(
            h, names, ptr(name_offsets, ctypes.c_int64),
            ptr(node_ids, ctypes.c_int64), ptr(node_dirs, ctypes.c_uint8),
            ptr(path_offsets, ctypes.c_int64), ptr(starts, ctypes.c_int64),
            ptr(ends, ctypes.c_int64), ptr(identities, ctypes.c_float))
        n_seg = lib.ahsoka_gaf_seg_bytes(h)
        n_blk = lib.ahsoka_gaf_blocklen_bytes(h)
        seg = ctypes.create_string_buffer(max(n_seg, 1))
        seg_offsets = np.zeros(n_nodes + 1, dtype=np.int64)
        blk = ctypes.create_string_buffer(max(n_blk, 1))
        blk_offsets = np.zeros(n_rec + 1, dtype=np.int64)
        lib.ahsoka_gaf_fill_sidefile(
            h, seg, ptr(seg_offsets, ctypes.c_int64), blk,
            ptr(blk_offsets, ctypes.c_int64))
        return {
            "num_records": int(n_rec),
            "name_bytes": names.raw[:n_bytes],
            "name_offsets": name_offsets,
            "node_ids": node_ids[:n_nodes],
            "node_dirs": node_dirs[:n_nodes],
            "path_offsets": path_offsets,
            "starts": starts[:n_rec], "ends": ends[:n_rec],
            "identities": identities[:n_rec],
            "seg_bytes": seg.raw[:n_seg], "seg_offsets": seg_offsets,
            "blocklen_bytes": blk.raw[:n_blk],
            "blocklen_offsets": blk_offsets,
        }
    finally:
        lib.ahsoka_gaf_free(h)


def parse_gfa_native(path: str) -> Optional[dict]:
    """Parse a GFA file into flat numpy arrays (None on malformed input;
    the caller falls back to the Python parser for the precise error)."""
    lib = _load()
    h = lib.ahsoka_gfa_parse(path.encode())
    if not h:
        return None
    try:
        n_seg = lib.ahsoka_gfa_num_segs(h)
        n_edge = lib.ahsoka_gfa_num_edges(h)
        n_touch = lib.ahsoka_gfa_num_touches(h)
        seg_ids = np.zeros(max(n_seg, 1), dtype=np.int64)
        seg_lens = np.zeros(max(n_seg, 1), dtype=np.int64)
        ef = np.zeros(max(n_edge, 1), dtype=np.int64)
        et = np.zeros(max(n_edge, 1), dtype=np.int64)
        efp = np.zeros(max(n_edge, 1), dtype=np.uint8)
        etp = np.zeros(max(n_edge, 1), dtype=np.uint8)
        eo = np.zeros(max(n_edge, 1), dtype=np.int64)
        touch = np.zeros(max(n_touch, 1), dtype=np.int64)
        ptr = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))
        lib.ahsoka_gfa_fill(
            h, ptr(seg_ids, ctypes.c_int64), ptr(seg_lens, ctypes.c_int64),
            ptr(ef, ctypes.c_int64), ptr(et, ctypes.c_int64),
            ptr(efp, ctypes.c_uint8), ptr(etp, ctypes.c_uint8),
            ptr(eo, ctypes.c_int64), ptr(touch, ctypes.c_int64))
        return {"seg_ids": seg_ids[:n_seg], "seg_lens": seg_lens[:n_seg],
                "edge_from": ef[:n_edge], "edge_to": et[:n_edge],
                "edge_from_plus": efp[:n_edge],
                "edge_to_plus": etp[:n_edge],
                "edge_overlap": eo[:n_edge],
                "touch_order": touch[:n_touch]}
    finally:
        lib.ahsoka_gfa_free(h)
