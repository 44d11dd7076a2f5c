"""Columnar GAF tables and per-chain bucketing (no per-record objects).

``GafColumns`` holds the whole GAF file as flat arrays (native parser
layout); ``bucket_by_chain`` reproduces the reference's per-chain
alignment bucketing — one entry per (record, path-node) whose node belongs
to the chain, in flat file order (src/alignmentreader.cpp:176-183) — as
index arrays.  This feeds the columnar projection
(project/device.prepare_chain_inputs_from_columns) used by the batched
jax backend; the object path (io/gaf.read_gaf) remains the semantics
oracle.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from ahsoka_tpu_torch.graph.structures import BubbleIndex


@dataclasses.dataclass
class GafColumns:
    num_records: int
    names: List[str]              # unique names (global interning)
    record_name: np.ndarray       # int64 [records] -> index into names
    node_ids: np.ndarray          # int64 flat path nodes
    node_dirs: np.ndarray         # uint8 flat ('>' == 1)
    path_offsets: np.ndarray      # int64 [records+1]
    starts: np.ndarray
    ends: np.ndarray
    identities: np.ndarray        # float32 [records]


def columns_from_native(cols: dict) -> GafColumns:
    """Vectorised name interning (first-occurrence order, like the
    object parser's dict): pad names into a fixed-width byte matrix,
    np.unique(axis=0) for identity, then remap the sorted unique ids to
    first-occurrence rank so creation order is preserved."""
    nb = np.frombuffer(bytes(cols["name_bytes"]), dtype=np.uint8)
    no = np.asarray(cols["name_offsets"], dtype=np.int64)
    R = cols["num_records"]
    lens = np.diff(no)
    W = int(lens.max()) if R else 1
    padded = np.zeros((R, W), dtype=np.uint8)
    if R:
        flat_rows = np.repeat(np.arange(R, dtype=np.int64), lens)
        within = (np.arange(int(lens.sum()), dtype=np.int64)
                  - np.repeat(np.cumsum(lens) - lens, lens))
        padded[flat_rows, within] = nb[np.repeat(no[:-1], lens) + within]
    _, first_idx, inverse = np.unique(padded, axis=0, return_index=True,
                                      return_inverse=True)
    order = np.argsort(first_idx, kind="stable")   # first-occurrence order
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    record_name = rank[inverse].astype(np.int64)
    names = [
        padded[first_idx[o], :lens[first_idx[o]]].tobytes().decode()
        for o in order]
    return GafColumns(
        num_records=cols["num_records"], names=names,
        record_name=record_name, node_ids=cols["node_ids"],
        node_dirs=cols["node_dirs"], path_offsets=cols["path_offsets"],
        starts=cols["starts"], ends=cols["ends"],
        identities=cols["identities"])


def read_gaf_columns(path: str) -> Optional[GafColumns]:
    """Parse with the native engine into columns (None if unavailable)."""
    from ahsoka_tpu_torch.io._native_io import parse_gaf_native

    cols = parse_gaf_native(path)
    if cols is None:
        return None
    return columns_from_native(cols)


def columns_from_alignments(alignments) -> GafColumns:
    """Build columns from parsed Alignment objects (python-parser route)."""
    names: List[str] = []
    intern: Dict[str, int] = {}
    record_name = []
    node_ids: List[int] = []
    node_dirs: List[int] = []
    offsets = [0]
    starts, ends, idents = [], [], []
    for aln in alignments:
        gid = intern.get(aln.name)
        if gid is None:
            gid = len(names)
            intern[aln.name] = gid
            names.append(aln.name)
        record_name.append(gid)
        node_ids.extend(aln.node_ids)
        node_dirs.extend(int(p) for p in aln.node_plus)
        offsets.append(len(node_ids))
        starts.append(aln.start)
        ends.append(aln.end)
        idents.append(aln.identity)
    return GafColumns(
        num_records=len(record_name), names=names,
        record_name=np.asarray(record_name, dtype=np.int64),
        node_ids=np.asarray(node_ids, dtype=np.int64),
        node_dirs=np.asarray(node_dirs, dtype=np.uint8),
        path_offsets=np.asarray(offsets, dtype=np.int64),
        starts=np.asarray(starts, dtype=np.int64),
        ends=np.asarray(ends, dtype=np.int64),
        identities=np.asarray(idents, dtype=np.float32))


def node_chain_lookup(index: BubbleIndex) -> Tuple[np.ndarray, np.ndarray]:
    """(sorted node ids, chain ids) arrays for vectorised chain lookup;
    unknown nodes map to chain 0 (reference zero-init)."""
    items = sorted(index.chain_id_of.items())
    ids = np.asarray([k for k, _ in items], dtype=np.int64)
    chains = np.asarray([v for _, v in items], dtype=np.int64)
    return ids, chains


def chains_of_nodes(node_ids: np.ndarray, lookup) -> np.ndarray:
    ids, chains = lookup
    if len(ids) == 0:
        return np.zeros(len(node_ids), dtype=np.int64)
    pos = np.searchsorted(ids, node_ids)
    pos = np.clip(pos, 0, len(ids) - 1)
    found = ids[pos] == node_ids
    return np.where(found, chains[pos], 0)


@dataclasses.dataclass
class ChainBucket:
    """One chain's alignment bucket as record indices (with the
    reference's per-node duplicate multiplicity, flat file order)."""
    chain_id: int
    record_idx: np.ndarray        # int64 [entries]


def bucket_by_chain(cols: GafColumns, index: BubbleIndex,
                    compat_duplicate_bucketing: bool = True
                    ) -> Dict[int, ChainBucket]:
    lookup = node_chain_lookup(index)
    chain_flat = chains_of_nodes(cols.node_ids, lookup)
    # record id of every flat node
    rec_of_flat = np.repeat(
        np.arange(cols.num_records, dtype=np.int64),
        np.diff(cols.path_offsets))
    out: Dict[int, ChainBucket] = {}
    order = np.argsort(chain_flat, kind="stable")
    sorted_chains = chain_flat[order]
    bounds = np.searchsorted(sorted_chains,
                             np.unique(sorted_chains), side="left")
    uniq = np.unique(sorted_chains)
    bounds = list(bounds) + [len(sorted_chains)]
    for i, c in enumerate(uniq):
        sel = order[bounds[i]:bounds[i + 1]]
        sel.sort()                       # flat file order
        recs = rec_of_flat[sel]
        if not compat_duplicate_bucketing:
            # keep first entry per (record, chain)
            _, first = np.unique(recs, return_index=True)
            recs = recs[np.sort(first)]
        out[int(c)] = ChainBucket(chain_id=int(c), record_idx=recs)
    return out
