"""Matrix-native readset construction (copy of ahsoka_tpu/project/matrix.py).

The original imports its key-table helpers from ahsoka_tpu/project/device.py,
which imports jax at its top; this copy takes them from the port's
project/device.py and is otherwise unchanged.

Builds the dense (reads x positions) allele matrix *directly* from the
projection winner tables ([bubbles, names] packed keys, project/device.py)
with vectorised numpy — no per-read Python objects on the hot path.  This
is the scalable equivalent of

    readset_to_matrix(assemble_readsets(...).partial_filtered)

and is parity-tested against that object path.  The object path remains the
semantics oracle and the debug-file writer.

Semantics reproduced (src/alignmentstoreadset.cpp:174-304):
- read creation at the first (position, allele, alignment) partial match;
  mapq = int(identity * 100) of the creating alignment
- later positions use the first *gated* match (identity*100 > 90)
- filter: >= 2 variants and mapq >= 93
- readset order: creation order, then stable-sorted by first position
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ahsoka_tpu_torch.config import PhasingConfig
from ahsoka_tpu_torch.score.pairwise import AlleleMatrix
from ahsoka_tpu_torch.utils.arrays import filled
from ahsoka_tpu_torch.project.device import (NO_MATCH, ChainDeviceInputs,
                                             SparseKeys, _decode,
                                             table_coo)


@dataclasses.dataclass
class ChainMatrix:
    """Filtered partial readset as dense arrays."""
    matrix: AlleleMatrix          # [R, P] alleles, -1 uncovered
    mapq: np.ndarray              # int32 [R]
    name_ids: np.ndarray          # int32 [R] indices into inputs.names


def chain_matrix_from_keys(inputs: ChainDeviceInputs,
                           part_keys: np.ndarray,
                           gate_keys: np.ndarray,
                           sweep_dense: np.ndarray,
                           config: PhasingConfig) -> ChainMatrix:
    """sweep_dense: dense bubble indices of the partial sweep positions,
    ascending (see readset.partial_position_sweep)."""
    bubble_ids = inputs.bubble_ids
    identity = inputs.aln_identity
    N = part_keys.shape[1]
    sd = np.asarray(sweep_dense, dtype=np.int64)
    if len(sd) == 0 or N == 0:
        empty = AlleleMatrix(
            alleles=np.zeros((0, 0), dtype=np.int16),
            positions=np.zeros(0, dtype=np.int32), read_names=[])
        return ChainMatrix(matrix=empty,
                           mapq=np.zeros(0, dtype=np.int32),
                           name_ids=np.zeros(0, dtype=np.int32))

    contiguous = (int(sd[-1]) - int(sd[0]) + 1 == len(sd)
                  and bool(np.all(np.diff(sd) == 1)))
    if isinstance(part_keys, SparseKeys):
        # big blocked chains arrive as COO (project/device.SparseKeys):
        # row-select without ever materialising the dense tables
        if contiguous:
            pk = part_keys.row_slice(int(sd[0]), int(sd[-1]) + 1)
            gk = gate_keys.row_slice(int(sd[0]), int(sd[-1]) + 1)
        else:
            pk = part_keys.row_subset(sd)
            gk = gate_keys.row_subset(sd)
    elif contiguous:
        # contiguous sweep (the common case: all positions) — slice
        # views instead of 2 GB fancy-index row gathers at config-2 scale
        pk = part_keys[int(sd[0]):int(sd[-1]) + 1]   # [Bs, N] view
        gk = gate_keys[int(sd[0]):int(sd[-1]) + 1]
    else:
        pk = part_keys[sd]
        gk = gate_keys[sd]
    Bs = len(sd)

    # Sparse evaluation over the matched entries only: a read matches a
    # handful of positions, so the [Bs, N] tables are ~nnz/(Bs*N) dense
    # (0.01% at BASELINE config-2 scale, where the dense formulation
    # cost minutes of [10k, 50k] passes).  Semantics identical to the
    # dense expression (parity: test_matrix_path.py).
    from ahsoka_tpu_torch.utils import substage
    with substage.timed("matrix.assemble.coo"):
        pr, pc, pv = table_coo(pk)         # row-major: r ascending per c
        gr, gc, gv = table_coo(gk)
    if len(pr) == 0:
        empty = AlleleMatrix(
            alleles=np.zeros((0, 0), dtype=np.int16),
            positions=np.zeros(0, dtype=np.int32), read_names=[])
        return ChainMatrix(matrix=empty,
                           mapq=np.zeros(0, dtype=np.int32),
                           name_ids=np.zeros(0, dtype=np.int32))

    any_match = np.zeros(N, dtype=bool)
    any_match[pc] = True
    # first matched row per column: COO order is row-major, so a
    # stable sort by column keeps rows ascending within each column
    substage.add("matrix.assemble.nnz", float(len(pr) + len(gr)))
    order = np.argsort(pc, kind="stable")
    pc_s, pr_s, pv_s = pc[order], pr[order], pv[order]
    starts = np.searchsorted(pc_s, np.arange(N))
    first_row = np.where(any_match,
                         pr_s[np.minimum(starts, max(len(pr_s) - 1, 0))],
                         0)

    g_allele_e, _ = _decode(gv)

    # creation entries: the first matched row of each covered column
    first_entry = starts[np.nonzero(any_match)[0]]
    cr_c = pc_s[first_entry]               # == covered columns
    creation_key = np.full(N, np.int64(NO_MATCH), dtype=np.int64)
    creation_key[cr_c] = pv_s[first_entry].astype(np.int64)
    cre_allele, cre_al = _decode(creation_key.astype(np.int64))
    mapq = np.where(any_match,
                    (identity[np.clip(cre_al, 0, len(identity) - 1)]
                     * config.mapq_scale).astype(np.int32), 0)

    # gate entries strictly after the creation row (dense: after & gm)
    g_keep = any_match[gc] & (gr > first_row[gc])
    gr_k, gc_k = gr[g_keep], gc[g_keep]
    g_allele_k = g_allele_e[g_keep]

    variant_count = np.bincount(cr_c, minlength=N) + \
        np.bincount(gc_k, minlength=N)
    keep = (any_match & (variant_count >= config.min_variants)
            & (mapq >= config.mapq_threshold))
    kept = np.nonzero(keep)[0]

    # order: creation (first_row asc, then packed key at the first row),
    # then stable sort by first position — first position IS first_row, so
    # one stable sort by (first_row, creation key) suffices
    order = np.lexsort((creation_key[kept], first_row[kept]))
    kept = kept[order]

    with substage.timed("matrix.assemble.names"):
        names = [inputs.names[i] for i in kept]
    # rows covered by surviving reads only (the object path's
    # ReadSet.positions() is the union over kept reads)
    col_rank = np.full(N, -1, dtype=np.int64)
    col_rank[kept] = np.arange(len(kept))
    gm_kept = keep[gc_k]
    covered = np.zeros(Bs, dtype=bool)
    covered[first_row[kept]] = True
    covered[gr_k[gm_kept]] = True
    row_rank = np.cumsum(covered) - 1      # dense row index among covered

    with substage.timed("matrix.assemble.alloc"):
        out = filled((len(kept), int(covered.sum())), -1, np.int16)
    # gate alleles first, creation alleles second: disjoint rows per
    # column, so order is cosmetic — matches the dense where() nesting
    out[col_rank[gc_k[gm_kept]], row_rank[gr_k[gm_kept]]] = \
        g_allele_k[gm_kept].astype(np.int16)
    out[col_rank[kept], row_rank[first_row[kept]]] = \
        cre_allele[kept].astype(np.int16)

    mat = AlleleMatrix(
        alleles=out,
        positions=bubble_ids[sd[covered]].astype(np.int32),
        read_names=names)
    return ChainMatrix(matrix=mat, mapq=mapq[kept],
                       name_ids=kept.astype(np.int32))


def partial_sweep_from_stats(inputs: ChainDeviceInputs,
                             full_keys: np.ndarray,
                             config: PhasingConfig) -> np.ndarray:
    """Dense sweep rows (ascending) replicating
    readset.partial_position_sweep on the winner tables.

    Full-pass mapq per name comes from the first match in bubble-iteration
    (stdmap) order — only reads passing the mapq/variant filter contribute
    boundary extensions."""
    B, N = full_keys.shape
    # sparse evaluation over matched entries (see chain_matrix_from_keys)
    fr, fc, fv = table_coo(full_keys)            # row-major
    if len(fr) == 0:
        return np.zeros(0, dtype=np.int64)
    any_match = np.zeros(N, dtype=bool)
    any_match[fc] = True
    last_covered = int(fr.max())

    # mapq via the stdmap-ranked first match (see device.assemble_readsets)
    if config.compat_std_ordering:
        from ahsoka_tpu_torch.compat import native_iteration_order
        order = native_iteration_order([int(b) for b in inputs.bubble_ids])
        rank_of = {b: r for r, b in enumerate(order)}
        ranks = np.asarray([rank_of[int(b)] for b in inputs.bubble_ids],
                           dtype=np.int64)
    else:
        ranks = np.arange(B, dtype=np.int64)
    entry_key = ranks[fr] * np.int64(1 << 31) + fv.astype(np.int64)
    # per-column argmin of entry_key: sort entries by (col, key) and
    # take the first of each column
    order = np.lexsort((entry_key, fc))
    fc_k, key_k = fc[order], entry_key[order]
    starts = np.searchsorted(fc_k, np.arange(N))
    starts_c = np.minimum(starts, len(fc_k) - 1)
    win_key = np.where(any_match, key_k[starts_c] & ((1 << 31) - 1),
                       np.int64(NO_MATCH))
    _, win_al = _decode(win_key.astype(np.int64))
    mapq = np.where(
        any_match,
        (inputs.aln_identity[np.clip(win_al, 0,
                                     len(inputs.aln_identity) - 1)]
         * config.mapq_scale).astype(np.int32), 0)
    counts = np.bincount(fc, minlength=N)
    filtered = (any_match & (counts >= config.min_variants)
                & (mapq >= config.mapq_threshold))

    # per-column first/last matched row from the row-major COO order
    rorder = np.argsort(fc, kind="stable")       # rows ascending per col
    fc_s, fr_s = fc[rorder], fr[rorder]
    col_starts = np.searchsorted(fc_s, np.arange(N))
    col_ends = np.searchsorted(fc_s, np.arange(N), side="right")
    sc = np.minimum(col_starts, len(fr_s) - 1)
    first = np.where(filtered, fr_s[sc], -1)
    last = np.where(filtered, fr_s[np.maximum(col_ends - 1, 0)], -1)
    first_set = set(int(x) for x in first[filtered])
    sweep = set(range(last_covered))
    for el in set(int(x) for x in last[filtered]):
        if el not in first_set:
            sweep.add(el)
            sweep.add(el + 1)
    # positions beyond the bubble table are no-ops (no allele paths there)
    return np.asarray(sorted(p for p in sweep if p < B), dtype=np.int64)
