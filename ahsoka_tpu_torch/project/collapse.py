"""Identical-read collapsing: the cluster-editing/scoring fast path.

Reads with byte-identical allele rows (same covered positions, same
alleles) are interchangeable everywhere downstream of projection: the
pair score depends only on the two rows plus per-position statistics,
and the induced-cost greedy's strongest attractions are exactly these
duplicate pairs, so the exact solver spends its first ~R-G merges
contracting them one by one (at O(n^2) a merge in the dense solver —
config4's bottleneck on a TPU).  Collapsing them up front:

- scores G distinct rows instead of R reads (G ~ 0.15-0.4 R at config4
  coverage) — the device fetch and the host stat matmuls shrink by
  (R/G)^2;
- runs cluster editing on the G-node weighted graph, where the edge
  weight is ``m_u * m_v * s(u, v)`` — exactly the supernode weight
  WhatsHap's merge accumulates (weights add under contraction,
  StaticSparseGraph semantics), so the collapsed start state equals the
  exact solver's state after contracting every duplicate pair first;
- expands the group clusters back to read clusters for the DP inputs.

Divergence from the exact (uncollapsed) decision trace is possible only
when the exact greedy would NOT merge two identical reads (it decides
some other edge first and that decision separates them) — measured in
scripts/profile_ce.py; the contract test (tests/test_fastpath_contract)
bounds the downstream effect.

Per-position statistics (allele counts, p_s estimation) must weight each
distinct row by its multiplicity to stay byte-equal to the full-matrix
estimators — see estimate_p_s_weighted (score/whatshap.py) and the
``mult`` parameter of the device scoring kernels (score/device.py).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ahsoka_tpu_torch.score.pairwise import AlleleMatrix


@dataclasses.dataclass
class CollapsedReads:
    """Distinct allele rows + the read -> group mapping."""
    matrix: AlleleMatrix         # [G, P] distinct rows (lexicographic)
    inverse: np.ndarray          # int32 [R] group index of each read
    mult: np.ndarray             # int64 [G] reads per group

    @property
    def num_groups(self) -> int:
        return self.matrix.num_reads


def collapse_reads(matrix: AlleleMatrix,
                   max_groups: int = 0) -> "CollapsedReads | None":
    """Group byte-identical allele rows.

    Rows are position-sparse (a read covers ~span positions of the
    chain), so grouping runs over the nonzero structure in O(nnz):
    ``np.unique(axis=0)`` lexsorts full rows and cost 145 s on the
    config2 chain ([50k, 10k] — 1 GB of mostly -1), vs a few seconds
    here.  Groups are ordered by first occurrence (deterministic; also
    keeps group indices aligned with read order, matching the exact
    solver's lexicographic tie-breaking more closely than lexicographic
    row order would).

    ``max_groups > 0``: return None as soon as the group count exceeds
    it, before materialising the [G, P] representative rows — callers
    that would discard the collapse (banded-path chains, where G still
    exceeds the dense threshold) pay only the signature scan."""
    al = matrix.alleles
    R = al.shape[0]
    r_nz, p_nz, vals = matrix.covered_coo()
    nnz_per_row = np.bincount(r_nz, minlength=R)
    max_nnz = int(nnz_per_row.max(initial=0))
    if max_nnz <= 64:
        # fixed-width signatures + np.unique(axis=0): reads cover at
        # most ~span+1 positions, so a [R, 2*max_nnz] int32 signature
        # table replaces the per-row Python loop (config4: 3.9 s of
        # per-chain loops -> ~0.5 s).  Groups re-ordered by first
        # occurrence to keep the loop path's deterministic order.
        starts = np.cumsum(nnz_per_row) - nnz_per_row
        within = np.arange(len(r_nz), dtype=np.int64) \
            - np.repeat(starts, nnz_per_row)
        sig = np.full((R, 2 * max(max_nnz, 1)), -1, dtype=np.int32)
        sig[r_nz, within] = p_nz
        sig[r_nz, max_nnz + within] = vals
        _, uidx, uinv, counts = np.unique(
            sig, axis=0, return_index=True, return_inverse=True,
            return_counts=True)
        uinv = uinv.reshape(-1)
        if max_groups and len(uidx) > max_groups:
            return None
        order = np.argsort(uidx, kind="stable")     # first occurrence
        rank = np.empty_like(order)
        rank[order] = np.arange(len(order))
        inverse = rank[uinv].astype(np.int32)
        first_idx = uidx[order].astype(np.int64)
        mult = counts[order]
    else:
        bounds = np.cumsum(nnz_per_row)[:-1]
        p_splits = np.split(p_nz, bounds)
        v_splits = np.split(vals, bounds)
        sig2group: dict = {}
        inverse = np.empty(R, dtype=np.int32)
        mult_l: List[int] = []
        first: List[int] = []
        for r in range(R):
            s = (p_splits[r].tobytes(), v_splits[r].tobytes())
            g = sig2group.get(s)
            if g is None:
                if max_groups and len(first) >= max_groups:
                    return None
                g = len(first)
                sig2group[s] = g
                first.append(r)
                mult_l.append(1)
            else:
                mult_l[g] += 1
            inverse[r] = g
        first_idx = np.asarray(first, dtype=np.int64)
        mult = np.asarray(mult_l)
    gm = AlleleMatrix(alleles=al[first_idx],
                      positions=matrix.positions,
                      read_names=[matrix.read_names[int(i)]
                                  for i in first_idx])
    return CollapsedReads(matrix=gm, inverse=inverse,
                          mult=np.asarray(mult, dtype=np.int64))


def expand_clusters(group_clusters: List[List[int]],
                    inverse: np.ndarray) -> List[List[int]]:
    """Group clusters -> read clusters in the solver's output convention
    (clusters ordered by smallest member, members ascending)."""
    group_of = {}
    for cid, cluster in enumerate(group_clusters):
        for g in cluster:
            group_of[g] = cid
    reads_of: dict = {}
    for r, g in enumerate(inverse):
        reads_of.setdefault(group_of[int(g)], []).append(r)
    out = [sorted(v) for v in reads_of.values()]
    out.sort(key=lambda c: c[0])
    return out
