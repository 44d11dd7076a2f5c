"""Pairwise same-haplotype read scoring.

Role parity: the reference calls WhatsHap's ``ReadScoring::scoreReadsetLocal
(&sim, testset, minOverlap=1, ploidy)`` (src/alignmentstoreadset.cpp:308-311)
to fill a sparse matrix of log-likelihood-ratio scores over read pairs, from
allele agreement counts with locally estimated error/allele rates.

This module is a fresh derivation of that score with the math arranged as
*position-weighted matmuls*, so the identical formulation runs as the host
oracle (numpy) and as an MXU tensor program (score/device.py):

For reads i, j overlapping in o >= min_overlap positions:

    score(i,j) = sum_{p in overlap} [ agree_p * log((1-d_s)/(1-d_d(p)))
                                    + disagree_p * log(d_s/d_d(p)) ]

where d_s = P(disagree | same haplotype) = 2*eps*(1-eps) from the
per-position allele error rate eps, and d_d(p) = P(disagree | different
haplotypes) = h_p*(1-d_s) + (1-h_p)*d_s with h_p the probability two
distinct haplotypes differ at p, estimated from the local allele
frequencies: h_p = clip((1 - sum_a f_{p,a}^2) * k/(k-1)).

Positive score => likely same haplotype.  Because the per-position weights
w_agree(p), w_dis(p) depend only on p, the pair matrix factorises into two
matmuls over the (reads x positions[ x alleles]) one-hot projections:

    S = (M .* w_dis) @ M^T + sum_a (O_a .* (w_agree - w_dis)) @ O_a^T

with M the coverage mask and O the allele one-hot — exactly the shape the
MXU wants (SURVEY.md §7 layer 4).

Frozen copy of ``ahsoka_tpu_torch/score/pairwise.py`` (the parts the WhatsHap scoring uses), so that a
change to the program cannot move the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from .readset import ReadSet

_EPS_CLIP = 1e-4


@dataclasses.dataclass
class AlleleMatrix:
    """Dense (reads x positions) allele matrix with -1 for uncovered."""
    alleles: np.ndarray          # int16 [R, P], -1 = not covered
    positions: np.ndarray        # int32 [P] original bubble positions
    read_names: list
    # lazy covered-entry COO cache (see covered_coo)
    _coo: "tuple | None" = dataclasses.field(
        default=None, repr=False, compare=False)

    def covered_coo(self):
        """(r_nz, p_nz, values) of the covered entries, row-major,
        computed once: the coverage cap, identical-read collapsing,
        banded scoring, and the whatshap position statistics each
        re-scanned config2's 1 GB matrix for the same nonzero set
        (~1.2 s per scan)."""
        if self._coo is None:
            r, p = np.nonzero(self.alleles >= 0)
            self._coo = (r, p, self.alleles[r, p])
        return self._coo

    @property
    def num_reads(self) -> int:
        return self.alleles.shape[0]

    @property
    def num_positions(self) -> int:
        return self.alleles.shape[1]

    @property
    def num_alleles(self) -> int:
        return int(self.alleles.max(initial=-1)) + 1


def readset_to_matrix(readset: ReadSet) -> AlleleMatrix:
    positions = readset.positions()
    pos_index = {p: j for j, p in enumerate(positions)}
    mat = np.full((len(readset), len(positions)), -1, dtype=np.int16)
    for i, read in enumerate(readset):
        for p, a in zip(read.positions, read.alleles):
            mat[i, pos_index[p]] = a
    return AlleleMatrix(alleles=mat,
                        positions=np.asarray(positions, dtype=np.int32),
                        read_names=[r.name for r in readset])


def overlap_and_agreement(matrix: AlleleMatrix
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Pair overlap / agreement counts ([R, R] float64).

    The matmuls run in float32 and cast up afterwards: every operand is
    0/1 and every partial sum is an integer < 2^24 (counts are bounded
    by P), so float32 accumulation is EXACT and the cast reproduces the
    float64 matmul bit for bit — at 2-4x the numpy throughput (this is
    the hot term of the sampled p_s estimator on 10k-position chains)."""
    mask = (matrix.alleles >= 0).astype(np.float32)
    overlap = (mask @ mask.T).astype(np.float64)
    agree = np.zeros_like(overlap)
    for a in range(matrix.num_alleles):
        onehot = (matrix.alleles == a).astype(np.float32)
        agree += (onehot @ onehot.T).astype(np.float64)
    return overlap, agree


