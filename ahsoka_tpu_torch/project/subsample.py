"""Coverage subsampling for deep chains.

Deep read coverage makes the pair-similarity graph quadratically dense
(each read overlaps ~coverage x span neighbours), which dominates scoring
and cluster-editing cost.  Capping per-position coverage before scoring is
standard phasing practice.  The greedy keeps a read (in readset order, i.e.
ascending first position) when at least half of its positions are still
under the cap — requiring only *one* under-cap position degenerates for
position-sorted readsets, where every read's rightmost position is always
fresh."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ahsoka_tpu_torch.score.pairwise import AlleleMatrix


def subsample_matrix(matrix: AlleleMatrix, cap: int
                     ) -> Tuple[AlleleMatrix, np.ndarray]:
    """Returns (subsampled matrix, kept row indices).

    The greedy is inherently sequential (the running coverage decides
    each read).  The native single-pass (native/covcap.cpp) runs it in
    one sweep over the dense matrix (~0.3 s on config2's 50k x 10k
    chain; its build raises on failure)."""
    from ahsoka_tpu_torch.project._native_covcap import native_covcap

    alleles = matrix.alleles
    R, P = alleles.shape
    r_nz, p_nz, _vals = matrix.covered_coo()
    kept = np.nonzero(native_covcap(r_nz, p_nz, R, P, cap))[0]
    if len(kept) == R:          # nothing dropped: skip the GB copy
        return matrix, kept
    return AlleleMatrix(
        alleles=np.ascontiguousarray(alleles[kept]),
        positions=matrix.positions,
        read_names=[matrix.read_names[i] for i in kept]), kept
