"""Coverage-cap greedy, in Python.

Frozen from the semantics of ``ahsoka_tpu_torch/project/subsample.py``
and ``native/covcap.cpp``: walk the reads in row order and keep a read
when one of its covered positions has no kept read yet, or when at least
half of its covered positions are still under the cap; a kept read adds
one to the coverage of each of its positions.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .pairwise import AlleleMatrix


def subsample_matrix(matrix: AlleleMatrix, cap: int
                     ) -> Tuple[AlleleMatrix, np.ndarray]:
    """(the capped matrix, the kept row indices)."""
    alleles = matrix.alleles
    cov = np.zeros(alleles.shape[1], dtype=np.int64)
    keep = []
    for r in range(alleles.shape[0]):
        cols = np.nonzero(alleles[r] >= 0)[0]
        c = cov[cols]
        if len(cols) and ((c == 0).any()
                          or 2 * int((c < cap).sum()) >= len(cols)):
            keep.append(r)
            cov[cols] += 1
    kept = np.asarray(keep, dtype=np.int64)
    return AlleleMatrix(alleles=np.ascontiguousarray(alleles[kept]),
                        positions=matrix.positions,
                        read_names=[matrix.read_names[i] for i in kept]), kept
