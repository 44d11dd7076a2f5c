"""Haplotype-threading DP costs and row assignment — host (numpy) oracle.

Frozen copy of ``ahsoka_tpu_torch/thread/dp_host.py``: its node and
transition costs and its row assignment; the min-cost recurrence over
them is ``phase.best_path``.

The flagship compute of the pipeline (SURVEY.md §3.3 hot loop #3): thread
`ploidy` haplotypes through the read clusters position by position,
minimising

    node cost:  coverage deviation  sum_slot |cov[j,slot] - mult(slot)/k|
                + genotype conformity  (1/2) sum_a |count_a(consensus of
                  tuple) - genotype[j,a]|
    transition: switch_cost * s + affine_switch_cost * [s > 0],
                s = k - |multiset intersection of consecutive tuples|
                (intersection on cluster *ids*, which may sit in different
                candidate slots at the two positions)

matching the cost structure of the reference's WhatsHap
``HaploThreader(ploidy, 32.0, 8.0, false, 0).computePaths``
(src/alignmentstoreadset.cpp:320,408).  Viterbi-style min-cost DP with
backtrace; ties take the lexicographically first state (argmin).

After the multiset path is found, tuples are reordered per position so each
haplotype row keeps its cluster whenever possible (the threader's
row-continuity pass) — emission indexes ``path[j][i]`` per haplotype i.

"""

from __future__ import annotations

from collections import Counter
from typing import List, Sequence, Tuple

import numpy as np

from .postprocess import DPInputs
from .config import PhasingConfig
from .states import full_state_counts, full_state_validity


def node_costs(dp: DPInputs, j: int, config: PhasingConfig) -> np.ndarray:
    """Cost of every full-width state at dense position j (+inf for
    states referencing empty candidate slots)."""
    m = int(dp.num_candidates[j])
    k = config.ploidy
    M = 2 * k
    counts = full_state_counts(k).astype(np.float64)      # [S, M]
    cov = dp.coverage[j].astype(np.float64)               # [M], 0 padded
    cov_cost = np.abs(cov[None, :] - counts / k).sum(axis=1)

    geno = dp.genotypes[j]                                # [A]
    A = geno.shape[0]
    cons = dp.consensus[j]                                # [M]
    onehot = np.zeros((M, A))
    valid_slot = (np.arange(M) < m) & (cons < A)
    onehot[np.arange(M)[valid_slot], cons[valid_slot]] = 1.0
    allele_counts = counts @ onehot                       # [S, A]
    geno_cost = 0.5 * np.abs(allele_counts - geno[None, :]).sum(axis=1)

    cost = (config.coverage_cost_weight * cov_cost
            + (config.genotype_cost_weight * geno_cost
               if config.use_genotypes else 0.0))
    return np.where(full_state_validity(k)[m], cost, np.inf)


def transition_costs(dp: DPInputs, j: int, config: PhasingConfig
                     ) -> np.ndarray:
    """[S_j, S_{j+1}] switch costs between positions j and j+1."""
    k = config.ploidy
    c0, c1 = dp.candidates[j], dp.candidates[j + 1]
    n0 = full_state_counts(k).astype(np.int32)            # [S, M]
    n1 = n0
    # map position-(j+1) slot counts onto position-j slots by cluster id
    match = ((c0[:, None] == c1[None, :])
             & (c0[:, None] >= 0)).astype(np.int32)       # [M, M]
    mapped = n1 @ match.T                                  # [S1, m0]
    inter = np.minimum(n0[:, None, :], mapped[None, :, :]).sum(axis=2)
    switches = k - inter
    return (config.switch_cost * switches
            + config.affine_switch_cost * (switches > 0))


def assign_rows(path: Sequence[Tuple[int, ...]], ploidy: int
                ) -> List[Tuple[int, ...]]:
    """Reorder each tuple so haplotype rows keep their cluster when it
    persists to the next position (row-continuity)."""
    if not path:
        return []
    rows = list(path[0])          # enumeration order is ascending already
    out = [tuple(rows)]
    for tup in path[1:]:
        remaining = Counter(tup)
        new_rows: List[int] = [-1] * ploidy
        for i, prev in enumerate(rows):
            if remaining[prev] > 0:
                new_rows[i] = prev
                remaining[prev] -= 1
        leftovers = sorted(remaining.elements())
        it = iter(leftovers)
        for i in range(ploidy):
            if new_rows[i] == -1:
                new_rows[i] = next(it)
        rows = new_rows
        out.append(tuple(rows))
    return out


