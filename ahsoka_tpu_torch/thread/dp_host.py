"""Haplotype-threading DP — host (numpy) oracle.

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

This oracle is the ground truth for the vectorised device DP
(thread/dp_jax.py, ops/minplus Pallas kernel); tests also validate it
against brute-force enumeration on tiny instances.
"""

from __future__ import annotations

from collections import Counter
from typing import List, Sequence, Tuple

import numpy as np

from ahsoka_tpu_torch.cluster.postprocess import DPInputs
from ahsoka_tpu_torch.config import PhasingConfig
from ahsoka_tpu_torch.thread.states import (full_state_counts,
                                      full_state_validity, state_tuples)


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


def thread_chain(dp: DPInputs, config: PhasingConfig
                 ) -> List[Tuple[int, ...]]:
    """Min-cost multiset path through the clusters; one tuple of cluster
    ids (slot order) per dense position."""
    P = dp.num_positions
    if P == 0:
        return []
    cost = node_costs(dp, 0, config)
    backptr: List[np.ndarray] = []
    for j in range(P - 1):
        trans = transition_costs(dp, j, config)           # [S_j, S_j+1]
        total = cost[:, None] + trans                     # [S_j, S_j+1]
        best_prev = np.argmin(total, axis=0)
        cost = total[best_prev, np.arange(total.shape[1])] \
            + node_costs(dp, j + 1, config)
        backptr.append(best_prev.astype(np.int32))

    state = int(np.argmin(cost))
    states_rev = [state]
    for j in range(P - 2, -1, -1):
        state = int(backptr[j][state])
        states_rev.append(state)
    states = states_rev[::-1]

    tuples = state_tuples(2 * config.ploidy, config.ploidy)
    path = []
    for j, s in enumerate(states):
        slots = tuples[s]
        path.append(tuple(int(dp.candidates[j, slot]) for slot in slots))
    return path


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


def thread_and_assign(dp: DPInputs, config: PhasingConfig
                      ) -> List[Tuple[int, ...]]:
    return assign_rows(thread_chain(dp, config), config.ploidy)


def brute_force_thread(dp: DPInputs, config: PhasingConfig
                       ) -> Tuple[float, List[Tuple[int, ...]]]:
    """Exhaustive minimum for tiny instances (test oracle)."""
    import itertools

    P = dp.num_positions
    valid = full_state_validity(config.ploidy)
    options = []
    for j in range(P):
        m = int(dp.num_candidates[j])
        nodes = node_costs(dp, j, config)
        options.append([s for s in range(len(nodes)) if valid[m, s]])
    node_vals = [node_costs(dp, j, config) for j in range(P)]
    trans = [transition_costs(dp, j, config) for j in range(P - 1)]
    best_cost, best_seq = np.inf, None
    for seq in itertools.product(*options):
        c = sum(node_vals[j][seq[j]] for j in range(P))
        c += sum(trans[j][seq[j], seq[j + 1]] for j in range(P - 1))
        if c < best_cost - 1e-12:
            best_cost, best_seq = c, seq
    tuples = state_tuples(2 * config.ploidy, config.ploidy)
    path = []
    for j, s in enumerate(best_seq):
        slots = tuples[s]
        path.append(tuple(int(dp.candidates[j, slot]) for slot in slots))
    return float(best_cost), path
