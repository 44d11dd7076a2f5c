"""DP state space: multisets of `ploidy` clusters per position.

The threading DP's states at a position are multisets (tuples with
repetition) of size `ploidy` drawn from that position's candidate clusters
(between ploidy and 2*ploidy of them) — the reference's WhatsHap
HaploThreader state model (src/alignmentstoreadset.cpp:319-409 call site,
SURVEY.md §2b).  For m candidates and ploidy k there are C(m+k-1, k)
states; with m <= 2k that is 10 for diploid and 330 for tetraploid.

States are enumerated in lexicographic order of candidate-slot indices
(itertools.combinations_with_replacement), giving a static count-matrix
layout per (m, k) that the device DP reuses across positions and chains.
"""

from __future__ import annotations

import functools
import itertools
from math import comb
from typing import List, Tuple

import numpy as np


@functools.lru_cache(maxsize=None)
def state_tuples(num_candidates: int, ploidy: int
                 ) -> Tuple[Tuple[int, ...], ...]:
    """All multisets of size `ploidy` over slots 0..num_candidates-1."""
    return tuple(itertools.combinations_with_replacement(
        range(num_candidates), ploidy))


@functools.lru_cache(maxsize=None)
def state_counts(num_candidates: int, ploidy: int) -> np.ndarray:
    """[S, m] multiplicity of each candidate slot in each state."""
    tuples = state_tuples(num_candidates, ploidy)
    counts = np.zeros((len(tuples), num_candidates), dtype=np.int8)
    for s, t in enumerate(tuples):
        for slot in t:
            counts[s, slot] += 1
    return counts


def num_states(num_candidates: int, ploidy: int) -> int:
    return comb(num_candidates + ploidy - 1, ploidy)


def max_states(ploidy: int) -> int:
    """State-space size at the 2*ploidy candidate cap."""
    return num_states(2 * ploidy, ploidy)


@functools.lru_cache(maxsize=None)
def full_state_counts(ploidy: int) -> np.ndarray:
    """[S, M] count matrix of the *full-width* enumeration: every DP path
    (host oracle, XLA scan, Pallas kernel, native C++) indexes states by
    ``state_tuples(2*ploidy, ploidy)`` regardless of how many candidates a
    position actually has; states that reference an empty slot are masked
    with +inf node cost.  One static table, uniform shapes."""
    return state_counts(2 * ploidy, ploidy)


@functools.lru_cache(maxsize=None)
def full_state_validity(ploidy: int) -> np.ndarray:
    """[M+1, S] validity: state s is usable at a position with m candidates
    iff its largest referenced slot is < m (tuples are sorted)."""
    m_max = 2 * ploidy
    tuples = state_tuples(m_max, ploidy)
    valid = np.zeros((m_max + 1, len(tuples)), dtype=bool)
    for s, t in enumerate(tuples):
        for m in range(1, m_max + 1):
            valid[m, s] = t[-1] < m
    return valid


def state_cluster_ids(candidates: np.ndarray, ploidy: int
                      ) -> List[Tuple[int, ...]]:
    """Map full-width slot-index states to cluster-id multisets."""
    return [tuple(int(candidates[slot]) for slot in t)
            for t in state_tuples(2 * ploidy, ploidy)]
