"""The plain reference of one phasing job, stage by stage.

Each function works one stage out again from the job's own GFA and GAF
(or from the stage before it), with the plain numpy and Python code of
this package: the frozen copies of the port's host oracle beside this
file, which import nothing of the program.  ``phasebench.judge`` calls
them stage by stage and compares each with what the timed run produced.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .alleles import enumerate_allele_paths
from .bubbleinfo import bubbleinfo_text
from .bubbles import find_bubbles
from .collapse import CollapsedReads, collapse_reads
from .config import PhasingConfig
from .covcap import subsample_matrix
from .dp_host import node_costs, transition_costs
from .gaf import read_gaf
from .gfa import parse_gfa
from .pairwise import AlleleMatrix, readset_to_matrix
from .postprocess import (DPInputs, build_dp_inputs_from_matrix,
                          consensus_lookup)
from .readset import build_chain_readsets
from .result import chain_result_lines
from .states import state_tuples
from .whatshap import score_pairs_whatshap


@dataclasses.dataclass
class Job:
    """A job's inputs as the reference reads them."""
    graph: object
    index: object
    allele_paths: Dict[int, Dict[int, List[List[int]]]]
    alignments: object
    size_sorting: List[Tuple[int, int]]
    bubbleinfo: str


def load_job(gfa_path: str, gaf_path: Optional[str],
             config: PhasingConfig) -> Job:
    """Parse, bubbles, allele paths, alignments by chain (none without a
    GAF: what the graph alone decides), chain order (largest first, ties
    by the larger chain id)."""
    graph = parse_gfa(gfa_path)
    index = find_bubbles(graph,
                         compat_std_ordering=config.compat_std_ordering)
    paths = enumerate_allele_paths(graph, index)
    table = None
    if gaf_path is not None:
        with open(gaf_path) as fh:
            table = read_gaf(fh, index, compat_duplicate_bucketing=
                             config.compat_duplicate_bucketing)
    order = sorted(((len(b), cid) for cid, b in paths.items()),
                   reverse=True)
    return Job(graph=graph, index=index, allele_paths=paths,
               alignments=table, size_sorting=order,
               bubbleinfo=bubbleinfo_text(index))


def chain_config(config: PhasingConfig, chain_id: int) -> PhasingConfig:
    """The effective config of one chain: ``config.ploidy_map``'s ploidy
    for the chain, else the global one (the program's rule,
    ``ahsoka_tpu_torch/phase.py`` ``chain_config``).  The batched driver
    runs a chain's matrix, collapse, banded scoring, DP inputs, DP and
    emission at it, and its dense scoring at the global ``config``."""
    pm = config.ploidy_map
    if not pm:
        return config
    k = int(pm.get(chain_id, config.ploidy))
    if k == config.ploidy:
        return config
    return dataclasses.replace(config, ploidy=k, ploidy_map=None)


def chain_matrix(job: Job, chain_id: int, config: PhasingConfig
                 ) -> Optional[AlleleMatrix]:
    """The chain's allele matrix after the coverage cap, or None when no
    read passes the filters.  The chain's alignments are bucketed once a
    node of their path; each alignment object is read once, which is the
    same readset (a repeat of the same alignment adds nothing)."""
    seen = set()
    alignments = []
    for a in job.alignments.chain_alignments(chain_id):
        if id(a) not in seen:
            seen.add(id(a))
            alignments.append(a)
    readsets = build_chain_readsets(job.allele_paths[chain_id], alignments,
                                    config)
    if len(readsets.partial_filtered) == 0:
        return None
    matrix = readset_to_matrix(readsets.partial_filtered)
    if config.max_coverage is not None:
        matrix, _ = subsample_matrix(matrix, config.max_coverage)
    return matrix


def chain_collapse(matrix: AlleleMatrix, config: PhasingConfig
                   ) -> Optional[CollapsedReads]:
    """The identical-row collapse the configuration asks for, or None."""
    if not config.ce_collapse_identical \
            or matrix.num_reads < config.ce_collapse_min_reads:
        return None
    cm = collapse_reads(matrix)
    return cm if cm.num_groups <= config.ce_collapse_max_ratio \
        * matrix.num_reads else None


def chain_scores(matrix: AlleleMatrix, collapse: Optional[CollapsedReads],
                 config: PhasingConfig, gemm: str = "float64"
                 ) -> np.ndarray:
    """The pair scores of the rows that the solver clusters: the distinct
    rows of a collapsed chain, else every read."""
    if collapse is not None:
        return score_pairs_whatshap(collapse.matrix, config,
                                    mult=collapse.mult, gemm=gemm)
    return score_pairs_whatshap(matrix, config, gemm=gemm)


def solver_weights(scores: np.ndarray,
                   collapse: Optional[CollapsedReads]) -> np.ndarray:
    """The edge weights the solver reads: m_u * m_v * s(u, v) over the
    groups of a collapsed chain, else the scores."""
    if collapse is None:
        return scores
    w = scores * np.outer(collapse.mult, collapse.mult)
    np.fill_diagonal(w, 0.0)
    return w


def is_banded(matrix: AlleleMatrix, collapse: Optional[CollapsedReads],
              config: PhasingConfig) -> bool:
    """Whether the program scores the chain's band (and solves it with
    its sparse solver): more effective rows, the collapse's groups or
    else the reads, than ``banded_scoring_threshold``."""
    rows = collapse.num_groups if collapse is not None \
        else matrix.num_reads
    return rows > config.banded_scoring_threshold


def dp_inputs(matrix: AlleleMatrix, clusters: Sequence[Sequence[int]],
              config: PhasingConfig) -> DPInputs:
    cluster_of = np.full(matrix.num_reads, -1, dtype=np.int32)
    for cid, members in enumerate(clusters):
        cluster_of[list(members)] = cid
    return build_dp_inputs_from_matrix(matrix.alleles, matrix.positions,
                                       cluster_of, config)


def path_states(dp: DPInputs, path: Sequence[Sequence[int]],
                ploidy: int) -> Optional[List[int]]:
    """The DP state of each position of a path of cluster-id tuples, or
    None where a tuple names a cluster that is no candidate there."""
    tuples = state_tuples(2 * ploidy, ploidy)
    index = {t: s for s, t in enumerate(tuples)}
    out = []
    for j, tup in enumerate(path):
        slot_of = {int(c): s for s, c in
                   enumerate(dp.candidates[j][:int(dp.num_candidates[j])])}
        try:
            slots = tuple(sorted(slot_of[int(c)] for c in tup))
        except KeyError:
            return None
        if slots not in index:
            return None
        out.append(index[slots])
    return out


@dataclasses.dataclass
class DPCosts:
    """Every position's node costs [S] and every step's transition costs
    [S, S] (float64, +inf for states over empty slots)."""
    nodes: List[np.ndarray]
    trans: List[np.ndarray]


def dp_costs(dp: DPInputs, config: PhasingConfig) -> DPCosts:
    P = dp.num_positions
    return DPCosts(nodes=[node_costs(dp, j, config) for j in range(P)],
                   trans=[transition_costs(dp, j, config)
                          for j in range(P - 1)])


def path_cost(costs: DPCosts, states: Sequence[int]) -> float:
    """The DP's objective for one state a position."""
    cost = 0.0
    for j, s in enumerate(states):
        cost += float(costs.nodes[j][s])
        if j:
            cost += float(costs.trans[j - 1][states[j - 1], s])
    return cost


def best_path(dp: DPInputs, config: PhasingConfig, costs: DPCosts
              ) -> Tuple[List[Tuple[int, ...]], float]:
    """The least-cost path of cluster-id tuples and its cost: the
    recurrence of ``dp_host.thread_chain`` (first minimum on ties)."""
    P = dp.num_positions
    if P == 0:
        return [], 0.0
    cost = costs.nodes[0]
    backptr = []
    for j in range(P - 1):
        total = cost[:, None] + costs.trans[j]
        best_prev = np.argmin(total, axis=0)
        cost = total[best_prev, np.arange(total.shape[1])] \
            + costs.nodes[j + 1]
        backptr.append(best_prev)
    state = int(np.argmin(cost))
    states = [state]
    for j in range(P - 2, -1, -1):
        state = int(backptr[j][state])
        states.append(state)
    states.reverse()
    return states_path(dp, states, config.ploidy), path_cost(costs, states)


def states_path(dp: DPInputs, states: Sequence[int], ploidy: int
                ) -> List[Tuple[int, ...]]:
    """The path of cluster-id tuples of one DP state a position."""
    tuples = state_tuples(2 * ploidy, ploidy)
    return [tuple(int(dp.candidates[j, slot]) for slot in tuples[s])
            for j, s in enumerate(states)]


def result_lines(job: Job, chain_id: int, dp: DPInputs,
                 path: Sequence[Sequence[int]], ploidy: int) -> List[str]:
    """The chain's result-file lines for a path of cluster-id tuples."""
    from .dp_host import assign_rows

    return chain_result_lines(
        job.graph, assign_rows(path, ploidy), consensus_lookup(dp),
        [int(p) for p in dp.positions], job.allele_paths[chain_id], ploidy)
