"""Cluster post-processing: per-position coverage, candidate-cluster
selection, and cluster consensus — the inputs of the threading DP.

Behavior matched from src/alignmentstoreadset.cpp:550-779:

- ``get_coverage`` (:660-697): per position, per cluster, the fraction of
  that position's read coverage contributed by the cluster.
- ``get_pos_to_clusters_map`` (:751-779): per covered position keep between
  ploidy and 2*ploidy clusters sorted by coverage descending, cutting when
  relative coverage drops below 1/(8*ploidy).  Coverage ties keep ascending
  cluster-id order (the reference's std::sort degenerates to stable
  insertion sort for the <= 2*ploidy+ entries involved).
- ``get_local_cluster_consensus`` (:550-655): per (position, candidate
  cluster) the majority allele over the cluster's reads (ties -> smallest
  allele id) and its fraction.

Divergence (documented): the reference flattens coverage by ascending
cluster id but candidate clusters by coverage rank, feeding the DP
misaligned coverage values whenever those orders differ
(src/alignmentstoreadset.cpp:378-392 vs :751-779).  We align both to the
candidate order — the coherent semantics the DP describes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

from ahsoka_tpu_torch.config import PhasingConfig
from ahsoka_tpu_torch.project.readset import ReadSet


@dataclasses.dataclass
class DPInputs:
    """Per-chain threading-DP inputs over dense (covered) positions."""
    positions: np.ndarray        # int32 [P] original bubble positions
    candidates: np.ndarray       # int32 [P, M] cluster ids, -1 padding
    num_candidates: np.ndarray   # int32 [P]
    coverage: np.ndarray         # float32 [P, M] relative coverage, aligned
    consensus: np.ndarray        # int32 [P, M] majority allele, aligned
    genotypes: np.ndarray        # int32 [P, A] target allele multiplicities

    @property
    def num_positions(self) -> int:
        return self.positions.shape[0]

    @property
    def max_candidates(self) -> int:
        return self.candidates.shape[1]


def default_genotypes(num_positions: int, ploidy: int,
                      num_alleles: int = 2) -> np.ndarray:
    """The reference pins every genotype to {0:1, 1:1}
    (src/alignmentstoreadset.cpp:341-344); generalised to a balanced
    biallelic genotype for ploidy k."""
    geno = np.zeros((num_positions, max(num_alleles, 2)), dtype=np.int32)
    geno[:, 0] = (ploidy + 1) // 2
    geno[:, 1] = ploidy // 2
    return geno


def balanced_genotypes(allele_totals: np.ndarray, ploidy: int
                       ) -> np.ndarray:
    """Data-driven balanced k-allele prior (config.genotype_prior =
    "balanced"): per position, the `ploidy` haplotype slots are allocated
    to the observed alleles by the same greedy-ML multiplicity rounding
    the scoring stage uses (score/whatshap.py).  For polyploid bubbles
    whose alleles are k distinct branches this yields {a:1 for each
    observed a} — the prior the reference's diploid {0:1,1:1}
    (src/alignmentstoreadset.cpp:341-344) cannot express for k>2.

    allele_totals: [P, A] allele counts summed over clusters."""
    from ahsoka_tpu_torch.score.whatshap import haplotype_multiplicities

    return haplotype_multiplicities(
        allele_totals.astype(np.float64), ploidy).astype(np.int32)


def build_dp_inputs(readset: ReadSet, clusters: Sequence[Sequence[int]],
                    config: PhasingConfig) -> DPInputs:
    positions = readset.positions()
    pos_index = {p: j for j, p in enumerate(positions)}
    P, K = len(positions), len(clusters)
    num_alleles = 1 + max(
        (a for r in readset for a in r.alleles), default=1)
    A = max(num_alleles, 2)

    # [P, K] read-coverage counts and [P, K, A] allele counts
    cov_counts = np.zeros((P, K), dtype=np.int64)
    allele_counts = np.zeros((P, K, A), dtype=np.int64)
    for cid, cluster in enumerate(clusters):
        for rid in cluster:
            read = readset.get(rid)
            for p, a in zip(read.positions, read.alleles):
                j = pos_index[p]
                cov_counts[j, cid] += 1
                allele_counts[j, cid, a] += 1
    return _dp_inputs_from_counts(
        np.asarray(positions, dtype=np.int32), cov_counts, allele_counts,
        config)


def build_dp_inputs_from_matrix(alleles: np.ndarray, positions: np.ndarray,
                                cluster_of: np.ndarray,
                                config: PhasingConfig) -> DPInputs:
    """Vectorised DPInputs from a dense [R, P] allele matrix and a per-read
    cluster assignment (the matrix-native pipeline's path; parity-tested
    against build_dp_inputs)."""
    R, P = alleles.shape
    K = int(cluster_of.max()) + 1 if R else 0
    A = max(int(alleles.max(initial=-1)) + 1, 2)
    # counts via bincount over the covered entries: each read covers a
    # handful of positions, so this is O(nnz) — the [P, R] @ [R, K]
    # integer matmul it replaces cannot use BLAS and ran for HOURS at
    # 50k reads x 10k positions x 2.5k clusters (config-2 scale)
    r_nz, p_nz = np.nonzero(alleles >= 0)
    k_nz = cluster_of[r_nz].astype(np.int64)
    a_nz = alleles[r_nz, p_nz].astype(np.int64)
    pk = p_nz.astype(np.int64) * K + k_nz
    cov_counts = np.bincount(pk, minlength=P * K).reshape(P, K)
    allele_counts = np.bincount(pk * A + a_nz,
                                minlength=P * K * A).reshape(P, K, A)
    return _dp_inputs_from_counts(positions.astype(np.int32), cov_counts,
                                  allele_counts, config)


def _dp_inputs_from_counts(positions: np.ndarray, cov_counts: np.ndarray,
                           allele_counts: np.ndarray,
                           config: PhasingConfig) -> DPInputs:
    P, K = cov_counts.shape
    A = allele_counts.shape[2]
    totals = np.maximum(cov_counts.sum(axis=1, keepdims=True), 1)
    rel_cov = cov_counts / totals

    ploidy = config.ploidy
    M = 2 * ploidy
    cutoff = 1.0 / (config.coverage_cutoff_denom * ploidy)

    candidates = np.full((P, M), -1, dtype=np.int32)
    num_candidates = np.zeros(P, dtype=np.int32)
    coverage = np.zeros((P, M), dtype=np.float32)
    consensus = np.zeros((P, M), dtype=np.int32)

    for j in range(P):
        covering = np.nonzero(cov_counts[j] > 0)[0]
        # sort by coverage desc; stable tie-break keeps ascending cluster id
        order = covering[np.argsort(-rel_cov[j, covering], kind="stable")]
        cut = min(len(order), M)
        for i in range(ploidy, min(len(order), M)):
            if rel_cov[j, order[i]] < cutoff:
                cut = i
                break
        chosen = order[:cut]
        num_candidates[j] = len(chosen)
        for slot, cid in enumerate(chosen):
            candidates[j, slot] = cid
            coverage[j, slot] = rel_cov[j, cid]
            counts = allele_counts[j, cid]
            if counts.sum() > 0:
                # majority allele; ties -> smallest allele id (the
                # reference's ascending-count scan with strict >)
                consensus[j, slot] = int(np.argmax(counts))
            else:
                consensus[j, slot] = 0
    if getattr(config, "genotype_prior", "reference") == "balanced":
        genotypes = balanced_genotypes(allele_counts.sum(axis=1), ploidy)
    else:
        genotypes = default_genotypes(P, ploidy, A)
    return DPInputs(positions=np.asarray(positions, dtype=np.int32),
                    candidates=candidates, num_candidates=num_candidates,
                    coverage=coverage, consensus=consensus,
                    genotypes=genotypes)


def consensus_lookup(dp: DPInputs) -> List[Dict[int, int]]:
    """Per dense position: {cluster id -> consensus allele} (the reference's
    ``new_consensus`` map used at emission, src/alignmentstoreadset.cpp:422).
    """
    out: List[Dict[int, int]] = []
    for j in range(dp.num_positions):
        d = {}
        for slot in range(int(dp.num_candidates[j])):
            d[int(dp.candidates[j, slot])] = int(dp.consensus[j, slot])
        out.append(d)
    return out
