"""WhatsHap-published pairwise read scoring (parity mode).

The reference calls WhatsHap's ``ReadScoring::scoreReadsetLocal(&sim,
testset, minOverlap=1, ploidy)`` (src/alignmentstoreadset.cpp:308-311).
The WhatsHap C++ sources are not in the reference tree and cannot be
fetched in this environment (BASELINE.md), so this module implements the
algorithm **as published** in the WhatsHap polyphase paper (Schrinner,
Serra Mari, Ebler, Rautiainen, Seillier, Reimer, Usadel, Marschall,
Klau — "Haplotype threading: accurate polyploid phasing of the potato
genome", Genome Biology 21:252, 2020; Methods, read scoring):

For a read pair (i, j) sharing ``ov`` variant positions with ``d``
disagreements, the score is the log-likelihood ratio of two binomial
models::

    S(i, j) = log Binom(d; ov, p_s) - log Binom(d; ov, p_d(i, j))
            = d * log(p_s / p_d) + (ov - d) * log((1 - p_s) / (1 - p_d))

- ``p_s`` -- probability that two reads *from the same haplotype*
  disagree at a shared position.  Estimated from the data: the relative
  Hamming distances of all overlapping read pairs form a mixture whose
  low mode is the same-haplotype component; with ~uniform haplotype
  coverage a fraction 1/ploidy of pairs is same-haplotype, so ``p_s`` is
  the mean of the lowest ``1/ploidy`` fraction of observed distances.
- ``p_d(i, j)`` -- probability that two reads *from different
  haplotypes* disagree, estimated **locally** from the allele
  frequencies at the positions the pair shares ("local" in
  scoreReadsetLocal).  Per position p, the reads covering p vote allele
  counts n_a; the most likely number of haplotypes carrying each allele,
  c_a (sum_a c_a = ploidy), maximises the multinomial likelihood
  ``prod_a (c_a / k)^{n_a}`` (greedy slot allocation -- optimal because
  the per-slot gains ``n_a * log((c+1)/c)`` are decreasing).  Two
  distinct haplotypes then carry the same allele with probability
  ``sum_a c_a * (c_a - 1) / (k * (k - 1))``, and::

      p_d(p) = P_differ(p) * (1 - p_s) + (1 - P_differ(p)) * p_s
      p_d(i, j) = mean over shared positions of p_d(p), floored at p_s

  (if the haplotypes agree at p, the reads disagree exactly like a
  same-haplotype pair; if they differ, the reads *agree* only when
  sequencing errors mask the difference, probability 1 - p_s for the
  biallelic case).

Byte-level details the paper does not pin down (and which cannot be
checked against the unavailable C++): the exact same-fraction quantile
estimator for p_s, clamping constants, and tie-breaking in the slot
allocation (larger count first, then smaller allele id).  Those choices
are documented inline.  The repo's own fresh derivation remains available
as ``config.score_mode = "fresh"`` (score/pairwise.py).

Everything factorises into (reads x positions) matmuls -- overlap,
agreement, and the per-pair sum of p_d(p) over shared positions -- so
the identical formulation runs as this host oracle (numpy, float64) and
as the MXU tensor program in score/device.py.

Frozen copy of ``ahsoka_tpu_torch/score/whatshap.py``, so that a
change to the program cannot move the reference.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .config import PhasingConfig
from .pairwise import (AlleleMatrix, _EPS_CLIP,
                                       overlap_and_agreement)

_P_S_MIN = 2.0e-4
_P_S_MAX = 0.49


def haplotype_multiplicities(counts: np.ndarray, ploidy: int) -> np.ndarray:
    """Most likely per-allele haplotype multiplicities, per position.

    counts: [P, A] observed allele counts.  Returns [P, A] integers with
    each row summing to ``ploidy``, maximising the multinomial likelihood
    prod_a (c_a / k)^{n_a}.  Greedy slot-by-slot allocation is exactly
    optimal (concave decreasing gains); first slots go to alleles in
    descending count order (ties: smaller allele id), matching the
    likelihood limit when more alleles are observed than haplotypes.
    """
    P, A = counts.shape
    c = np.zeros((P, A), dtype=np.int32)
    counts = counts.astype(np.float64)
    rows = np.arange(P)
    for _ in range(ploidy):
        cf = c.astype(np.float64)
        grown = counts * np.log1p(1.0 / np.maximum(cf, 1.0))
        # the first slot of any observed allele dominates every repeat
        # slot (a zero multiplicity has -inf likelihood), so while a row
        # has observed-but-unallocated alleles the slot goes to the one
        # with the largest count (argmax ties -> smaller allele id)
        eligible0 = (c == 0) & (counts > 0)
        gain = np.where(eligible0.any(axis=1)[:, None],
                        np.where(eligible0, counts, -np.inf),
                        grown)
        best = np.argmax(gain, axis=1)
        c[rows, best] += 1
    return c


def p_differ_positions(matrix: AlleleMatrix, ploidy: int,
                       mult: Optional[np.ndarray] = None) -> np.ndarray:
    """Per-position probability that two *distinct* haplotypes carry
    different alleles, from the multiplicity-rounded allele counts.

    ``mult`` weights each row (identical-read collapsing,
    project/collapse.py): the counts then equal the full uncollapsed
    matrix's counts exactly."""
    # O(nnz) bincount over covered entries (rows are position-sparse;
    # the per-allele dense passes cost seconds at [50k, 10k]); the COO
    # comes from the matrix's shared cache (covered_coo)
    r_nz, p_nz, v_nz = matrix.covered_coo()
    num_alleles = max(int(v_nz.max(initial=-1)) + 1, 2)
    a_nz = v_nz.astype(np.int64)
    w = None if mult is None else mult[r_nz].astype(np.float64)
    counts = np.bincount(
        p_nz.astype(np.int64) * num_alleles + a_nz, weights=w,
        minlength=matrix.num_positions * num_alleles
    ).reshape(matrix.num_positions, num_alleles).astype(np.float64)
    c = haplotype_multiplicities(counts, ploidy).astype(np.float64)
    k = float(ploidy)
    if ploidy < 2:
        return np.zeros(matrix.num_positions)
    same = (c * (c - 1.0)).sum(axis=1) / (k * (k - 1.0))
    return np.clip(1.0 - same, 0.0, 1.0)


def estimate_p_s(matrix: AlleleMatrix, config: PhasingConfig,
                 overlap: Optional[np.ndarray] = None,
                 agree: Optional[np.ndarray] = None) -> float:
    """Same-haplotype disagreement rate from the low mode of the pairwise
    relative-Hamming-distance distribution: with ~uniform haplotype
    coverage a 1/ploidy fraction of overlapping pairs is same-haplotype,
    so p_s = mean of the lowest ceil(N/ploidy) observed distances."""
    if overlap is None or agree is None:
        overlap, agree = overlap_and_agreement(matrix)
    iu = np.triu_indices(matrix.num_reads, k=1)
    o, a = overlap[iu], agree[iu]
    valid = o >= max(config.min_overlap, 2)
    if not valid.any():
        eps = config.error_rate
        return float(np.clip(2.0 * eps * (1.0 - eps), _P_S_MIN, _P_S_MAX))
    rates = (o[valid] - a[valid]) / o[valid]
    m = max(1, int(np.ceil(len(rates) / max(config.ploidy, 2))))
    lowest = np.partition(rates, m - 1)[:m]
    return float(np.clip(lowest.mean(), _P_S_MIN, _P_S_MAX))


def estimate_p_s_weighted(matrix: AlleleMatrix, mult: np.ndarray,
                          config: PhasingConfig) -> float:
    """estimate_p_s over a collapsed matrix (project/collapse.py),
    byte-equal to running the full uncollapsed estimator: a group pair
    (U, V) stands for ``m_U * m_V`` read pairs at the same rate, and the
    diagonal (U, U) for ``C(m_U, 2)`` within-group pairs at rate 0 (full
    agreement) — both enter the weighted lowest-1/ploidy mean with their
    exact pair counts."""
    overlap, agree = overlap_and_agreement(matrix)
    G = matrix.num_reads
    iu = np.triu_indices(G, k=0)             # diagonal included
    o, a = overlap[iu], agree[iu]
    m_u, m_v = mult[iu[0]], mult[iu[1]]
    w = np.where(iu[0] == iu[1], m_u * (m_u - 1) // 2, m_u * m_v)
    valid = (o >= max(config.min_overlap, 2)) & (w > 0)
    if not valid.any():
        eps = config.error_rate
        return float(np.clip(2.0 * eps * (1.0 - eps), _P_S_MIN, _P_S_MAX))
    rates = (o[valid] - a[valid]) / o[valid]
    w = w[valid].astype(np.int64)
    total = int(w.sum())
    m = max(1, -(-total // max(config.ploidy, 2)))   # ceil
    order = np.argsort(rates, kind="stable")
    r_s, w_s = rates[order], w[order]
    prev = np.cumsum(w_s) - w_s
    take = np.clip(m - prev, 0, w_s)
    return float(np.clip((r_s * take).sum() / m, _P_S_MIN, _P_S_MAX))


def chain_p_s(matrix: AlleleMatrix, config: PhasingConfig,
              error_rate: Optional[float] = None,
              overlap: Optional[np.ndarray] = None,
              agree: Optional[np.ndarray] = None,
              mult: Optional[np.ndarray] = None) -> float:
    """The p_s a chain should score with: explicit eps override wins,
    then data estimation, then the configured eps.  ``mult`` routes the
    estimation through the exact weighted form (collapsed matrices)."""
    if error_rate is not None:
        return float(np.clip(2.0 * error_rate * (1.0 - error_rate),
                             _P_S_MIN, _P_S_MAX))
    if config.estimate_error_rate:
        if mult is not None:
            return estimate_p_s_weighted(matrix, mult, config)
        return estimate_p_s(matrix, config, overlap, agree)
    eps = config.error_rate
    return float(np.clip(2.0 * eps * (1.0 - eps), _P_S_MIN, _P_S_MAX))


def position_pd(matrix: AlleleMatrix, config: PhasingConfig,
                p_s: float,
                mult: Optional[np.ndarray] = None) -> np.ndarray:
    """Per-position disagreement probability for a different-haplotype
    pair: p_d(p) = P_differ(p)*(1-p_s) + (1-P_differ(p))*p_s."""
    differ = p_differ_positions(matrix, config.ploidy, mult=mult)
    return differ * (1.0 - p_s) + (1.0 - differ) * p_s


def finish_scores(overlap: np.ndarray, agree: np.ndarray,
                  pd_sum: np.ndarray, p_s: float,
                  min_overlap: int) -> np.ndarray:
    """Elementwise binomial-LLR finisher shared by host/device/banded
    paths: inputs are the pair matrices of overlap counts, agreement
    counts, and summed per-position p_d over shared positions."""
    ov = np.maximum(overlap, 1.0)
    p_d = np.clip(pd_sum / ov, p_s, 1.0 - _EPS_CLIP)
    d = overlap - agree
    with np.errstate(divide="ignore", invalid="ignore"):
        scores = (d * np.log(p_s / p_d)
                  + (overlap - d) * np.log((1.0 - p_s) / (1.0 - p_d)))
    scores = np.where(overlap < min_overlap, 0.0, scores)
    return scores


def tf32(x: np.ndarray) -> np.ndarray:
    """``x`` rounded to TF32 (8 exponent bits, 10 mantissa bits, round
    to nearest even), as float32: what a tensor core reads of a float32
    operand when TF32 is on."""
    b = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    b = (b + np.uint32(0xFFF) + ((b >> np.uint32(13)) & np.uint32(1))) \
        & np.uint32(0xFFFFE000)
    return b.view(np.float32)


def score_pairs_whatshap(matrix: AlleleMatrix, config: PhasingConfig,
                         error_rate: Optional[float] = None,
                         mult: Optional[np.ndarray] = None,
                         gemm: str = "float64") -> np.ndarray:
    """Symmetric [R, R] score matrix (the host oracle); exactly 0 where
    overlap < min_overlap and on the diagonal.  ``mult`` weights the
    per-position statistics by row multiplicity (collapsed matrices);
    the pairwise part stays per-representative-row.  ``gemm="tf32"``
    computes the per-pair p_d sum with TF32 operands and float32
    accumulation: the precision below the float32 GEMMs of the system
    under test, for the control that the comparison has to fail.
    ``gemm="float32"`` computes it with float32 operands and
    accumulation, the precision class of the system under test, for
    ``phasebench.readings``' witness of the solver's near-ties."""
    overlap, agree = overlap_and_agreement(matrix)
    p_s = chain_p_s(matrix, config, error_rate, overlap, agree, mult=mult)
    pd = position_pd(matrix, config, p_s, mult=mult)
    mask = (matrix.alleles >= 0).astype(np.float64)
    if gemm == "tf32":
        pd_sum = (tf32(mask * pd[None, :]) @ tf32(mask).T).astype(
            np.float64)
    elif gemm == "float32":
        pd_sum = ((mask * pd[None, :]).astype(np.float32)
                  @ mask.astype(np.float32).T).astype(np.float64)
    elif gemm == "float64":
        pd_sum = (mask * pd[None, :]) @ mask.T
    else:
        raise ValueError(f"unknown gemm precision {gemm!r}")
    scores = finish_scores(overlap, agree, pd_sum, p_s, config.min_overlap)
    np.fill_diagonal(scores, 0.0)
    return scores
