"""Log-depth threading DP by an associative min-plus scan, in PyTorch.

Counterpart of ``ahsoka_tpu/thread/dp_assoc.py``.  The threading
recurrence is a min-plus (tropical) matrix product: with

    T_j[s, s'] = switch_cost(j-1 -> j)[s, s'] + node_j[s']

the forward cost at position j is ``node_0 (x) T_1 (x) ... (x) T_j``, where
``(x)`` is min-plus matrix multiplication, an associative operator.  The
prefixes of the T_j come from a Hillis-Steele scan: ceil(log2(P - 1))
rounds, each one batched min-plus product of every prefix with the one
``2^r`` positions before it, so the depth is logarithmic in the chain
length instead of the sequential scan's P - 1 steps.

Cost: O(P log P S^3) work against the sequential scan's O(P S^2), so it
pays only where the position count, not the work, is the limit.  The
returned path has the optimal cost; its tie picks may differ from the
sequential DP's, and its forward costs from the JAX package's in the last
bits (another association order of the same float32 sums).  This is plain
torch code on either device: the JAX package computes it in XLA, not in
Pallas.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ahsoka_tpu_torch.cluster.postprocess import DPInputs
from ahsoka_tpu_torch.config import PhasingConfig
from ahsoka_tpu_torch.state import to_torch
from ahsoka_tpu_torch.thread.dp_torch import node_costs_all
from ahsoka_tpu_torch.thread.states import (full_state_counts,
                                            full_state_validity, state_tuples)


def _minplus_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., S, S] (x) [..., S, S] in min-plus algebra."""
    return torch.amin(a[..., :, :, None] + b[..., None, :, :], dim=-2)


def _prefix_scan(T: torch.Tensor) -> torch.Tensor:
    """Inclusive min-plus prefixes of [N, S, S] by Hillis-Steele:
    prefix[i] = T[0] (x) ... (x) T[i], in ceil(log2 N) rounds."""
    out = T
    d = 1
    while d < out.shape[0]:
        out = torch.cat([out[:d], _minplus_matmul(out[:-d], out[d:])])
        d *= 2
    return out


def _assoc_forward(candidates, num_candidates, coverage, consensus,
                   genotypes, counts_table, valid_table, *, ploidy: int,
                   num_alleles: int, switch_cost: float, affine_cost: float,
                   cov_w: float, geno_w: float):
    """One chain ([P, ...] tensors on one device) -> (forward costs [P, S],
    transition matrices T [P-1, S, S] with the node costs added)."""
    k = ploidy
    dev = candidates.device
    node = node_costs_all(candidates[None], num_candidates[None],
                          coverage[None], consensus[None], genotypes[None],
                          counts_table, valid_table, ploidy=k,
                          num_alleles=num_alleles, cov_w=cov_w,
                          geno_w=geno_w)[0]                     # [P, S]
    counts = torch.as_tensor(counts_table, device=dev).to(torch.int32)
    cand_prev, cand_cur = candidates[:-1], candidates[1:]
    match = ((cand_prev[:, :, None] == cand_cur[:, None, :])
             & (cand_prev[:, :, None] >= 0)).to(torch.int32)  # [P-1, M, M]
    # mapped[p, s', m] = sum_q counts[s', q] * match[p, m, q]: the current
    # state's counts moved onto the previous position's slots
    mapped = (counts[None, :, None, :] * match[:, None, :, :]).sum(-1)
    inter = torch.minimum(counts[None, :, None, :],
                          mapped[:, None, :, :]).sum(-1)      # [P-1, S, S']
    switches = (k - inter).to(torch.float32)
    trans = switch_cost * switches + affine_cost * (switches > 0)
    T = trans + node[1:, None, :]
    if T.shape[0] == 0:
        return node, T
    prefixes = _prefix_scan(T)
    # forward cost at position j > 0: min_s node_0[s] + prefix_j[s, s']
    fwd_tail = torch.amin(node[0][None, :, None] + prefixes, dim=1)
    return torch.cat([node[:1], fwd_tail]), T


def thread_chain_assoc(dp: DPInputs, config: PhasingConfig, device="cuda"
                       ) -> List[Tuple[int, ...]]:
    """Min-cost multiset path of one chain on ``device`` (cost-optimal;
    ties may differ from the sequential DP's)."""
    P = dp.num_positions
    if P == 0:
        return []
    k = config.ploidy
    fwd, T = _assoc_forward(
        *to_torch(dp.candidates, dp.num_candidates,
                  dp.coverage.astype(np.float32), dp.consensus,
                  dp.genotypes.astype(np.float32), device=device),
        full_state_counts(k), full_state_validity(k), ploidy=k,
        num_alleles=dp.genotypes.shape[1],
        switch_cost=float(config.switch_cost),
        affine_cost=float(config.affine_switch_cost),
        cov_w=float(config.coverage_cost_weight),
        geno_w=float(config.genotype_cost_weight
                     if config.use_genotypes else 0.0))
    fwd = fwd.cpu().numpy()
    T = T.cpu().numpy()
    # greedy backtrace on the forward costs (T holds the node costs)
    states = np.zeros(P, dtype=np.int64)
    states[P - 1] = int(np.argmin(fwd[P - 1]))
    for j in range(P - 2, -1, -1):
        states[j] = int(np.argmin(fwd[j] + T[j][:, states[j + 1]]))
    tuples = state_tuples(2 * k, k)
    return [tuple(int(dp.candidates[j, slot]) for slot in tuples[int(s)])
            for j, s in enumerate(states)]
