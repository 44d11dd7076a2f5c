"""Batched threading DP through the port's CUDA kernels.

Counterpart of ``thread_batch_pallas_diploid`` and
``thread_batch_pallas_streamed`` (``ahsoka_tpu/thread/dp_pallas.py:91-184``):
node costs (torch on the device) -> forward kernel -> ``torch.argmin`` of
the final costs (first minimum) -> backtrace kernel.  Ploidy 2 takes the
diploid wrappers, ploidy 1 and 3-5 the general-ploidy ones; both launch
the kernels of ``csrc/minplus_stream.cu``: ``dpk_forward_warp`` at ploidy
1 and 2, ``dpk_forward`` at 3-5, ``dpk_backtrace`` at every ploidy.  The TPU
versions padded the chain axis to 128-chain lane blocks or 1024-chain
superblocks; the CUDA kernels take any chain count, so nothing is padded
here.  CPU tensors run the same sequence through the kernels' plain
versions.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ahsoka_tpu_torch.ops.minplus_diploid import (backtrace_diploid,
                                                  minplus_forward_diploid)
from ahsoka_tpu_torch.ops.minplus_stream import (KERNEL_LAUNCHES,
                                                 backtrace_streamed,
                                                 minplus_forward_streamed)
from ahsoka_tpu_torch.thread.dp_torch import node_costs_all

WRAPPERS = (minplus_forward_diploid, backtrace_diploid,
            minplus_forward_streamed, backtrace_streamed)


def launch_counts() -> Dict[str, int]:
    """CUDA launches of each DP kernel since the last reset, by kernel."""
    return dict(KERNEL_LAUNCHES)


def reset_launch_counts() -> None:
    """Zero the kernel counts and the wrappers' own ``launches``."""
    for name in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[name] = 0
    for fn in WRAPPERS:
        fn.launches = 0


def _thread_batch(forward, backtrace, candidates, num_candidates, coverage,
                  consensus, genotypes, counts_table, valid_table, *,
                  ploidy: int, num_alleles: int, cov_w: float,
                  geno_w: float):
    node = node_costs_all(candidates, num_candidates, coverage, consensus,
                          genotypes, counts_table, valid_table,
                          ploidy=ploidy, num_alleles=num_alleles,
                          cov_w=cov_w, geno_w=geno_w).contiguous()
    final_costs, backptrs = forward(candidates.contiguous(), node)
    final_state = torch.argmin(final_costs, dim=1).to(torch.int32)
    return backtrace(backptrs, final_state), final_costs


def thread_batch_diploid(candidates, num_candidates, coverage, consensus,
                         genotypes, counts_table, valid_table, *,
                         ploidy: int, num_alleles: int, switch_cost: float,
                         affine_cost: float, cov_w: float = 1.0,
                         geno_w: float = 1.0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[C, P, ...] chain-batched tensors -> (states [C, P] int32,
    final_costs [C, 10] f32), on the inputs' device."""
    if ploidy != 2:
        raise ValueError("thread_batch_diploid requires ploidy=2")

    def forward(cand, node):
        return minplus_forward_diploid(cand, node, switch_cost=switch_cost,
                                       affine_cost=affine_cost)

    return _thread_batch(forward, backtrace_diploid, candidates,
                         num_candidates, coverage, consensus, genotypes,
                         counts_table, valid_table, ploidy=ploidy,
                         num_alleles=num_alleles, cov_w=cov_w, geno_w=geno_w)


def thread_batch_streamed(candidates, num_candidates, coverage, consensus,
                          genotypes, counts_table, valid_table, *,
                          ploidy: int, num_alleles: int, switch_cost: float,
                          affine_cost: float, cov_w: float = 1.0,
                          geno_w: float = 1.0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Any ploidy the general kernel takes: [C, P, ...] chain-batched
    tensors -> (states [C, P] int32, final_costs [C, S] f32)."""

    def forward(cand, node):
        return minplus_forward_streamed(cand, node, counts_table,
                                        ploidy=ploidy,
                                        switch_cost=switch_cost,
                                        affine_cost=affine_cost)

    return _thread_batch(forward, backtrace_streamed, candidates,
                         num_candidates, coverage, consensus, genotypes,
                         counts_table, valid_table, ploidy=ploidy,
                         num_alleles=num_alleles, cov_w=cov_w, geno_w=geno_w)
