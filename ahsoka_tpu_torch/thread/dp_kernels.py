"""Batched diploid threading DP through the port's CUDA kernels.

Counterpart of ``thread_batch_pallas_diploid``
(``ahsoka_tpu/thread/dp_pallas.py:141-184``): node costs (torch on the
device) -> forward kernel -> ``torch.argmin`` of the final costs (first
minimum) -> backtrace kernel.  The TPU version padded the chain axis to
1024-chain superblocks; the CUDA kernels take any chain count, so
nothing is padded here.  CPU tensors run the same sequence through the
kernels' plain versions.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ahsoka_tpu_torch.ops.minplus_diploid import (backtrace_diploid,
                                                  minplus_forward_diploid)
from ahsoka_tpu_torch.thread.dp_torch import node_costs_all

KERNELS = {"dp2_forward": minplus_forward_diploid,
           "dp2_backtrace": backtrace_diploid}


def launch_counts() -> Dict[str, int]:
    """CUDA launches of each diploid kernel since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


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
    node = node_costs_all(candidates, num_candidates, coverage, consensus,
                          genotypes, counts_table, valid_table,
                          ploidy=ploidy, num_alleles=num_alleles,
                          cov_w=cov_w, geno_w=geno_w).contiguous()
    final_costs, backptrs = minplus_forward_diploid(
        candidates.contiguous(), node, switch_cost=switch_cost,
        affine_cost=affine_cost)
    final_state = torch.argmin(final_costs, dim=1).to(torch.int32)
    states = backtrace_diploid(backptrs, final_state)
    return states, final_costs
