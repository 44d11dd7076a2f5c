"""Diploid threading-DP kernels: CUDA on the card, plain PyTorch on the CPU.

Counterpart of ``ahsoka_tpu/ops/minplus_diploid.py``.  The TPU version
lays 1024 chains over an [8, 128] vreg ("superblock") and streams
position blocks through VMEM; that layout is a TPU artefact and is not
part of this interface.  Here the public layout is the JAX package's
``[C, P, X]``, for any chain count C and any position count P:

    minplus_forward_diploid(candidates [C, P, 4] int32,
                            node_costs [C, P, 10] float32)
        -> final_costs [C, 10] float32, backptrs [C, P, 10] int32 (bp[:, 0] = 0)
    backtrace_diploid(backptrs [C, P, 10] int32, final_state [C] int32)
        -> states [C, P] int32

A CUDA tensor launches the hand-written kernels of
``csrc/minplus_stream.cu`` on that layout as it is (``dpk_forward_warp``,
one warp a chain, and ``dpk_backtrace``; ploidy 1 takes the same ones
through ``ops/minplus_stream.py``) or raises; a CPU tensor takes the
plain version (``*_ref``).  Nothing falls back from one to the other.
Each wrapper counts its kernel launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import torch

from ahsoka_tpu_torch.thread.states import full_state_counts
from ahsoka_tpu_torch.ops import minplus_stream as ms
from ahsoka_tpu_torch.ops.minplus import backtrace_ref, minplus_forward_ref

_M = 4                            # 2 * ploidy candidate slots
_S = 10                           # C(4 + 2 - 1, 2) diploid states


def minplus_forward_diploid_ref(candidates: torch.Tensor,
                                node_costs: torch.Tensor, *,
                                switch_cost: float, affine_cost: float):
    """Plain PyTorch diploid forward (the general multiset recurrence at
    ploidy 2)."""
    return minplus_forward_ref(candidates, node_costs, full_state_counts(2),
                               ploidy=2, switch_cost=switch_cost,
                               affine_cost=affine_cost)


def backtrace_diploid_ref(backptrs: torch.Tensor,
                          final_state: torch.Tensor) -> torch.Tensor:
    return backtrace_ref(backptrs, final_state)


def minplus_forward_diploid(candidates: torch.Tensor,
                            node_costs: torch.Tensor, *,
                            switch_cost: float, affine_cost: float):
    """Diploid min-plus forward pass over a chain batch (see module doc)."""
    ms._check(candidates, "candidates", torch.int32, 3, _M)
    ms._check(node_costs, "node_costs", torch.float32, 3, _S)
    if candidates.shape[:2] != node_costs.shape[:2]:
        raise ValueError(f"candidates {tuple(candidates.shape)} and "
                         f"node_costs {tuple(node_costs.shape)} disagree")
    if ms._route(candidates, node_costs) == "cpu":
        return minplus_forward_diploid_ref(
            candidates, node_costs, switch_cost=switch_cost,
            affine_cost=affine_cost)
    return ms._forward(candidates, node_costs, full_state_counts(2), 2, 1,
                       switch_cost, affine_cost,
                       caller=minplus_forward_diploid)


minplus_forward_diploid.launches = 0


def backtrace_diploid(backptrs: torch.Tensor,
                      final_state: torch.Tensor) -> torch.Tensor:
    """states [C, P] from backpointers and the final state of each chain."""
    if ms.check_backtrace_args(backptrs, final_state, _S) == "cpu":
        return backtrace_diploid_ref(backptrs, final_state)
    return ms._backtrace(backptrs, final_state, caller=backtrace_diploid)


backtrace_diploid.launches = 0
