"""Plain PyTorch min-plus DP forward pass and backtrace, any ploidy.

Counterpart of the forward scan of ``ahsoka_tpu/thread/dp_jax.py``
(``dp_forward_core``, :90-126) over a chain batch, as a Python loop over
positions.  It is the reference every DP kernel of the port is held
against, and the CPU path for every ploidy.

Layout (the JAX package's public ``[C, P, X]`` layout):
    candidates  [C, P, M] int32 (cluster ids, -1 for an empty slot)
    node_costs  [C, P, S] float32 (1e30 for invalid states)
    -> final_costs [C, S] float32, backptrs [C, P, S] int32 where
       backptrs[:, j, s] is the best state at j-1 for state s at j, and
       backptrs[:, 0] = 0.
"""

from __future__ import annotations

import torch

_INF = 1e30                      # finite sentinel, ahsoka_tpu/ops/minplus.py:35

# chain block of the reference forward: bounds the [Cb, S, S, M]
# intersection tensor (S = 330 at ploidy 4) to ~2^26 elements
_REF_CELLS = 1 << 26


def minplus_forward_ref(candidates: torch.Tensor, node_costs: torch.Tensor,
                        counts_table, *, ploidy: int, switch_cost: float,
                        affine_cost: float):
    C, P, M = candidates.shape
    S = node_costs.shape[2]
    dev = candidates.device
    counts = torch.as_tensor(counts_table, device=dev).to(torch.int32)
    if counts.shape != (S, M):
        raise ValueError(f"counts table {tuple(counts.shape)} does not match"
                         f" S={S}, M={M}")
    block = max(1, _REF_CELLS // max(S * S * M, 1))
    finals, bps = [], []
    for c0 in range(0, C, block):
        f, b = _forward_block(candidates[c0:c0 + block],
                              node_costs[c0:c0 + block], counts,
                              ploidy, switch_cost, affine_cost)
        finals.append(f)
        bps.append(b)
    if not finals:
        return (torch.zeros((0, S), dtype=torch.float32, device=dev),
                torch.zeros((0, P, S), dtype=torch.int32, device=dev))
    return torch.cat(finals), torch.cat(bps)


def _forward_block(cand, node, counts, k, switch_cost, affine_cost):
    C, P, M = cand.shape
    S = node.shape[2]
    dev = cand.device
    sw = torch.tensor(switch_cost, dtype=torch.float32, device=dev)
    af = torch.tensor(affine_cost, dtype=torch.float32, device=dev)
    bp = torch.zeros((C, P, S), dtype=torch.int32, device=dev)
    cost = node[:, 0].clone()
    cnt_prev = counts[None, :, None, :]                     # [1, S, 1, M]
    for j in range(1, P):
        cp, cc = cand[:, j - 1], cand[:, j]
        # match[c, mp, mc]: prev slot mp carries cur slot mc's cluster
        match = ((cp[:, :, None] == cc[:, None, :])
                 & (cp[:, :, None] >= 0)).to(torch.int32)
        # mapped[c, s', mp] = sum_mc counts[s', mc] * match[c, mp, mc]
        mapped = (counts[None, :, None, :] * match[:, None, :, :]).sum(-1)
        # inter[c, s, s'] = sum_mp min(counts[s, mp], mapped[c, s', mp])
        inter = torch.minimum(cnt_prev, mapped[:, None, :, :]).sum(-1)
        switches = (k - inter).to(torch.float32)
        trans = sw * switches + af * (switches > 0).to(torch.float32)
        total = cost[:, :, None] + trans                    # [C, S, S']
        bp[:, j] = torch.argmin(total, dim=1).to(torch.int32)
        cost = torch.amin(total, dim=1) + node[:, j]
    return cost, bp


def backtrace_ref(backptrs: torch.Tensor, final_state: torch.Tensor
                  ) -> torch.Tensor:
    """states [C, P] int32: states[:, P-1] = final_state,
    states[:, j-1] = backptrs[:, j, states[:, j]]."""
    C, P, _ = backptrs.shape
    states = torch.empty((C, P), dtype=torch.int32, device=backptrs.device)
    st = final_state.to(torch.int64)
    for j in range(P - 1, -1, -1):
        states[:, j] = st.to(torch.int32)
        if j:
            st = backptrs[:, j].gather(1, st[:, None])[:, 0].to(torch.int64)
    return states
