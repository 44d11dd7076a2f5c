"""The beam-pruned threading DP, plain: what the judge holds a beam
chain's path to.

The program's published rule (``ahsoka_tpu_torch/thread/dp_beam.py``,
the WhatsHap ``rowLimit`` analog), in float64 and plain torch ops:

- at each position keep the ``width`` cheapest states, ascending, ties
  to the lowest state index (a stable sort of every state's cost);
- transitions run from the kept beam into the full state set; each
  state's predecessor is the first beam slot of least cost;
- node costs are ``dp_host.node_costs``', transitions
  ``dp_host.transition_costs``' rule (the multiset intersection of
  cluster ids), worked out for the beam's rows only, so that no [S, S]
  matrix is built (S = 12,376 at ploidy 6);
- the path ends in the least final cost's slot (the first on ties) and
  is read back through the slots' predecessors.

No kernel of the program, no jax; matmuls are left out (the
intersection is a min and a sum over small integers) and TF32 is off
while it runs.  It runs on ``device`` (a card where there is one), the
beam's rows in blocks of at most ``_CELLS`` [rows, S, M] cells.
"""

from __future__ import annotations

import contextlib
from typing import List, Sequence, Tuple

import numpy as np

from .config import PhasingConfig
from .dp_host import node_costs
from .postprocess import DPInputs
from .states import full_state_counts, max_states, state_tuples

_CELLS = 1 << 25


def beam_width(config: PhasingConfig) -> int:
    """The beam the program runs a chain of ``config`` through: its
    ``dp_beam_width`` where the state space exceeds it, else 0 (the
    exact DP; ``thread/dp_torch.py`` ``_beam_width_for``)."""
    bw = int(config.dp_beam_width or 0)
    return bw if bw and max_states(config.ploidy) > bw else 0


def switches(a: Sequence[int], b: Sequence[int], ploidy: int) -> int:
    """k minus the multiset intersection of two tuples of cluster ids."""
    a, b = sorted(a), sorted(b)
    i = j = inter = 0
    while i < len(a) and j < len(b):
        if a[i] == b[j]:
            inter += 1
            i += 1
            j += 1
        elif a[i] < b[j]:
            i += 1
        else:
            j += 1
    return ploidy - inter


def path_cost(dp: DPInputs, states: Sequence[int], config: PhasingConfig
              ) -> float:
    """The DP's objective along one state a position: each position's
    node cost and the switch cost between consecutive states."""
    tuples = state_tuples(2 * config.ploidy, config.ploidy)
    cost = 0.0
    prev = None
    for j, s in enumerate(states):
        cost += float(node_costs(dp, j, config)[s])
        tup = [int(dp.candidates[j, slot]) for slot in tuples[s]]
        if prev is not None:
            sw = switches(prev, tup, config.ploidy)
            cost += float(config.switch_cost * sw
                          + config.affine_switch_cost * (sw > 0))
        prev = tup
    return cost


@contextlib.contextmanager
def _no_tf32(torch):
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def best_beam_path(dp: DPInputs, config: PhasingConfig, width: int,
                   device=None) -> Tuple[List[int], float]:
    """The plain beam's path (one state a position) and its cost."""
    import torch

    dev = torch.device("cpu") if device is None else torch.device(device)
    P = dp.num_positions
    if P == 0:
        return [], 0.0
    k = config.ploidy
    with _no_tf32(torch), torch.no_grad():
        counts = torch.as_tensor(full_state_counts(k).astype(np.int8),
                                 device=dev)                     # [S, M]
        S, M = counts.shape
        B = min(int(width), S)
        rows = max(1, _CELLS // (S * M))

        def node(j):
            return torch.as_tensor(node_costs(dp, j, config), device=dev)

        def prune(c):
            order = torch.sort(c, stable=True).indices[:B]
            return c[order], order

        cost, idx = prune(node(0))
        beams = [idx]
        backs = [None]
        for j in range(1, P):
            c0 = torch.as_tensor(dp.candidates[j - 1], device=dev)
            c1 = torch.as_tensor(dp.candidates[j], device=dev)
            # match[mp, mc]: slot mp at j-1 holds slot mc's cluster at j
            match = ((c0[:, None] == c1[None, :]) & (c0[:, None] >= 0)
                     ).to(torch.int8)
            # mapped[s, mp]: the count state s at j puts on slot mp at j-1
            mapped = (counts[:, None, :] * match[None, :, :]).sum(
                -1, dtype=torch.int32).to(torch.int8)
            best = torch.full((S,), float("inf"), dtype=torch.float64,
                              device=dev)
            arg = torch.zeros(S, dtype=torch.int64, device=dev)
            for r0 in range(0, B, rows):
                a = counts[idx[r0:r0 + rows]]                    # [b, M]
                inter = torch.minimum(a[:, None, :], mapped[None, :, :]
                                      ).sum(-1, dtype=torch.int32)
                sw = (k - inter).to(torch.float64)
                total = (cost[r0:r0 + rows, None]
                         + (config.switch_cost * sw
                            + config.affine_switch_cost * (sw > 0)))
                m, a_ = torch.min(total, dim=0)
                # strictly less: an earlier slot keeps a tie
                take = m < best
                best = torch.where(take, m, best)
                arg = torch.where(take, a_ + r0, arg)
            cost, idx = prune(best + node(j))
            beams.append(idx)
            backs.append(arg[idx])
        slot = int(torch.argmin(cost))
        least = float(cost[slot])
        states = []
        for j in range(P - 1, -1, -1):
            states.append(int(beams[j][slot]))
            if j:
                slot = int(backs[j][slot])
        states.reverse()
    return states, least
