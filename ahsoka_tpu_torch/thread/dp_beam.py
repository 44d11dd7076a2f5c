"""Beam-pruned threading DP over chain batches in PyTorch (ploidy 6).

Counterpart of ``dp_forward_beam_core``, ``_backtrace_beam``,
``_beam_states_to_path`` and the batched gather of
``thread_chains_batched`` (``ahsoka_tpu/thread/dp_jax.py:134-214``,
``:453-459``): at every position only the ``beam_width`` cheapest states
survive, transitions run from the retained beam into the full state set,
and the frontier is pruned again.  In the JAX package this is an XLA
program (``lax.scan`` + ``lax.top_k``), not a Pallas kernel, so the port
is torch code on either device.

Layout (``ops/minplus.py``'s ``[C, P, X]``), with B = min(beam_width, S):

    dp_forward_beam(candidates [C, P, M] int32, node_costs [C, P, S] f32,
                    counts_table [S, M], *, ploidy, beam_width,
                    switch_cost, affine_cost)
        -> final_costs [C, B] f32, beam_states [C, P, B] int32,
           backptrs [C, P, B] int32 (the beam slot at j-1 of the best
           predecessor of slot b at j; backptrs[:, 0] = 0)

Bit-equal to the JAX package on the CPU and on the card:
- pruning sorts the costs stably, ascending: the ``lax.top_k(-cost, B)``
  order, lowest state index first on ties (most invalid states tie at
  the finite 1e30 sentinel, so the order decides which slots the
  backpointers name);
- the multiset intersection Σ_m min(a_m, b_m) is the product of the 0/1
  planes [a_m >= t] and [b_m >= t] (t = 1..k): an fp32 matmul of 0/1
  operands whose sums stay below M·k, so it is exact on any device and
  under TF32 alike; float matmuls are the only ones CUDA offers;
- ``cost + trans`` and ``min + node`` are one rounding each, as in the
  scan; argmin keeps the first minimum.
"""

from __future__ import annotations

import torch

from ahsoka_tpu_torch.thread.states import full_state_counts, full_state_validity
from ahsoka_tpu_torch.ops.minplus import backtrace_ref
from ahsoka_tpu_torch.thread.dp_torch import node_costs_all

# live [Cb, B, S] cells of one chain block (k=6, B=2048: 5 chains, about
# 2 GB of float32 temporaries)
_BEAM_CELLS = 1 << 27


def _ge_planes(counts: torch.Tensor, k: int) -> torch.Tensor:
    """[..., M] slot counts -> [..., M*k] float 0/1 planes [c_m >= t],
    t = 1..k, so that planes(a) . planes(b) = Σ_m min(a_m, b_m)."""
    t = torch.arange(1, k + 1, dtype=counts.dtype, device=counts.device)
    ge = counts[..., None] >= t
    return ge.reshape(*counts.shape[:-1], -1).to(torch.float32)


def _prune(cost: torch.Tensor, B: int):
    """The B cheapest states per chain, ascending, ties -> lowest index."""
    vals, idx = torch.sort(cost, dim=1, stable=True)
    return vals[:, :B].contiguous(), idx[:, :B].contiguous()


def dp_forward_beam(candidates: torch.Tensor, node_costs: torch.Tensor,
                    counts_table, *, ploidy: int, beam_width: int,
                    switch_cost: float, affine_cost: float):
    """Top-B pruned min-plus forward pass over a chain batch (see the
    module doc).  Chains run in blocks of at most ``_BEAM_CELLS`` live
    [B, S] cells."""
    C, _, M = candidates.shape
    S = node_costs.shape[2]
    counts = torch.as_tensor(counts_table,
                             device=candidates.device).to(torch.int32)
    if counts.shape != (S, M):
        raise ValueError(f"counts table {tuple(counts.shape)} does not match"
                         f" S={S}, M={M}")
    B = min(int(beam_width), S)
    block = max(1, _BEAM_CELLS // (B * S))
    outs = [_beam_block(candidates[c0:c0 + block],
                        node_costs[c0:c0 + block], counts, ploidy, B,
                        switch_cost, affine_cost)
            for c0 in range(0, C, block)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _beam_block(cand, node, counts, k, B, switch_cost, affine_cost):
    C, P, M = cand.shape
    dev = cand.device
    planes = _ge_planes(counts, k)                          # [S, M*k]
    cost, idx = _prune(node[:, 0], B)                       # [C, B]
    states = torch.zeros((C, P, B), dtype=torch.int32, device=dev)
    bp = torch.zeros((C, P, B), dtype=torch.int32, device=dev)
    states[:, 0] = idx.to(torch.int32)
    for j in range(1, P):
        cp, cc = cand[:, j - 1], cand[:, j]
        # match[c, mp, mc]: prev slot mp carries cur slot mc's cluster
        match = ((cp[:, :, None] == cc[:, None, :])
                 & (cp[:, :, None] >= 0)).to(torch.int32)
        # mapped[c, s, mp] = sum_mc counts[s, mc] * match[c, mp, mc]
        mapped = (counts[None, :, None, :] * match[:, None, :, :]).sum(-1)
        # inter[c, b, s] = sum_mp min(counts[idx[c, b], mp], mapped[c, s, mp])
        inter = torch.bmm(planes[idx], _ge_planes(mapped, k).transpose(1, 2))
        # trans = switch * (k - inter) + affine * [inter < k], exact
        # small integers, then one rounding for cost + trans (in place)
        switches = inter.neg_().add_(k)
        jumped = (switches > 0).to(torch.float32).mul_(affine_cost)
        total = switches.mul_(switch_cost).add_(jumped)
        del jumped
        total.add_(cost[:, :, None])                        # [C, B, S]
        best = torch.argmin(total, dim=1)                   # [C, S]
        cost_all = total.gather(1, best[:, None, :])[:, 0] + node[:, j]
        del inter, switches, total
        cost, idx = _prune(cost_all, B)
        states[:, j] = idx.to(torch.int32)
        bp[:, j] = best.gather(1, idx).to(torch.int32)
    return cost, states, bp


def backtrace_beam(backptrs: torch.Tensor, beam_states: torch.Tensor,
                   final_slot: torch.Tensor) -> torch.Tensor:
    """Slot walk from ``final_slot`` [C] (``backtrace_ref``, over beam
    slots), then the slots' states: [C, P] int32."""
    slots = backtrace_ref(backptrs, final_slot)
    return beam_states.gather(2, slots.to(torch.int64)[:, :, None])[:, :, 0]


def thread_beam(candidates, num_candidates, coverage, consensus, genotypes,
                *, ploidy: int, num_alleles: int, beam_width: int,
                switch_cost: float, affine_cost: float, cov_w: float,
                geno_w: float) -> torch.Tensor:
    """One shape group ([C, P, ...] tensors on one device) -> the [C, P]
    int32 state matrix through the beam.  ``thread_beam.launches`` counts
    the groups run on a CUDA device."""
    counts = full_state_counts(ploidy)
    node = node_costs_all(candidates, num_candidates, coverage, consensus,
                          genotypes, counts, full_state_validity(ploidy),
                          ploidy=ploidy, num_alleles=num_alleles,
                          cov_w=cov_w, geno_w=geno_w)
    final, beam_states, bp = dp_forward_beam(
        candidates, node, counts, ploidy=ploidy, beam_width=beam_width,
        switch_cost=switch_cost, affine_cost=affine_cost)
    final_slot = torch.argmin(final, dim=1).to(torch.int32)
    if candidates.device.type == "cuda":
        thread_beam.launches += 1
    return backtrace_beam(bp, beam_states, final_slot)


thread_beam.launches = 0
