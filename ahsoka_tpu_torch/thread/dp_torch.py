"""Haplotype-threading DP over chain batches in PyTorch.

Counterpart of ``ahsoka_tpu/thread/dp_jax.py``: the same full-width state
enumeration (multisets of ``ploidy`` over M = 2*ploidy slots, S =
C(3k-1, k) states, invalid states at node cost 1e30), the same position
bucketing with sentinel positions, and the same grouping of chains by
(padded positions, allele count, ploidy).

Dispatch per group: a group whose state space exceeds ``dp_beam_width``
(ploidy 6, or any ploidy with a narrower beam) takes the beam-pruned DP
(``thread/dp_beam.py``, torch code on either device); otherwise
(``thread/dp_kernels.py``) ploidy 2 takes the diploid kernels and ploidy
1 and 3-5 the general-ploidy ones, for every group whatever its size.
On CUDA the wrappers launch the hand-written kernels; on the CPU they run
their plain PyTorch versions, which take any ploidy.  With
``chain_shards`` > 1 a group's chains split over a mesh of devices and
each shard runs the same dispatch on its chains.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ahsoka_tpu_torch.cluster.postprocess import DPInputs
from ahsoka_tpu_torch.config import PhasingConfig
from ahsoka_tpu_torch.dist.mesh import CHAIN_AXIS, gated_mesh, local_devices
from ahsoka_tpu_torch.dist.step import sharded_thread_states
from ahsoka_tpu_torch.thread.dp_host import assign_rows
from ahsoka_tpu_torch.thread.states import (full_state_counts,
                                      full_state_validity, state_tuples)
from ahsoka_tpu_torch.utils import substage
from ahsoka_tpu_torch.ops.minplus import _INF
from ahsoka_tpu_torch.state import to_torch


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _bucket_positions(P: int, bucket: int = 128) -> int:
    """Padded position count: multiples of 8 up to ``bucket``, then
    multiples of ``bucket`` up to 1024, then multiples of 1024
    (``dp_jax._bucket_positions``).  The sentinel positions it adds are
    real DP inputs (candidates -1: a constant cost on every path), so the
    port keeps the JAX package's bucketing to thread identical inputs."""
    if P <= bucket:
        return _round_up(P, min(bucket, _round_up(P, 8)))
    if P <= 1024:
        return _round_up(P, bucket)
    return _round_up(P, 1024)


def node_costs_all(candidates, num_candidates, coverage, consensus,
                   genotypes, counts_table, valid_table, *, ploidy: int,
                   num_alleles: int, cov_w: float, geno_w: float
                   ) -> torch.Tensor:
    """[C, P, S] node costs for every chain and position (invalid states
    -> 1e30).  Inputs are chain-batched tensors on one device:
    candidates/consensus [C, P, M] int32, num_candidates [C, P] int32,
    coverage [C, P, M] f32, genotypes [C, P, A] f32; counts_table [S, M]
    and valid_table [M+1, S] (``thread/states.py``).

    The coverage term sums over the M slots left to right, one rounding
    per add; the genotype term is exact (small integers).  Bit-equal to
    ``dp_jax.node_costs_all`` as the jitted DP programs compile it."""
    k = ploidy
    dev = candidates.device
    countsf = torch.as_tensor(counts_table, device=dev).to(torch.float32)
    valid_t = torch.as_tensor(valid_table, device=dev)
    valid = valid_t[num_candidates.long()]                   # [C, P, S]
    M = countsf.shape[1]
    # XLA compiles coverage - count / k into one fused multiply-add with
    # the float32 reciprocal of k, fma(-count, 1/k, coverage), rounded
    # once (it differs from two roundings at k = 3, 5, 6).  Emulated in
    # float64, where the product and the difference are exact.
    target = countsf.double() * float(np.float32(1) / np.float32(k))
    cov64 = coverage.double()

    def term(m):
        return torch.abs((cov64[:, :, None, m] - target[:, m]).float())

    cov_cost = term(0)
    for m in range(1, M):
        cov_cost = cov_cost + term(m)
    alleles = torch.arange(num_alleles, device=dev)
    cons_oh = (consensus[..., None] == alleles).to(torch.float32)
    cons_oh = cons_oh * (candidates >= 0).to(torch.float32)[..., None]
    allele_counts = torch.einsum("sm,cpma->cpsa", countsf, cons_oh)
    geno_cost = 0.5 * torch.abs(allele_counts
                                - genotypes[:, :, None, :]).sum(-1)
    node = cov_w * cov_cost + geno_w * geno_cost
    return torch.where(valid, node,
                       torch.tensor(_INF, dtype=torch.float32, device=dev))


def _beam_width_for(config: PhasingConfig, S: int) -> int:
    """Active beam width: configured, and the state space exceeds it."""
    bw = int(getattr(config, "dp_beam_width", 0) or 0)
    return bw if bw and S > bw else 0


def _pack_group(dps: List[DPInputs], members: List[int], P_pad: int):
    """Stack a group's chains at P_pad positions with the JAX package's
    sentinel padding (candidates -1, one candidate, zero coverage)."""
    ca, nc, co, cs, ge = [], [], [], [], []
    for idx in members:
        dp = dps[idx]
        pad = P_pad - dp.num_positions
        ca.append(np.pad(dp.candidates, ((0, pad), (0, 0)),
                         constant_values=-1))
        nc.append(np.pad(dp.num_candidates, (0, pad), constant_values=1))
        co.append(np.pad(dp.coverage, ((0, pad), (0, 0))))
        cs.append(np.pad(dp.consensus, ((0, pad), (0, 0))))
        ge.append(np.pad(dp.genotypes, ((0, pad), (0, 0))))
    return (np.stack(ca), np.stack(nc), np.stack(co).astype(np.float32),
            np.stack(cs), np.stack(ge).astype(np.float32))


def thread_states(ca, nc, co, cs, ge, config: PhasingConfig, *,
                  ploidy: int, num_alleles: int) -> torch.Tensor:
    """One shape group ([C, P_pad, ...] tensors on one device) -> the
    [C, P_pad] int32 state matrix, on the group's device."""
    k = ploidy
    counts_table = full_state_counts(k)
    valid_table = full_state_validity(k)
    geno_w = (config.genotype_cost_weight if config.use_genotypes else 0.0)
    kw = dict(ploidy=k, num_alleles=num_alleles,
              switch_cost=float(config.switch_cost),
              affine_cost=float(config.affine_switch_cost),
              cov_w=float(config.coverage_cost_weight), geno_w=float(geno_w))
    bw = _beam_width_for(config, counts_table.shape[0])
    if bw:
        from ahsoka_tpu_torch.thread.dp_beam import thread_beam
        return thread_beam(ca, nc, co, cs, ge, beam_width=bw, **kw)
    from ahsoka_tpu_torch.thread.dp_kernels import (thread_batch_diploid,
                                                    thread_batch_streamed)
    thread_batch = thread_batch_diploid if k == 2 else thread_batch_streamed
    states, _ = thread_batch(ca, nc, co, cs, ge, counts_table, valid_table,
                             **kw)
    return states


def thread_chains_batched(dps: List[DPInputs], config: PhasingConfig,
                          bucket: int = 128, chain_configs=None,
                          device="cuda", devices=None
                          ) -> List[List[Tuple[int, ...]]]:
    """Thread many chains with one DP call per (P_pad, A, ploidy) group;
    identical paths to ``dp_jax.thread_chains_batched`` (same padding and
    argmin tie-breaks).  ``chain_configs`` carries each dp's effective
    config (per-chain ploidy overrides).  With ``chain_shards`` > 1 and
    that many devices in ``devices`` (every process's), a group's chains
    split over a mesh (``dist.step.sharded_thread_states``); beam groups
    stay unsharded (``dp_jax.py:439-443``)."""
    dev = torch.device(device)
    devs = local_devices(devices, dev)
    if chain_configs is None:
        chain_configs = [config] * len(dps)
    groups: dict = {}
    for idx, dp in enumerate(dps):
        P = dp.num_positions
        if P == 0:
            continue
        P_pad = _bucket_positions(P, bucket)
        groups.setdefault((P_pad, dp.genotypes.shape[1],
                           chain_configs[idx].ploidy), []).append(idx)

    paths: List[List[Tuple[int, ...]]] = [[] for _ in dps]
    for (P_pad, A, k), members in groups.items():
        cfg = chain_configs[members[0]]
        tuples = state_tuples(2 * k, k)
        with substage.timed("threading.pack"):
            arrays = _pack_group(dps, members, P_pad)
        mesh = gated_mesh(
            cfg.chain_shards, CHAIN_AXIS, devs, dev, "threading DP",
            reason=("beam-pruned group" if _beam_width_for(cfg, len(tuples))
                    else None))
        if mesh is None:
            with substage.timed("threading.upload"):
                ca, nc, co, cs, ge = to_torch(*arrays, device=dev)
        with substage.timed("threading.kernel"):
            if mesh is None:
                states = thread_states(ca, nc, co, cs, ge, cfg, ploidy=k,
                                       num_alleles=A)
            else:
                states = sharded_thread_states(mesh, arrays, cfg, ploidy=k,
                                               num_alleles=A)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
                substage.count("device.round_trips")
        with substage.timed("threading.fetch"):
            states = states.cpu().numpy()
            substage.count("device.round_trips")
            substage.count("device.fetch_bytes", states.nbytes)
        with substage.timed("threading.expand"):
            for row, idx in enumerate(members):
                dp = dps[idx]
                paths[idx] = [tuple(int(dp.candidates[j, slot])
                                    for slot in tuples[int(states[row, j])])
                              for j in range(dp.num_positions)]
    return paths


def thread_chain_device(dp: DPInputs, config: PhasingConfig,
                        bucket: int = 128, device="cuda", devices=None
                        ) -> List[Tuple[int, ...]]:
    """One chain (the per-chain driver, and the keep-going per-chain
    retry): the batched DP at a batch of one, same padding as
    ``dp_jax.thread_chain_device``, so one forward and one backtrace
    launch on the card."""
    if dp.num_positions == 0:
        return []
    return thread_chains_batched([dp], config, bucket, device=device,
                                 devices=devices)[0]


def thread_and_assign_device(dp: DPInputs, config: PhasingConfig,
                             device="cuda", devices=None
                             ) -> List[Tuple[int, ...]]:
    """``thread_chain_device`` with the haplotype rows assigned
    (``dp_jax.thread_and_assign_device``)."""
    return assign_rows(thread_chain_device(dp, config, device=device,
                                           devices=devices), config.ploidy)
