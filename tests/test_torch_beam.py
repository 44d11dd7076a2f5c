"""The port's beam-pruned threading DP (``thread/dp_beam.py``) on the CPU
against the JAX package's on identical seeded inputs: beam states, slot
backpointers, final slot and paths exactly equal.

The reference is the JAX beam as the package runs it, jitted
(``_dp_forward_beam``, ``_dp_forward_beam_batched``).  Under jit XLA
computes the node costs' ``coverage - count / k`` as one fused
multiply-add with the reciprocal of k, which the port reproduces; the
eager op-by-op evaluation rounds twice and differs in the last bit at
ploidy 3, 5 and 6."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ahsoka_tpu.cluster.postprocess import DPInputs
from ahsoka_tpu.config import PhasingConfig
from ahsoka_tpu.thread import dp_jax
from ahsoka_tpu.thread.states import (full_state_counts, full_state_validity,
                                      num_states)
from ahsoka_tpu_torch.state import to_torch
from ahsoka_tpu_torch.thread import dp_beam, dp_torch

from test_dp import random_dp_inputs

torch.set_num_threads(1)

SW, AF = 32.0, 8.0


def _jax_beam_batched(arrays, k, B):
    """(beam_states [C, P, B], backptrs [C, P-1, B], final slot [C],
    states [C, P]) of the JAX package's batched beam."""
    ct, vt = full_state_counts(k), full_state_validity(k)
    fslot, bs, bps = dp_jax._dp_forward_beam_batched(
        *[jnp.asarray(a) for a in arrays], jnp.asarray(ct), jnp.asarray(vt),
        jnp.float32(SW), jnp.float32(AF), jnp.float32(1.0),
        jnp.float32(1.0), ploidy=k, num_alleles=arrays[4].shape[2],
        beam_width=B)
    s0, tail = dp_jax._backtrace_beam_batched(fslot, bps)
    bs = np.asarray(bs)
    slots = np.concatenate([np.asarray(s0)[:, None], np.asarray(tail)], 1)
    states = np.take_along_axis(bs, slots[:, :, None], axis=2)[:, :, 0]
    return bs, np.asarray(bps), np.asarray(fslot), states


def _torch_beam(arrays, k, B):
    ct, vt = full_state_counts(k), full_state_validity(k)
    ca, nc, co, cs, ge = to_torch(*arrays, device="cpu")
    A = ge.shape[2]
    node = dp_torch.node_costs_all(ca, nc, co, cs, ge, ct, vt, ploidy=k,
                                   num_alleles=A, cov_w=1.0, geno_w=1.0)
    final, bs, bps = dp_beam.dp_forward_beam(
        ca, node, ct, ploidy=k, beam_width=B, switch_cost=SW,
        affine_cost=AF)
    states = dp_beam.thread_beam(ca, nc, co, cs, ge, ploidy=k,
                                 num_alleles=A, beam_width=B,
                                 switch_cost=SW, affine_cost=AF, cov_w=1.0,
                                 geno_w=1.0)
    return final, bs, bps, states


def _assert_batch_equal(arrays, k, B):
    want_bs, want_bp, want_slot, want_states = _jax_beam_batched(arrays, k,
                                                                 B)
    final, bs, bps, states = _torch_beam(arrays, k, B)
    np.testing.assert_array_equal(bs.numpy(), want_bs)
    np.testing.assert_array_equal(bps.numpy()[:, 1:], want_bp)
    assert not bps[:, 0].any()
    np.testing.assert_array_equal(
        torch.argmin(final, dim=1).numpy(), want_slot)
    np.testing.assert_array_equal(states.numpy(), want_states)
    # the pruned frontier is sorted ascending
    assert bool((final[:, 1:] >= final[:, :-1]).all())


def _single(dp, k, B, P):
    """One chain through the jitted ``dp_forward_beam_core``,
    ``_backtrace_beam`` and ``_beam_states_to_path``."""
    ct, vt = full_state_counts(k), full_state_validity(k)
    fslot, bs, bps = dp_jax._dp_forward_beam(
        jnp.asarray(dp.candidates), jnp.asarray(dp.num_candidates),
        jnp.asarray(dp.coverage, dtype=jnp.float32),
        jnp.asarray(dp.consensus),
        jnp.asarray(dp.genotypes, dtype=jnp.float32), jnp.asarray(ct),
        jnp.asarray(vt), ploidy=k, num_alleles=dp.genotypes.shape[1],
        switch_cost=jnp.float32(SW), affine_cost=jnp.float32(AF),
        cov_w=jnp.float32(1.0), geno_w=jnp.float32(1.0), beam_width=B)
    s0, tail = dp_jax._backtrace_beam(fslot, bps)
    path = dp_jax._beam_states_to_path(bs, s0, tail, P)
    return np.asarray(bs), int(fslot), path


@pytest.mark.parametrize("k,B", [(2, 10), (2, 2), (2, 4), (3, 56), (3, 48),
                                 (3, 4)])
def test_beam_matches_jax_core(k, B):
    """B = S, B = S - 8 and a small B that prunes hard."""
    S = num_states(2 * k, k)
    assert B in (S, S - 8, 4)
    dp = random_dp_inputs(P=16, ploidy=k, num_clusters=2 * k + 1,
                          seed=10 * k + B)
    want_bs, want_slot, want_path = _single(dp, k, B, 16)
    arrays = dp_torch._pack_group([dp], [0], 16)
    final, bs, _, states = _torch_beam(arrays, k, B)
    np.testing.assert_array_equal(bs.numpy()[0], want_bs)
    assert int(torch.argmin(final[0])) == want_slot
    np.testing.assert_array_equal(states.numpy()[0], want_path)


@pytest.mark.parametrize("k,B", [(2, 4), (3, 8), (3, 56)])
def test_beam_all_ties_matches_jax(k, B):
    """Two candidates at most positions (most states invalid, all at the
    1e30 sentinel) and equal coverage: the order of tied states decides
    which slots the backpointers name."""
    dps = [random_dp_inputs(P=24, ploidy=k, num_clusters=2 * k + 1,
                            seed=300 + i) for i in range(3)]
    ca, nc, co, cs, ge = dp_torch._pack_group(dps, [0, 1, 2], 24)
    few = np.arange(24) % 3 != 0             # 2 of 3 positions
    ca[:, few] = -1
    ca[:, few, :2] = [0, 1]
    nc[:, few] = 2
    co[:, few] = 0.0
    co[:, few, :2] = 0.5
    cs[:, few] = 0
    _assert_batch_equal((ca, nc, co, cs, ge), k, B)


@pytest.mark.parametrize("case", ["dominant", "random"])
def test_beam_ploidy6_matches_jax(case):
    """k = 6 (S = 12,376) at B = 256: the ploidy-6 chain of
    tests/test_beam_dp.py and a random one."""
    k, B, M = 6, 256, 12
    if case == "dominant":
        P = 6
        cov = np.full((P, M), 1.0 / M, dtype=np.float32)
        cov[:, :6] = 1.5 / M
        cov /= cov.sum(axis=1, keepdims=True)
        geno = np.zeros((P, 2), dtype=np.int32)
        geno[:, 0], geno[:, 1] = 3, 3
        dp = DPInputs(positions=np.arange(P, dtype=np.int32),
                      candidates=np.tile(np.arange(M, dtype=np.int32),
                                         (P, 1)),
                      num_candidates=np.full(P, M, dtype=np.int32),
                      coverage=cov,
                      consensus=(np.arange(M) % 2).astype(np.int32)
                      * np.ones((P, M), dtype=np.int32),
                      genotypes=geno)
    else:
        P = 12
        dp = random_dp_inputs(P=P, ploidy=k, num_clusters=2 * k + 1,
                              seed=7)
    want_bs, want_slot, want_path = _single(dp, k, B, P)
    final, bs, _, states = _torch_beam(dp_torch._pack_group([dp], [0], P),
                                       k, B)
    np.testing.assert_array_equal(bs.numpy()[0], want_bs)
    assert int(torch.argmin(final[0])) == want_slot
    np.testing.assert_array_equal(states.numpy()[0], want_path)


def test_beam_three_chain_batch_matches_jax():
    k, B = 3, 20
    dps = [random_dp_inputs(P=P, ploidy=k, num_clusters=7, seed=40 + P)
           for P in (9, 17, 24)]
    _assert_batch_equal(dp_torch._pack_group(dps, [0, 1, 2], 24), k, B)


def test_beam_chain_blocks_change_nothing(monkeypatch):
    """Chains split into blocks under the cell budget give the same
    outputs as one block."""
    k, B = 3, 12
    dps = [random_dp_inputs(P=20, ploidy=k, num_clusters=7, seed=60 + i)
           for i in range(3)]
    arrays = dp_torch._pack_group(dps, [0, 1, 2], 20)
    whole = _torch_beam(arrays, k, B)
    monkeypatch.setattr(dp_beam, "_BEAM_CELLS", B * num_states(2 * k, k))
    for a, b in zip(whole, _torch_beam(arrays, k, B)):
        assert torch.equal(a, b)


def test_thread_chains_batched_ploidy6_matches_jax():
    """A mixed batch with a ploidy-6 chain config (beam 256), and a
    tetraploid group whose beam (64 < S = 330) is active too: paths equal
    to ``dp_jax.thread_chains_batched``."""
    base = PhasingConfig(ploidy=2)
    cfg6 = dataclasses.replace(base, ploidy=6, dp_beam_width=256)
    cfg4 = dataclasses.replace(base, ploidy=4, dp_beam_width=64)
    dps = ([random_dp_inputs(P=P, ploidy=2, num_clusters=5, seed=P)
            for P in (5, 13)]
           + [random_dp_inputs(P=7, ploidy=6, num_clusters=13, seed=3)]
           + [random_dp_inputs(P=P, ploidy=4, num_clusters=9, seed=P)
              for P in (6, 11)])
    cfgs = [base, base, cfg6, cfg4, cfg4]
    want = dp_jax.thread_chains_batched(dps, base, chain_configs=cfgs)
    got = dp_torch.thread_chains_batched(dps, base, chain_configs=cfgs,
                                         device="cpu")
    assert got == want
    assert all(len(t) == 6 for t in got[2])
