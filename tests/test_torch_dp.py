"""The port's batched threading DP (plain path on the CPU) against the
JAX package's, on identical seeded inputs: paths exactly equal, node
costs within rtol 1e-6 (float32; they agree bit for bit in practice)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ahsoka_tpu.config import PhasingConfig
from ahsoka_tpu.thread import dp_jax
from ahsoka_tpu.thread.states import full_state_counts, full_state_validity
from ahsoka_tpu_torch.state import to_torch
from ahsoka_tpu_torch.thread import dp_torch

from test_dp import random_dp_inputs

torch.set_num_threads(1)


def _mixed_dps(ploidy, seed=0):
    return [random_dp_inputs(P=P, ploidy=ploidy, num_clusters=2 * ploidy
                             + 1, seed=seed * 50 + i)
            for i, P in enumerate([5, 12, 13, 30, 7, 64, 1, 9, 140])]


@pytest.mark.parametrize("ploidy", [1, 2, 3, 4, 5])
def test_thread_chains_batched_matches_jax(ploidy):
    cfg = PhasingConfig(ploidy=ploidy)
    dps = _mixed_dps(ploidy, seed=ploidy)
    if ploidy >= 4:
        # keep the CPU scans small: 330 and 2002 states
        dps = dps[:5] if ploidy == 4 else dps[:2]
    want = dp_jax.thread_chains_batched(dps, cfg)
    got = dp_torch.thread_chains_batched(dps, cfg, device="cpu")
    assert got == want


def test_mixed_ploidy_groups_match_jax():
    base = PhasingConfig(ploidy=2)
    dps = _mixed_dps(2, seed=3)[:4] + _mixed_dps(3, seed=4)[:3]
    cfgs = [base] * 4 + [dataclasses.replace(base, ploidy=3)] * 3
    want = dp_jax.thread_chains_batched(dps, base, chain_configs=cfgs)
    got = dp_torch.thread_chains_batched(dps, base, chain_configs=cfgs,
                                         device="cpu")
    assert got == want


@pytest.mark.parametrize("seed", range(3))
def test_thread_chain_device_matches_jax(seed):
    cfg = PhasingConfig(ploidy=2)
    dp = random_dp_inputs(P=17, ploidy=2, num_clusters=6, seed=seed)
    assert dp_torch.thread_chain_device(dp, cfg, device="cpu") == \
        dp_jax.thread_chain_device(dp, cfg)


@pytest.mark.parametrize("ploidy", [2, 3, 4])
def test_node_costs_all_matches_jax(ploidy):
    """Bit-equal to ``dp_jax.node_costs_all`` jitted with the state
    tables and weights as arguments, as the JAX package's DP programs run
    it (XLA fuses coverage - count / k into one multiply-add)."""
    dps = [random_dp_inputs(P=16, ploidy=ploidy, num_clusters=7, seed=i)
           for i in range(4)]
    arrays = dp_torch._pack_group(dps, list(range(4)), 16)
    counts, valid = full_state_counts(ploidy), full_state_validity(ploidy)

    @jax.jit
    def fn(ca, nc, co, cs, ge, counts_t, valid_t, cov_w, geno_w):
        return jax.vmap(lambda *a: dp_jax.node_costs_all(
            *a, counts_t, valid_t, ploidy, 2, cov_w, geno_w)[0])(
                ca, nc, co, cs, ge)

    for cov_w, geno_w in [(1.0, 1.0), (0.7, 0.0)]:
        got = dp_torch.node_costs_all(
            *to_torch(*arrays, device="cpu"), counts, valid, ploidy=ploidy,
            num_alleles=2, cov_w=cov_w, geno_w=geno_w).numpy()
        want = np.asarray(fn(*[jnp.asarray(a) for a in arrays],
                             jnp.asarray(counts), jnp.asarray(valid),
                             jnp.float32(cov_w), jnp.float32(geno_w)))
        np.testing.assert_array_equal(got, want)


def test_bucket_positions_match_jax():
    for P in list(range(1, 300)) + [1000, 1024, 1025, 5000, 10000]:
        assert dp_torch._bucket_positions(P) == dp_jax._bucket_positions(P)


def test_plain_forward_matches_pallas_streamed_ploidy4():
    """Tetraploid threading on the CPU (the general kernel's plain
    versions, the oracle the CUDA kernel is held to) against the
    streamed Pallas kernel in interpret mode."""
    from jax.experimental.pallas import tpu as pltpu
    from ahsoka_tpu.thread.dp_pallas import (pad_chain_batch,
                                             thread_batch_pallas_streamed)

    cfg = PhasingConfig(ploidy=4)
    dps = [random_dp_inputs(P=10, ploidy=4, num_clusters=9, seed=i)
           for i in range(2)]
    arrays = dp_torch._pack_group(dps, [0, 1], 16)
    padded = pad_chain_batch(*arrays)[:5]
    with pltpu.force_tpu_interpret_mode():
        st_p, _ = thread_batch_pallas_streamed(
            *padded, full_state_counts(4), full_state_validity(4),
            ploidy=4, num_alleles=2, switch_cost=cfg.switch_cost,
            affine_cost=cfg.affine_switch_cost)
    st = dp_torch.thread_states(*to_torch(*arrays, device="cpu"), cfg,
                                ploidy=4, num_alleles=2)
    np.testing.assert_array_equal(st.numpy(), np.asarray(st_p)[:2])
