"""Diploid DP forward + backtrace of the port against the JAX package.

The same seeded numpy inputs go through ``dp_jax._dp_forward_batched`` /
``_backtrace_batched`` (the XLA scan), the Pallas diploid kernels in
interpret mode, and the port's ``minplus_forward_diploid`` /
``backtrace_diploid`` (their plain PyTorch versions on the CPU; the CUDA
kernels against those on a card: tests/test_torch_cuda.py).  States and backpointers must be exactly equal.
Final costs must be equal to within one float32 ulp: both sides add the
same exact small-integer transition costs in the same order, so they
agree bit for bit unless a backend reassociates an add."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ahsoka_tpu.config import PhasingConfig
from ahsoka_tpu.thread import dp_jax
from ahsoka_tpu.thread.states import full_state_counts, full_state_validity
from ahsoka_tpu_torch.ops import minplus_diploid as md
from ahsoka_tpu_torch.state import to_torch
from ahsoka_tpu_torch.thread.dp_torch import node_costs_all

from test_dp import random_dp_inputs

torch.set_num_threads(1)

CFG = PhasingConfig(ploidy=2)
KW = dict(switch_cost=CFG.switch_cost, affine_cost=CFG.affine_switch_cost)


def _batch(C, P, seed, ties=False):
    dps = [random_dp_inputs(P=P, ploidy=2, num_clusters=5,
                            seed=seed * 100 + i) for i in range(C)]
    ca = np.stack([d.candidates for d in dps])
    nc = np.stack([d.num_candidates for d in dps])
    co = np.stack([d.coverage for d in dps]).astype(np.float32)
    cs = np.stack([d.consensus for d in dps])
    ge = np.stack([d.genotypes for d in dps]).astype(np.float32)
    if ties:
        # identical candidates everywhere and zero node-cost weights:
        # every valid state costs the same at every position
        ca[:] = -1
        ca[:, :, :2] = [0, 1]
        nc[:] = 2
    return ca, nc, co, cs, ge


def _jax_states(arrays, cov_w, geno_w):
    args = [jnp.asarray(a) for a in arrays]
    fs, bp = dp_jax._dp_forward_batched(
        *args, jnp.asarray(full_state_counts(2)),
        jnp.asarray(full_state_validity(2)), jnp.float32(CFG.switch_cost),
        jnp.float32(CFG.affine_switch_cost), jnp.float32(cov_w),
        jnp.float32(geno_w), ploidy=2, num_alleles=arrays[4].shape[2])
    s0, tail = dp_jax._backtrace_batched(fs, bp)
    states = np.concatenate([np.asarray(s0)[:, None], np.asarray(tail)],
                            axis=1)
    return np.asarray(fs), np.asarray(bp), states


def _port(arrays, cov_w, geno_w):
    ca, nc, co, cs, ge = to_torch(*arrays, device="cpu")
    node = node_costs_all(ca, nc, co, cs, ge, full_state_counts(2),
                          full_state_validity(2), ploidy=2,
                          num_alleles=arrays[4].shape[2], cov_w=cov_w,
                          geno_w=geno_w)
    fin, bp = md.minplus_forward_diploid(ca, node, **KW)
    fs = torch.argmin(fin, dim=1).to(torch.int32)
    states = md.backtrace_diploid(bp, fs)
    return fin, bp, fs, states


@pytest.mark.parametrize("C,P", [(1, 1), (1, 8), (3, 13), (7, 24),
                                 (16, 41), (2, 130)])
def test_plain_diploid_matches_xla_scan(C, P):
    arrays = _batch(C, P, seed=C * 31 + P)
    fs_j, bp_j, st_j = _jax_states(arrays, 1.0, 1.0)
    fin, bp, fs, st = _port(arrays, 1.0, 1.0)
    assert bp.shape == (C, P, 10)
    assert not bp[:, 0].any()
    np.testing.assert_array_equal(bp[:, 1:].numpy(), bp_j)
    np.testing.assert_array_equal(fs.numpy(), fs_j)
    np.testing.assert_array_equal(st.numpy(), st_j)


@pytest.mark.parametrize("C,P", [(1, 5), (4, 19)])
def test_plain_diploid_all_equal_costs(C, P):
    """All valid states tie at every position: the first minimum wins on
    both sides (strict < / argmin)."""
    arrays = _batch(C, P, seed=7, ties=True)
    fs_j, bp_j, st_j = _jax_states(arrays, 0.0, 0.0)
    fin, bp, fs, st = _port(arrays, 0.0, 0.0)
    valid = fin[fin < 1e29]
    assert (valid == valid[0]).all()
    np.testing.assert_array_equal(bp[:, 1:].numpy(), bp_j)
    np.testing.assert_array_equal(fs.numpy(), fs_j)
    np.testing.assert_array_equal(st.numpy(), st_j)


def test_plain_diploid_matches_pallas_interpret():
    """Final costs and states against the TPU kernels
    (thread_batch_pallas_diploid, Pallas interpret mode on the CPU)."""
    from jax.experimental.pallas import tpu as pltpu
    from ahsoka_tpu.thread.dp_pallas import thread_batch_pallas_diploid

    arrays = _batch(3, 24, seed=11)
    with pltpu.force_tpu_interpret_mode():
        st_p, fin_p = thread_batch_pallas_diploid(
            *arrays, full_state_counts(2), full_state_validity(2),
            ploidy=2, num_alleles=2, pad_to=1024, **KW)
    fin, _bp, _fs, st = _port(arrays, 1.0, 1.0)
    np.testing.assert_array_equal(st.numpy(), np.asarray(st_p))
    np.testing.assert_array_max_ulp(fin.numpy(), np.asarray(fin_p),
                                    maxulp=1)
