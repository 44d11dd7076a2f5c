"""The plain beam DP (``phasebench/reference/dp_beam.py``) against the
port's beam (``ahsoka_tpu_torch.thread.dp_beam.thread_beam``) and, with
a beam as wide as the state space, against the exact DP
(``R.best_path``); the band's plain scores against the dense ones."""

import numpy as np
import pytest
import torch

from phasebench.reference import banded
from phasebench.reference import phase as R
from phasebench.reference.config import PhasingConfig
from phasebench.reference.dp_beam import best_beam_path, path_cost
from phasebench.reference.pairwise import AlleleMatrix
from phasebench.reference.postprocess import DPInputs
from phasebench.reference.states import max_states


def random_dp(seed: int, ploidy: int, positions: int, num_alleles: int = 3
              ) -> DPInputs:
    """DP inputs of one chain: between k and 2k candidates a position,
    drawn from a pool of cluster ids so that consecutive positions share
    some, continuous coverage (few exact ties) and small genotypes."""
    rng = np.random.default_rng(seed)
    M = 2 * ploidy
    cand = np.full((positions, M), -1, dtype=np.int32)
    num = rng.integers(ploidy, M + 1, positions).astype(np.int32)
    cov = np.zeros((positions, M), dtype=np.float32)
    cons = np.zeros((positions, M), dtype=np.int32)
    for j in range(positions):
        m = int(num[j])
        cand[j, :m] = np.sort(rng.choice(M + 3, m, replace=False))
        c = rng.random(m)
        cov[j, :m] = (c / c.sum()).astype(np.float32)
        cons[j, :m] = rng.integers(0, num_alleles, m)
    geno = rng.integers(0, ploidy + 1, (positions, num_alleles)).astype(
        np.int32)
    return DPInputs(positions=np.arange(positions, dtype=np.int32),
                    candidates=cand, num_candidates=num, coverage=cov,
                    consensus=cons, genotypes=geno)


def port_states(dp: DPInputs, config: PhasingConfig, width: int):
    from ahsoka_tpu_torch.thread.dp_beam import thread_beam
    from ahsoka_tpu_torch.thread.dp_torch import _pack_group
    ca, nc, co, cs, ge = (torch.as_tensor(x) for x in
                          _pack_group([dp], [0], dp.num_positions))
    states = thread_beam(
        ca, nc, co, cs, ge, ploidy=config.ploidy,
        num_alleles=dp.genotypes.shape[1], beam_width=width,
        switch_cost=float(config.switch_cost),
        affine_cost=float(config.affine_switch_cost),
        cov_w=float(config.coverage_cost_weight),
        geno_w=float(config.genotype_cost_weight
                     if config.use_genotypes else 0.0))
    return [int(s) for s in states[0]]


@pytest.mark.parametrize("ploidy,width,positions,seed", [
    (3, 16, 40, 1), (3, 16, 40, 2), (3, 16, 40, 3), (6, 256, 6, 4)])
def test_the_port_beam_takes_the_plain_beam_path(ploidy, width, positions,
                                                 seed):
    """Equal states, except where the two paths cost the same; costs
    within float32 rounding (the port sums its costs in float32)."""
    torch.set_num_threads(1)
    assert width < max_states(ploidy)
    config = PhasingConfig(ploidy=ploidy, dp_beam_width=width)
    dp = random_dp(seed, ploidy, positions)
    plain, least = best_beam_path(dp, config, width)
    port = port_states(dp, config, width)
    assert path_cost(dp, plain, config) == pytest.approx(least, rel=1e-12)
    port_cost = path_cost(dp, port, config)
    assert port_cost == pytest.approx(least, rel=1e-5, abs=1e-5)
    if port != plain:
        assert port_cost == pytest.approx(least, rel=1e-6, abs=1e-6)


@pytest.mark.parametrize("ploidy,seed", [(2, 5), (3, 6), (4, 7)])
def test_a_beam_as_wide_as_the_states_is_the_exact_dp(ploidy, seed):
    config = PhasingConfig(ploidy=ploidy)
    dp = random_dp(seed, ploidy, 30)
    path, cost = R.best_path(dp, config, R.dp_costs(dp, config))
    for width in (max_states(ploidy), max_states(ploidy) + 7):
        states, least = best_beam_path(dp, config, width)
        assert R.states_path(dp, states, ploidy) == path
        assert least == pytest.approx(cost, rel=1e-12)


def test_a_narrow_beam_can_miss_the_least_cost_but_never_beats_it():
    config = PhasingConfig(ploidy=3)
    costs = []
    for seed in range(8):
        dp = random_dp(100 + seed, 3, 40)
        exact = R.best_path(dp, config, R.dp_costs(dp, config))[1]
        narrow = best_beam_path(dp, config, 2)[1]
        assert narrow >= exact - 1e-9
        costs.append(narrow - exact)
    assert max(costs) > 0


def test_the_band_is_the_dense_scores_nonzero_pairs(monkeypatch):
    """Below 2,048 rows the band's p_s sample is every row, so the band
    is the upper triangle's nonzero dense float64 scores, in (u, v)
    order, whatever the row block."""
    rng = np.random.default_rng(3)
    alleles = rng.integers(-1, 2, (60, 25)).astype(np.int16)
    # each read covers a window of 8 positions, the reads by first one
    starts = np.sort(rng.integers(0, 18, 60))
    cols = np.arange(25)
    alleles[(cols < starts[:, None]) | (cols >= starts[:, None] + 8)] = -1
    m = AlleleMatrix(alleles=alleles, positions=np.arange(25, dtype=np.int32),
                     read_names=[f"r{i}" for i in range(60)])
    config = PhasingConfig(ploidy=4)
    dense = R.chain_scores(m, None, config)
    u, v = np.triu_indices(60, k=1)
    keep = dense[u, v] != 0
    assert 0 < keep.sum() < len(u)
    for block in (1024, 7):
        monkeypatch.setattr(banded, "_BLOCK", block)
        gu, gv, gw = banded.band_edges(m, config)
        np.testing.assert_array_equal(gu, u[keep])
        np.testing.assert_array_equal(gv, v[keep])
        np.testing.assert_allclose(gw, dense[u, v][keep], rtol=1e-12,
                                   atol=1e-12)
    tu, tv, tw = banded.band_edges(m, config, gemm="tf32")
    np.testing.assert_array_equal(tu, u[keep])
    assert np.abs(tw - dense[u, v][keep]).max() > 1e-5
