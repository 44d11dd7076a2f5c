"""The port's dense pair scoring (torch) against the JAX package's:
scores within rtol = atol = 1e-4 (the tolerance of the JAX device tests
against the host oracle, tests/test_device_parity.py; float32 matmuls and
logs summed in another order), and identical cluster-editing results on
the default scoring mode.  Ploidy 2 scores diploid simulated chains;
ploidy 4 scores seeded tetraploid matrices with up to four alleles per
position, where the WhatsHap mode's greedy slot allocation runs four
rounds."""

import dataclasses

import numpy as np
import pytest
import torch

from ahsoka_tpu.cluster.editing import cluster_editing
from ahsoka_tpu.config import PhasingConfig
from ahsoka_tpu.project.collapse import collapse_reads
from ahsoka_tpu.project.readset import build_chain_readsets
from ahsoka_tpu.score import device as jscore
from ahsoka_tpu.score.pairwise import readset_to_matrix, score_pairs
from ahsoka_tpu_torch.score import device as tscore

from test_device_parity import _sim_chain_inputs
from test_torch_cuda import tetraploid_matrix

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)


def _matrices():
    out = []
    for er, nb, rph in [(0.05, 6, 10), (0.0, 8, 12), (0.1, 30, 40),
                        (0.05, 30, 40)]:
        bp, al = _sim_chain_inputs(er, nb, rph)
        rs = build_chain_readsets(bp, al, PhasingConfig())
        out.append(readset_to_matrix(rs.partial_filtered))
    return out


MATS = None


def _mats(ploidy=2):
    global MATS
    if ploidy == 4:
        return [tetraploid_matrix(seed, 40 * (seed + 1), 12 * (seed + 1))
                for seed in range(3)]
    if MATS is None:
        MATS = _matrices()
    return MATS


@pytest.mark.parametrize("ploidy", [2, 4])
@pytest.mark.parametrize("mode", ["whatshap", "fresh"])
@pytest.mark.parametrize("weighted", [False, True])
def test_score_pairs_device_many_matches_jax(mode, weighted, ploidy):
    cfg = dataclasses.replace(PhasingConfig(), score_mode=mode,
                              ploidy=ploidy)
    mats = _mats(ploidy)
    mults = None
    if weighted:
        cms = [collapse_reads(m) for m in mats]
        mats, mults = [c.matrix for c in cms], [c.mult for c in cms]
    got = tscore.score_pairs_device_many(mats, cfg, mults=mults,
                                         device="cpu")
    want = jscore.score_pairs_device_many(mats, cfg, mults=mults)
    for g, w, m in zip(got, want, mats):
        assert g.dtype == np.float64
        assert g.shape == (m.num_reads, m.num_reads)
        np.testing.assert_allclose(g, w, **TOL)


def test_score_pairs_device_matches_jax_and_oracle():
    cfg = PhasingConfig()
    for m in _mats()[:2]:
        got = tscore.score_pairs_device(m, cfg, device="cpu")
        np.testing.assert_allclose(got, jscore.score_pairs_device(m, cfg),
                                   **TOL)
        np.testing.assert_allclose(got, score_pairs(m, cfg), **TOL)


@pytest.mark.parametrize("ploidy", [2, 4])
@pytest.mark.parametrize("weighted", [False, True])
def test_cluster_editing_identical(weighted, ploidy):
    cfg = PhasingConfig(ploidy=ploidy)
    mats = _mats(ploidy)
    mults = None
    if weighted:
        cms = [collapse_reads(m) for m in mats]
        mats, mults = [c.matrix for c in cms], [c.mult for c in cms]
    got = tscore.score_pairs_device_many(mats, cfg, mults=mults,
                                         device="cpu")
    want = jscore.score_pairs_device_many(mats, cfg, mults=mults)
    for g, w in zip(got, want):
        assert cluster_editing(g, mode=cfg.ce_mode) == \
            cluster_editing(w, mode=cfg.ce_mode)


def test_sharded_scoring_raises():
    """Row-sharded scoring is ported: data_shards=2 no longer raises.  On
    one CPU device the gate falls back; over two it scores row blocks;
    both equal the unsharded scores exactly."""
    mats = _mats()[:2]
    want = tscore.score_pairs_device_many(mats, PhasingConfig(),
                                          device="cpu")
    cfg = dataclasses.replace(PhasingConfig(), data_shards=2)
    for devices in (None, ["cpu", "cpu"]):
        got = tscore.score_pairs_device_many(mats, cfg, device="cpu",
                                             devices=devices)
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
