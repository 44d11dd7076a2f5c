"""p_s estimated on the device from the scoring's own pair overlap and
agreement counts (``score.device._device_p_s``) against the host
estimators it replaces on the dense path (``whatshap.estimate_p_s``,
``estimate_p_s_weighted``), to 1e-12 relative: unweighted and collapsed
matrices, tied rates, no valid pair, ``min_overlap`` at the edge, and
chains of several sizes in one padded batch, with row blocks that cross
chains.  The paths that keep the host estimate count
``scoring.p_s_host``; the dense batched path counts
``scoring.p_s_device`` once a chain."""

import dataclasses

import numpy as np
import pytest

from ahsoka_tpu.config import PhasingConfig as JaxConfig
from ahsoka_tpu.score import device as jscore
from ahsoka_tpu_torch.config import PhasingConfig
from ahsoka_tpu_torch.project.collapse import collapse_reads
from ahsoka_tpu_torch.score import device as tscore
from ahsoka_tpu_torch.score import whatshap
from ahsoka_tpu_torch.score.banded import score_pairs_banded
from ahsoka_tpu_torch.score.pairwise import AlleleMatrix
from ahsoka_tpu_torch.utils import substage

from test_torch_cuda import sorted_by_first, tetraploid_matrix

TOL = dict(rtol=1e-4, atol=1e-4)


def _window_matrix(seed, R, P, width, haps=2, error_rate=0.0):
    """Reads of fixed ``width`` from ``haps`` biallelic haplotypes: few
    distinct rates, so the lowest-1/ploidy cut falls inside a tie."""
    rng = np.random.default_rng(seed)
    hap = rng.integers(0, 2, size=(haps, P))
    alleles = np.full((R, P), -1, dtype=np.int16)
    for r in range(R):
        start = int(rng.integers(0, P - width + 1))
        row = hap[r % haps, start:start + width].copy()
        flip = rng.random(width) < error_rate
        row[flip] = 1 - row[flip]
        alleles[r, start:start + width] = row
    return AlleleMatrix(alleles=alleles, positions=np.arange(P, dtype=np.int32),
                        read_names=[f"r{r}" for r in range(R)])


def _case(name):
    """(matrix, config) of one estimator case."""
    if name == "random":
        return tetraploid_matrix(1, 100, 24), PhasingConfig(ploidy=4)
    if name == "tied":
        return (_window_matrix(2, 90, 20, 4, error_rate=0.1),
                PhasingConfig(ploidy=2))
    if name == "no_valid_pair":
        return _window_matrix(3, 40, 30, 1), PhasingConfig(ploidy=2)
    # every read covers 4-8 positions: pairs at o = 4 enter, o = 3 not
    return tetraploid_matrix(4, 80, 16), PhasingConfig(ploidy=4,
                                                       min_overlap=4)


def _host(matrix, mult, cfg):
    if mult is None:
        return whatshap.estimate_p_s(matrix, cfg)
    return whatshap.estimate_p_s_weighted(matrix, mult, cfg)


def _recorded(monkeypatch):
    """Wrap ``_device_p_s``: each call's estimates, in call order."""
    calls = []
    inner = tscore._device_p_s

    def spy(*args, **kwargs):
        out = inner(*args, **kwargs)
        calls.append(out.numpy().copy())
        return out
    monkeypatch.setattr(tscore, "_device_p_s", spy)
    return calls


def _rel(a, b):
    return abs(a - b) / abs(b)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", ["random", "tied", "no_valid_pair",
                                  "min_overlap_edge"])
def test_device_p_s_equals_host(name, weighted, monkeypatch):
    matrix, cfg = _case(name)
    mult = None
    if weighted:
        cm = collapse_reads(matrix)
        assert cm.num_groups < matrix.num_reads or name == "no_valid_pair"
        matrix, mult = cm.matrix, cm.mult
    calls = _recorded(monkeypatch)
    tscore.score_pairs_device_many([matrix], cfg,
                                   mults=None if mult is None else [mult],
                                   device="cpu")
    assert len(calls) == 1 and calls[0].shape == (1,)
    want = _host(matrix, mult, cfg)
    assert _rel(calls[0][0], want) <= 1e-12
    if name == "no_valid_pair":
        eps = cfg.error_rate
        assert want == float(np.clip(2 * eps * (1 - eps), whatshap._P_S_MIN,
                                     whatshap._P_S_MAX))
    if name == "tied":
        # the cut at ceil(N / ploidy) falls inside a run of equal rates
        ov, ag = (matrix.alleles >= 0).astype(float), 0
        o = ov @ ov.T
        for a in range(2):
            oh = (matrix.alleles == a).astype(float)
            ag = ag + oh @ oh.T
        iu = np.triu_indices(matrix.num_reads, k=1)
        valid = o[iu] >= 2
        rates = np.sort((o[iu] - ag[iu])[valid] / o[iu][valid])
        m = -(-len(rates) // 2)
        assert rates[m - 1] == rates[m]
    if name == "min_overlap_edge":
        above = _host(matrix, mult, dataclasses.replace(cfg, min_overlap=5))
        assert above != want


@pytest.mark.parametrize("block", [None, 97])
@pytest.mark.parametrize("weighted", [False, True])
def test_device_p_s_padded_batch(weighted, block, monkeypatch):
    """Chains of 30-64 rows and 12-40 positions in one [C, 64, 128]
    batch (one without a valid pair); a block of 97 pairs' rows crosses
    chain boundaries."""
    cfg = PhasingConfig(ploidy=4)
    mats = [tetraploid_matrix(10 + s, r, p) for s, (r, p) in
            enumerate([(30, 12), (64, 40), (47, 25)])]
    mats.append(_window_matrix(20, 50, 40, 1))
    # one allele count, so the four chains score in one group
    mats = [AlleleMatrix(alleles=np.where(m.alleles >= 0, m.alleles % 2, -1)
                         .astype(np.int16), positions=m.positions,
                         read_names=m.read_names) for m in mats]
    mults = None
    if weighted:
        cms = [collapse_reads(m) for m in mats]
        mats, mults = [c.matrix for c in cms], [c.mult for c in cms]
    if block is not None:
        monkeypatch.setattr(tscore, "_P_S_BLOCK_PAIRS", block)
    calls = _recorded(monkeypatch)
    tscore.score_pairs_device_many(mats, cfg, mults=mults, device="cpu")
    assert len(calls) == 1 and calls[0].shape == (len(mats),)
    for j, m in enumerate(mats):
        want = _host(m, None if mults is None else mults[j], cfg)
        assert _rel(calls[0][j], want) <= 1e-12


@pytest.mark.parametrize("weighted", [False, True])
def test_score_pairs_device_many_counts_device_p_s(weighted):
    cfg = PhasingConfig(ploidy=4)
    mats = [tetraploid_matrix(s, 40 * (s + 1), 12 * (s + 1))
            for s in range(3)]
    mults = None
    if weighted:
        cms = [collapse_reads(m) for m in mats]
        mats, mults = [c.matrix for c in cms], [c.mult for c in cms]
    with substage.job():
        got = tscore.score_pairs_device_many(mats, cfg, mults=mults,
                                             device="cpu")
        counters = substage.snapshot()["counters"]
    want = jscore.score_pairs_device_many(
        mats, dataclasses.replace(JaxConfig(), ploidy=4), mults=mults)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    assert counters["scoring.p_s_device"] == len(mats)
    assert "scoring.p_s_host" not in counters


@pytest.mark.parametrize("path", ["row_sharded", "fresh", "explicit_eps",
                                  "configured_eps", "banded"])
def test_host_p_s_paths_count(path):
    """The row-sharded, fresh-mode, explicit- and configured-eps and
    banded paths estimate on the host; the scores are the unchanged
    paths' (the sharded ones equal the unsharded device estimate's)."""
    m = tetraploid_matrix(5, 64, 20)
    cfg = PhasingConfig(ploidy=4)
    want = tscore.score_pairs_device(m, cfg, device="cpu")
    with substage.job():
        if path == "row_sharded":
            got = tscore.score_pairs_device(
                m, dataclasses.replace(cfg, data_shards=2), device="cpu",
                devices=["cpu", "cpu"])
        elif path == "banded":
            score_pairs_banded(sorted_by_first(m), cfg, device="cpu")
        elif path == "fresh":
            tscore.score_pairs_device_many(
                [m, m], dataclasses.replace(cfg, score_mode="fresh"),
                device="cpu")
        elif path == "explicit_eps":
            tscore.score_pairs_device(m, cfg, error_rate=0.05, device="cpu")
        else:
            tscore.score_pairs_device_many(
                [m], dataclasses.replace(cfg, estimate_error_rate=False),
                device="cpu")
        counters = substage.snapshot()["counters"]
    assert counters["scoring.p_s_host"] == (2 if path == "fresh" else 1)
    assert "scoring.p_s_device" not in counters
    if path == "row_sharded":
        assert np.array_equal(got, want)
