"""The port's banded scoring (``score/banded.py``) on the CPU against the
JAX package's: edges (u, v) equal and in the same order, weights within
rtol = atol = 1e-5; and against the port's dense scoring on the band.
Also: ``phase_all_chains_batched`` loads the native helpers on the
calling thread before its worker pool starts."""

import threading

import numpy as np
import pytest
import torch

from ahsoka_tpu.config import PhasingConfig
from ahsoka_tpu.project.collapse import collapse_reads
from ahsoka_tpu.project.readset import build_chain_readsets
from ahsoka_tpu.score.banded import score_pairs_banded as jax_banded
from ahsoka_tpu.score.pairwise import readset_to_matrix
from ahsoka_tpu.utils.synth import SynthSpec, write_synthetic
from ahsoka_tpu_torch.score.banded import score_pairs_banded
from ahsoka_tpu_torch.score.device import score_pairs_device

from test_device_parity import _sim_chain_inputs
from test_torch_cuda import sorted_by_first, tetraploid_matrix

torch.set_num_threads(1)


def _test_banded_matrix():
    """The chain of tests/test_banded.py."""
    bubble_paths, alignments = _sim_chain_inputs(0.05, num_bubbles=8,
                                                 reads_per_hap=16)
    rs = build_chain_readsets(bubble_paths, alignments, PhasingConfig())
    return readset_to_matrix(rs.partial_filtered)


def _assert_same_edges(got, want):
    assert got[0].dtype == np.int64 and got[1].dtype == np.int64
    assert got[2].dtype == np.float64
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("collapsed", [False, True])
@pytest.mark.parametrize("block", [4, 16, 1024])
@pytest.mark.parametrize("mode", ["whatshap", "fresh"])
def test_banded_matches_jax(mode, block, collapsed):
    cfg = PhasingConfig(score_mode=mode)
    matrix, mult = _test_banded_matrix(), None
    if collapsed:
        cm = collapse_reads(matrix)
        matrix, mult = cm.matrix, cm.mult
        assert mult.max() > 1
    want = jax_banded(matrix, cfg, block=block, mult=mult)
    got = score_pairs_banded(matrix, cfg, block=block, mult=mult,
                             device="cpu")
    assert len(want[0]) > 0
    _assert_same_edges(got, want)


@pytest.mark.parametrize("mode", ["whatshap", "fresh"])
def test_banded_tetraploid_many_blocks_matches_jax(mode):
    """A 600-read tetraploid matrix over 120 positions (up to four
    alleles), rows sorted by first position: many block pairs and groups
    of several pairs."""
    cfg = PhasingConfig(ploidy=4, score_mode=mode)
    m = sorted_by_first(tetraploid_matrix(5, 600, 120))
    want = jax_banded(m, cfg, block=64)
    got = score_pairs_banded(m, cfg, block=64, device="cpu")
    assert len(want[0]) > 1000
    _assert_same_edges(got, want)


@pytest.mark.parametrize("block", [4, 16, 1024])
def test_banded_matches_dense_port(block):
    """Banded == the port's dense scoring on the band (the check of
    tests/test_banded.py, on the port's side)."""
    cfg = PhasingConfig()
    matrix = _test_banded_matrix()
    dense = score_pairs_device(matrix, cfg, device="cpu")
    iu = np.triu_indices(dense.shape[0], k=1)
    nz = dense[iu] != 0
    du, dv, dw = iu[0][nz], iu[1][nz], dense[iu][nz]
    bu, bv, bw = score_pairs_banded(matrix, cfg, block=block, device="cpu")
    order = np.lexsort((bv, bu))
    np.testing.assert_array_equal(bu[order], du)
    np.testing.assert_array_equal(bv[order], dv)
    np.testing.assert_allclose(bw[order], dw, rtol=1e-4, atol=1e-4)


def test_native_helpers_load_before_the_worker_pool(tmp_path, monkeypatch):
    """With threads=4 the first call of each native loader (cluster
    editing, coverage cap) runs on the calling thread before any worker
    exists, so a failed g++ build raises there."""
    from ahsoka_tpu_torch.cluster import _native_ce
    from ahsoka_tpu_torch.project import _native_covcap
    from ahsoka_tpu_torch.pipeline import run_phase

    gfa, gaf = str(tmp_path / "s.gfa"), str(tmp_path / "s.gaf")
    write_synthetic(gfa, gaf, SynthSpec(num_chains=6, bubbles_per_chain=24,
                                        reads_per_hap=60, span=3,
                                        error_rate=0.05, seed=2))
    calls = {"ce": [], "covcap": []}

    def recording(name, real):
        def load():
            workers = [t.name for t in threading.enumerate()
                       if t.name.startswith("ThreadPoolExecutor")]
            calls[name].append((threading.current_thread().name, workers))
            return real()
        return load

    monkeypatch.setattr(_native_ce, "_load",
                        recording("ce", _native_ce._load))
    monkeypatch.setattr(_native_covcap, "_load",
                        recording("covcap", _native_covcap._load))
    cfg = PhasingConfig(debug_readset_files=False, max_coverage=20,
                        threads=4)
    run_phase(gfa, gaf, str(tmp_path / "o"), cfg, device="cpu")
    main = threading.main_thread().name
    for name, seen in calls.items():
        assert seen[0] == (main, []), (name, seen[0])
        # the pool's workers did call the loader afterwards
        assert any(t != main for t, _ in seen[1:]), name


def test_banded_float32_noise_leaves_the_clusters():
    """The JAX package sums the banded ``pd_sum`` in float32, the port in
    float64 (exact).  On the 3,000-read chain where that shows
    (chip_smoke.banded_matrix(3000, 600, seed 9)), the JAX package keeps
    267 edges of |w| <= 1.53e-5 whose exact score is 0 and moves the
    rest by up to 9.2e-5; its banded branch (``_chain_cluster_dp_stage``
    above the banded threshold, the native sparse solver) still gives
    the port's clusters and DP inputs."""
    import dataclasses

    import chip_smoke
    from ahsoka_tpu import phase as jphase
    from ahsoka_tpu.score.pairwise import AlleleMatrix
    from ahsoka_tpu_torch import phase as tphase
    from ahsoka_tpu_torch.config import PhasingConfig as TConfig

    pm = chip_smoke.banded_matrix(3000, 600, seed=9)
    jm = AlleleMatrix(alleles=pm.alleles, positions=pm.positions,
                      read_names=pm.read_names)
    want = jax_banded(jm, PhasingConfig())
    got = score_pairs_banded(pm, TConfig(), device="cpu")
    jax_edges = dict(zip(zip(want[0].tolist(), want[1].tolist()),
                         want[2].tolist()))
    port_edges = dict(zip(zip(got[0].tolist(), got[1].tolist()),
                          got[2].tolist()))
    extra = set(jax_edges) - set(port_edges)
    assert set(port_edges) <= set(jax_edges)
    assert len(extra) == 267
    assert max(abs(jax_edges[e]) for e in extra) <= 1.6e-5
    assert max(abs(jax_edges[e] - w) for e, w in port_edges.items()) < 1e-4

    jres = jphase.ChainPhasingResult(chain_id=0, num_bubbles=600, skipped=True)
    tres = tphase.ChainPhasingResult(chain_id=0, num_bubbles=600, skipped=True)
    jdp = jphase._chain_cluster_dp_stage(
        jm, dataclasses.replace(PhasingConfig(),
                                banded_scoring_threshold=1000), jres)
    tdp = tphase._chain_cluster_dp_stage(
        pm, dataclasses.replace(TConfig(), banded_scoring_threshold=1000),
        tres, device="cpu")
    assert "scoring" in jres.stage_seconds and "scoring" in tres.stage_seconds
    assert jres.num_clusters == tres.num_clusters == 15
    for field in ("positions", "candidates", "num_candidates", "coverage",
                  "consensus", "genotypes"):
        np.testing.assert_array_equal(getattr(tdp, field),
                                      getattr(jdp, field), err_msg=field)
