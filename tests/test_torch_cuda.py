"""The port on an NVIDIA card against its plain PyTorch path on the CPU.

Every test here needs a card (marker ``gpu``) and skips without one.  The
file imports no jax, so on a machine with a card and no jax it runs as

    python -m pytest --noconftest -q tests/test_torch_cuda.py

The DP kernels must equal their plain versions exactly (through the
diploid and the general-ploidy wrappers, at the edges of the k <= 2
forward's staged tile, on all-ties batches, and the backtrace over
several tiles at every ploidy), and so must the beam DP; projection key tables exactly; dense scores within rtol = atol
= 1e-4 (float32 matmuls summed in another order on the card), and
row-sharded ones exactly equal to the unsharded ones on the card; banded
edges equal and in order, weights within rtol = atol = 1e-5; results
byte-equal to the goldens."""

import os
import shutil

import numpy as np
import pytest
import torch

from ahsoka_tpu.cluster.editing import cluster_editing
from ahsoka_tpu.config import PhasingConfig
from ahsoka_tpu.project.readset import build_chain_readsets
from ahsoka_tpu.score.pairwise import AlleleMatrix, readset_to_matrix
from ahsoka_tpu.thread.states import full_state_counts, full_state_validity
from ahsoka_tpu_torch.ops import minplus_diploid as md
from ahsoka_tpu_torch.ops import minplus_stream as ms
from ahsoka_tpu_torch.state import to_torch
from ahsoka_tpu_torch.thread import dp_torch

from test_device_parity import _sim_chain_inputs
from test_dp import random_dp_inputs

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu

DATA = os.path.join(os.path.dirname(__file__), "data")
CFG = PhasingConfig()
KW = dict(switch_cost=CFG.switch_cost, affine_cost=CFG.affine_switch_cost)


def tetraploid_matrix(seed, R, P, error_rate=0.05):
    """Seeded [R, P] allele matrix of reads drawn from four haplotypes
    over bi- to tetra-allelic positions (reads cover windows of 4-8
    positions; alleles flip at ``error_rate``)."""
    rng = np.random.default_rng(seed)
    n_alleles = rng.integers(2, 5, size=P)
    haps = rng.integers(0, n_alleles, size=(4, P))
    alleles = np.full((R, P), -1, dtype=np.int16)
    for r in range(R):
        span = int(rng.integers(4, 9))
        start = int(rng.integers(0, max(1, P - span + 1)))
        cols = np.arange(start, min(P, start + span))
        row = haps[r % 4, cols].copy()
        flip = rng.random(len(cols)) < error_rate
        row[flip] = (row[flip] + 1) % n_alleles[cols][flip]
        alleles[r, cols] = row
    return AlleleMatrix(alleles=alleles,
                        positions=np.arange(P, dtype=np.int32),
                        read_names=[f"read{r}" for r in range(R)])


def sorted_by_first(matrix):
    """Rows reordered by first covered position (banded scoring's input
    order)."""
    P = matrix.alleles.shape[1]
    first = np.where(matrix.alleles >= 0, np.arange(P), P).min(axis=1)
    order = np.argsort(first, kind="stable")
    return AlleleMatrix(alleles=matrix.alleles[order],
                        positions=matrix.positions,
                        read_names=[matrix.read_names[i] for i in order])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "mode")
    from ahsoka_tpu_torch.device import resolve_device
    return resolve_device("cuda")


def _batch(C, P, seed):
    dps = [random_dp_inputs(P=P, ploidy=2, num_clusters=5,
                            seed=seed * 100 + i) for i in range(C)]
    return dp_torch._pack_group(dps, list(range(C)), P)


def _forward(arrays, device):
    ca, nc, co, cs, ge = to_torch(*arrays, device=device)
    node = dp_torch.node_costs_all(ca, nc, co, cs, ge, full_state_counts(2),
                                   full_state_validity(2), ploidy=2,
                                   num_alleles=2, cov_w=1.0, geno_w=1.0)
    fin, bp = md.minplus_forward_diploid(ca, node, **KW)
    fs = torch.argmin(fin, dim=1).to(torch.int32)
    return fin, bp, md.backtrace_diploid(bp, fs)


@pytest.mark.parametrize("C,P", [(1, 1), (37, 56), (1000, 56), (2, 1500)])
def test_cuda_kernels_match_plain(cuda_device, C, P):
    arrays = _batch(C, P, seed=C + P)
    before = (md.minplus_forward_diploid.launches,
              md.backtrace_diploid.launches)
    fin, bp, st = _forward(arrays, cuda_device)
    torch.cuda.synchronize()
    assert (md.minplus_forward_diploid.launches,
            md.backtrace_diploid.launches) == (before[0] + 1, before[1] + 1)
    fin_r, bp_r, st_r = _forward(arrays, "cpu")
    assert torch.equal(fin.cpu(), fin_r)
    assert torch.equal(bp.cpu(), bp_r)
    assert torch.equal(st.cpu(), st_r)


def _general(arrays, k, device):
    ca, nc, co, cs, ge = to_torch(*arrays, device=device)
    node = dp_torch.node_costs_all(ca, nc, co, cs, ge, full_state_counts(k),
                                   full_state_validity(k), ploidy=k,
                                   num_alleles=ge.shape[2], cov_w=1.0,
                                   geno_w=1.0)
    fin, bp = ms.minplus_forward_streamed(ca, node, full_state_counts(k),
                                          ploidy=k, **KW)
    fs = torch.argmin(fin, dim=1).to(torch.int32)
    return fin, bp, ms.backtrace_streamed(bp, fs)


@pytest.mark.parametrize("k,C,P", [(1, 50, 40), (2, 37, 56), (3, 9, 33),
                                   (4, 3, 20), (5, 2, 6)])
def test_cuda_general_kernels_match_plain(cuda_device, k, C, P):
    dps = [random_dp_inputs(P=P, ploidy=k, num_clusters=2 * k + 1,
                            seed=k * 1000 + i) for i in range(C)]
    arrays = dp_torch._pack_group(dps, list(range(C)), P)
    before = (ms.minplus_forward_streamed.launches,
              ms.backtrace_streamed.launches)
    fin, bp, st = _general(arrays, k, cuda_device)
    torch.cuda.synchronize()
    assert (ms.minplus_forward_streamed.launches,
            ms.backtrace_streamed.launches) == (before[0] + 1, before[1] + 1)
    fin_r, bp_r, st_r = _general(arrays, k, "cpu")
    assert torch.equal(fin.cpu(), fin_r)
    assert torch.equal(bp.cpu(), bp_r)
    assert torch.equal(st.cpu(), st_r)


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("ties", [False, True])
def test_cuda_general_forward_at_every_cluster_size(cuda_device, k, ties):
    """The general forward kernel equals its plain version at every
    cluster size it takes (one CTA a chain at k <= 2; 1 to 16 CTAs a chain
    above), on random batches and on all-ties batches (the same two
    candidates everywhere, zero node-cost weights: the first minimum must
    win across CTAs)."""
    C, P = 3, (10 if k == 5 else 30)
    dps = [random_dp_inputs(P=P, ploidy=k, num_clusters=2 * k + 1,
                            seed=k * 31 + i) for i in range(C)]
    arrays = dp_torch._pack_group(dps, list(range(C)), P)
    if ties:
        arrays[0][:] = -1
        arrays[0][:, :, :2] = [0, 1]
        arrays[1][:] = 2
    w = 0.0 if ties else 1.0
    counts = full_state_counts(k)
    ca, nc, co, cs, ge = to_torch(*arrays, device=cuda_device)
    node = dp_torch.node_costs_all(ca, nc, co, cs, ge, counts,
                                   full_state_validity(k), ploidy=k,
                                   num_alleles=ge.shape[2], cov_w=w,
                                   geno_w=w).contiguous()
    fin_r, bp_r = ms.minplus_forward_streamed(ca.cpu(), node.cpu(), counts,
                                              ploidy=k, **KW)
    for g in (ms.CLUSTER_SIZES if k > ms.SMALL_PLOIDY else (1,)):
        fin, bp = ms._forward(ca, node, counts, k, g, **KW)
        torch.cuda.synchronize()
        assert torch.equal(fin.cpu(), fin_r), g
        assert torch.equal(bp.cpu(), bp_r), g


def _warp_batch(k, C, P, seed, ties=False):
    dps = [random_dp_inputs(P=P, ploidy=k, num_clusters=2 * k + 1,
                            seed=seed * 100 + i) for i in range(C)]
    arrays = dp_torch._pack_group(dps, list(range(C)), P)
    if ties:
        arrays[0][:] = -1
        arrays[0][:, :, :2] = [0, 1]
        arrays[1][:] = 2
    return arrays


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("P", [ms.WARP_TILE - 1, ms.WARP_TILE,
                               ms.WARP_TILE + 1, 3 * ms.WARP_TILE + 5])
def test_cuda_warp_forward_tile_edges(cuda_device, k, P):
    """The k <= 2 forward (dpk_forward_warp) and the backtrace equal their
    plain versions at the edges of the staged tile of positions."""
    arrays = _warp_batch(k, 3, P, seed=P + k)
    fin, bp, st = _general(arrays, k, cuda_device)
    torch.cuda.synchronize()
    fin_r, bp_r, st_r = _general(arrays, k, "cpu")
    assert torch.equal(fin.cpu(), fin_r)
    assert torch.equal(bp.cpu(), bp_r)
    assert torch.equal(st.cpu(), st_r)


@pytest.mark.parametrize("C,P", [(1, 3 * ms.WARP_TILE + 5), (300, 24)])
def test_cuda_warp_forward_all_ties(cuda_device, C, P):
    """All-ties diploid batches (the same two candidates everywhere, zero
    node-cost weights): the first minimum wins in the balanced reduction,
    over several tiles (C=1) and over many chains (C=300)."""
    arrays = _warp_batch(2, C, P, seed=C, ties=True)

    def run(device):
        ca, nc, co, cs, ge = to_torch(*arrays, device=device)
        node = dp_torch.node_costs_all(ca, nc, co, cs, ge,
                                       full_state_counts(2),
                                       full_state_validity(2), ploidy=2,
                                       num_alleles=2, cov_w=0.0,
                                       geno_w=0.0).contiguous()
        fin, bp = md.minplus_forward_diploid(ca, node, **KW)
        fs = torch.argmin(fin, dim=1).to(torch.int32)
        return fin, bp, md.backtrace_diploid(bp, fs)

    got = run(cuda_device)
    torch.cuda.synchronize()
    want = run("cpu")
    valid = want[0][want[0] < 1e29]
    assert (valid == valid[0]).all()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("k,C,P", [(1, 2, 3000), (2, 2, 3000), (3, 2, 1000),
                                   (4, 2, 300), (5, 2, 64), (2, 300, 56)])
def test_cuda_backtrace_over_tiles(cuda_device, k, C, P):
    """The backtrace on random backpointers (every state in every row)
    over several staged tiles of rows, S = 2 to 2002, against its plain
    version."""
    from ahsoka_tpu_torch.ops.minplus import backtrace_ref

    S = full_state_counts(k).shape[0]
    rng = np.random.default_rng(k * 1000 + P)
    bp = torch.from_numpy(rng.integers(0, S, size=(C, P, S), dtype=np.int32))
    fs = torch.from_numpy(rng.integers(0, S, size=C, dtype=np.int32))
    got = ms.backtrace_streamed(bp.to(cuda_device), fs.to(cuda_device))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), backtrace_ref(bp, fs))


def test_cuda_threading_matches_cpu(cuda_device):
    dps = [random_dp_inputs(P=P, ploidy=2, num_clusters=6, seed=i)
           for i, P in enumerate([5, 12, 13, 30, 7, 64, 1, 140])]
    assert dp_torch.thread_chains_batched(dps, CFG, device=cuda_device) == \
        dp_torch.thread_chains_batched(dps, CFG, device="cpu")
    tetra = [random_dp_inputs(P=P, ploidy=4, num_clusters=9, seed=i)
             for i, P in enumerate([6, 13, 30])]
    cfg4 = PhasingConfig(ploidy=4)
    before = ms.minplus_forward_streamed.launches
    assert dp_torch.thread_chains_batched(tetra, cfg4,
                                          device=cuda_device) == \
        dp_torch.thread_chains_batched(tetra, cfg4, device="cpu")
    assert ms.minplus_forward_streamed.launches > before


@pytest.mark.parametrize("error_rate", [0.0, 0.08])
def test_cuda_projection_matches_cpu(cuda_device, error_rate):
    from ahsoka_tpu_torch.project import device as tdev

    bubble_paths, alignments = _sim_chain_inputs(error_rate)
    inputs = tdev.prepare_chain_inputs(bubble_paths, alignments)
    got = tdev.containment_key_tables_many([inputs], CFG,
                                           device=cuda_device)[0]
    want = tdev.containment_key_tables(inputs, CFG, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.to_dense(), w.to_dense())


@pytest.mark.parametrize("ploidy", [2, 4])
def test_cuda_scoring_matches_cpu(cuda_device, ploidy):
    from ahsoka_tpu_torch.score.device import score_pairs_device_many

    cfg = PhasingConfig(ploidy=ploidy)
    if ploidy == 2:
        mats = []
        for er, nb, rph in [(0.05, 6, 10), (0.1, 30, 40)]:
            bp, al = _sim_chain_inputs(er, nb, rph)
            mats.append(readset_to_matrix(
                build_chain_readsets(bp, al, CFG).partial_filtered))
    else:
        mats = [tetraploid_matrix(seed, 40 * (seed + 1), 12 * (seed + 1))
                for seed in range(3)]
    got = score_pairs_device_many(mats, cfg, device=cuda_device)
    want = score_pairs_device_many(mats, cfg, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
        assert cluster_editing(g, mode=cfg.ce_mode) == \
            cluster_editing(w, mode=cfg.ce_mode)


def test_cuda_golden_diploid(cuda_device, tmp_path):
    from ahsoka_tpu_torch.pipeline import run_phase

    gaf = tmp_path / "golden_diploid.gaf"
    shutil.copy(os.path.join(DATA, "golden_diploid.gaf"), gaf)
    out = str(tmp_path / "o")
    run_phase(os.path.join(DATA, "golden_diploid.gfa"), str(gaf), out,
              device=cuda_device)
    for got, want in [("o-result.txt", "golden_diploid-result.txt"),
                      ("o-bubbleinfo.txt", "golden_diploid-bubbleinfo.txt"),
                      ("golden_diploid-alignment_identities.txt",
                       "golden_diploid-identities.txt")]:
        with open(tmp_path / got, "rb") as a, \
                open(os.path.join(DATA, want), "rb") as b:
            assert a.read() == b.read(), got


@pytest.mark.parametrize("k,B,ties", [(6, 256, False), (3, 8, True)])
def test_cuda_beam_matches_cpu(cuda_device, k, B, ties):
    from ahsoka_tpu_torch.thread import dp_beam

    dps = [random_dp_inputs(P=12, ploidy=k, num_clusters=2 * k + 1,
                            seed=k * 100 + i) for i in range(2)]
    ca, nc, co, cs, ge = dp_torch._pack_group(dps, [0, 1], 12)
    if ties:
        ca[:] = -1
        ca[:, :, :2] = [0, 1]
        nc[:] = 2
        co[:] = 0.0
        co[:, :, :2] = 0.5
        cs[:] = 0

    def run(device):
        t = to_torch(ca, nc, co, cs, ge, device=device)
        node = dp_torch.node_costs_all(*t, full_state_counts(k),
                                       full_state_validity(k), ploidy=k,
                                       num_alleles=2, cov_w=1.0, geno_w=1.0)
        fwd = dp_beam.dp_forward_beam(t[0], node, full_state_counts(k),
                                      ploidy=k, beam_width=B, **KW)
        states = dp_beam.thread_beam(*t, ploidy=k, num_alleles=2,
                                     beam_width=B, cov_w=1.0, geno_w=1.0,
                                     **KW)
        return (node,) + fwd + (states,)

    before = dp_beam.thread_beam.launches
    got = run(cuda_device)
    torch.cuda.synchronize()
    assert dp_beam.thread_beam.launches == before + 1
    for g, w in zip(got, run("cpu")):
        assert torch.equal(g.cpu(), w)


def test_cuda_threading_beam_matches_cpu(cuda_device):
    cfg6 = PhasingConfig(ploidy=6, dp_beam_width=512)
    dps = [random_dp_inputs(P=P, ploidy=6, num_clusters=13, seed=P)
           for P in (5, 9, 14)]
    assert dp_torch.thread_chains_batched(dps, cfg6, device=cuda_device) \
        == dp_torch.thread_chains_batched(dps, cfg6, device="cpu")


@pytest.mark.parametrize("block", [64, 1024])
@pytest.mark.parametrize("mode", ["whatshap", "fresh"])
def test_cuda_banded_matches_cpu(cuda_device, mode, block):
    from ahsoka_tpu_torch.score.banded import score_pairs_banded

    cfg = PhasingConfig(ploidy=4, score_mode=mode)
    m = sorted_by_first(tetraploid_matrix(5, 1500, 300))
    before = score_pairs_banded.launches
    gu, gv, gw = score_pairs_banded(m, cfg, block=block, device=cuda_device)
    assert score_pairs_banded.launches == before + 1
    cu, cv, cw = score_pairs_banded(m, cfg, block=block, device="cpu")
    assert len(cu) > 1000
    np.testing.assert_array_equal(gu, cu)
    np.testing.assert_array_equal(gv, cv)
    np.testing.assert_allclose(gw, cw, rtol=1e-5, atol=1e-5)


def test_cuda_chain_sharded_dp_matches_unsharded(cuda_device):
    """The chain-sharded DP over two shards of one card: each shard
    launches the forward and backtrace kernels on its chains, and the
    states are the unsharded kernels' (and the CPU's)."""
    from ahsoka_tpu_torch.config import PhasingConfig as TorchConfig
    from ahsoka_tpu_torch.thread import dp_kernels

    for k, clusters in ((2, 5), (4, 9)):
        dps = [random_dp_inputs(P=24, ploidy=k, num_clusters=clusters,
                                seed=50 + i) for i in range(9)]
        cfg = TorchConfig(ploidy=k)
        want = dp_torch.thread_chains_batched(dps, cfg, device=cuda_device)
        dp_kernels.reset_launch_counts()
        got = dp_torch.thread_chains_batched(
            dps, TorchConfig(ploidy=k, chain_shards=2), device=cuda_device,
            devices=[cuda_device, cuda_device])
        launches = dp_kernels.launch_counts()
        forward = "dpk_forward_warp" if k <= ms.SMALL_PLOIDY else "dpk_forward"
        assert (launches[forward], launches["dpk_backtrace"]) == (2, 2)
        assert got == want == dp_torch.thread_chains_batched(dps, cfg,
                                                             device="cpu")


@pytest.mark.parametrize("mode", ["whatshap", "fresh"])
def test_cuda_row_sharded_scoring_matches_unsharded(cuda_device, mode):
    """Row blocks scored on two shards of one card against the unsharded
    scores on the card (the largest difference is printed): exactly
    equal, as on the CPU."""
    from ahsoka_tpu_torch.config import PhasingConfig as TorchConfig
    from ahsoka_tpu_torch.score.device import score_pairs_device

    m = tetraploid_matrix(7, 400, 60)
    cfg = TorchConfig(ploidy=4, score_mode=mode)
    single = score_pairs_device(m, cfg, device=cuda_device)
    sharded = score_pairs_device(
        m, TorchConfig(ploidy=4, score_mode=mode, data_shards=2),
        device=cuda_device, devices=[cuda_device, cuda_device])
    print(f"row-sharded vs unsharded on the card ({mode}): max |d| "
          f"{float(np.abs(sharded - single).max())}")
    assert np.array_equal(sharded, single)


@pytest.mark.parametrize("golden,kw", [
    ("golden_diploid", {}),
    ("golden_tetra", dict(ploidy=4, use_genotypes=False))])
@pytest.mark.parametrize("backend", ["jax", "host"])
def test_cuda_perchain_and_host_goldens(cuda_device, tmp_path, golden, kw,
                                        backend):
    """The per-chain driver (``batch_dp=False``; one forward and one
    backtrace launch for the golden's one chain) and the host backend with
    the card as the run's device: the committed result, byte for byte."""
    from ahsoka_tpu_torch.config import PhasingConfig as TorchConfig
    from ahsoka_tpu_torch.pipeline import run_phase
    from ahsoka_tpu_torch.thread import dp_kernels

    gaf = tmp_path / f"{golden}.gaf"
    shutil.copy(os.path.join(DATA, f"{golden}.gaf"), gaf)
    dp_kernels.reset_launch_counts()
    run_phase(os.path.join(DATA, f"{golden}.gfa"), str(gaf),
              str(tmp_path / "o"),
              TorchConfig(backend=backend, batch_dp=False, **kw),
              device=cuda_device)
    with open(tmp_path / "o-result.txt", "rb") as a, \
            open(os.path.join(DATA, f"{golden}-result.txt"), "rb") as b:
        assert a.read() == b.read()
    launches = dp_kernels.launch_counts()
    forward = launches["dpk_forward_warp"] + launches["dpk_forward"]
    want = 1 if backend == "jax" else 0
    assert (forward, launches["dpk_backtrace"]) == (want, want)


def test_cuda_bench_quick(cuda_device, capsys):
    """``python -m ahsoka_tpu_torch.bench --quick`` on the card: the
    kernel route is timed (``dpk_forward_warp`` and ``dpk_backtrace``
    launched), beside the plain versions, the native DP and the
    projection, with the card's nvidia-smi line."""
    import json

    from ahsoka_tpu_torch import bench
    from ahsoka_tpu_torch.thread import dp_kernels

    dp_kernels.reset_launch_counts()
    assert bench.main(["--quick"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    launches = dp_kernels.launch_counts()
    assert launches["dpk_forward_warp"] and launches["dpk_backtrace"]
    assert out["kernel"] == "cuda" and out["device"].startswith("cuda")
    for key in ("value", "plain_cells_per_s", "baseline_native_cells_per_s",
                "projection_reads_per_s", "vs_baseline"):
        assert np.isfinite(out[key]) and out[key] > 0
    assert out["value"] > out["plain_cells_per_s"]
    assert out["gpu"] and "," in out["gpu"]
