"""The port on an NVIDIA card against its plain PyTorch path on the CPU.

Every test here needs a card (marker ``gpu``) and skips without one.  The
file imports no jax, so on a machine with a card and no jax it runs as

    python -m pytest --noconftest -q tests/test_torch_cuda.py

The DP kernels must equal their plain versions exactly; projection key
tables exactly; scores within rtol = atol = 1e-4 (float32 matmuls summed
in another order on the card); results byte-equal to the goldens."""

import os
import shutil

import numpy as np
import pytest
import torch

from ahsoka_tpu.cluster.editing import cluster_editing
from ahsoka_tpu.config import PhasingConfig
from ahsoka_tpu.project.readset import build_chain_readsets
from ahsoka_tpu.score.pairwise import readset_to_matrix
from ahsoka_tpu.thread.states import full_state_counts, full_state_validity
from ahsoka_tpu_torch.ops import minplus_diploid as md
from ahsoka_tpu_torch.state import to_torch
from ahsoka_tpu_torch.thread import dp_torch

from test_device_parity import _sim_chain_inputs
from test_dp import random_dp_inputs

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu

DATA = os.path.join(os.path.dirname(__file__), "data")
CFG = PhasingConfig()
KW = dict(switch_cost=CFG.switch_cost, affine_cost=CFG.affine_switch_cost)


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


def test_cuda_threading_matches_cpu(cuda_device):
    dps = [random_dp_inputs(P=P, ploidy=2, num_clusters=6, seed=i)
           for i, P in enumerate([5, 12, 13, 30, 7, 64, 1, 140])]
    assert dp_torch.thread_chains_batched(dps, CFG, device=cuda_device) == \
        dp_torch.thread_chains_batched(dps, CFG, device="cpu")
    tetra = [random_dp_inputs(P=6, ploidy=4, num_clusters=9, seed=0)]
    with pytest.raises(NotImplementedError, match="queue 2 c"):
        dp_torch.thread_chains_batched(tetra, PhasingConfig(ploidy=4),
                                       device=cuda_device)


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


def test_cuda_scoring_matches_cpu(cuda_device):
    from ahsoka_tpu_torch.score.device import score_pairs_device_many

    mats = []
    for er, nb, rph in [(0.05, 6, 10), (0.1, 30, 40)]:
        bp, al = _sim_chain_inputs(er, nb, rph)
        mats.append(readset_to_matrix(
            build_chain_readsets(bp, al, CFG).partial_filtered))
    got = score_pairs_device_many(mats, CFG, device=cuda_device)
    want = score_pairs_device_many(mats, CFG, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
        assert cluster_editing(g, mode=CFG.ce_mode) == \
            cluster_editing(w, mode=CFG.ce_mode)


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
