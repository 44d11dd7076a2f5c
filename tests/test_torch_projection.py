"""The port's projection (torch) against the JAX package's: int32 winner
tables exactly equal, matrix assembly and readsets identical."""

import numpy as np
import pytest
import torch

from ahsoka_tpu.config import PhasingConfig
from ahsoka_tpu.project import device as jdev
from ahsoka_tpu.project import matrix as jmat
from ahsoka_tpu.project.readset import build_chain_readsets
from ahsoka_tpu_torch.project import device as tdev
from ahsoka_tpu_torch.project import matrix as tmat

from test_device_parity import _readsets_equal, _sim_chain_inputs

torch.set_num_threads(1)

CFG = PhasingConfig()


def _dense(t):
    return t.to_dense() if hasattr(t, "to_dense") else np.asarray(t)


def _tables_equal(got, want):
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        g, w = _dense(g), _dense(w)
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)


def _multichain_inputs(tmp_path):
    from ahsoka_tpu.pipeline import prepare_phase_inputs
    from util import simulate_multichain

    out = []
    for tag, (nc, bpc, rph) in enumerate([(3, 6, 7), (1, 40, 40)]):
        glines, gaf = simulate_multichain(num_chains=nc,
                                          bubbles_per_chain=bpc,
                                          reads_per_hap=rph,
                                          error_rate=0.1, seed=3 + tag)
        gfa = tmp_path / f"g{tag}.gfa"
        gfa.write_text("".join(glines))
        gaff = tmp_path / f"r{tag}.gaf"
        gaff.write_text("".join(gaf))
        art = prepare_phase_inputs(str(gfa), str(gaff),
                                   str(tmp_path / f"o{tag}"), CFG)
        out += [(art.allele_paths[cid], art.alignments.chain_alignments(cid))
                for _, cid in art.size_sorting]
    return out


@pytest.mark.parametrize("error_rate", [0.0, 0.08])
def test_key_tables_match_jax(error_rate):
    bubble_paths, alignments = _sim_chain_inputs(error_rate)
    t_in = tdev.prepare_chain_inputs(bubble_paths, alignments)
    j_in = jdev.prepare_chain_inputs(bubble_paths, alignments)
    want = jdev.containment_key_tables(j_in, CFG)
    _tables_equal(tdev.containment_key_tables(t_in, CFG, device="cpu"),
                  want)
    _tables_equal(tdev.containment_key_tables_many([t_in], CFG,
                                                   device="cpu")[0], want)
    _tables_equal(jdev.containment_key_tables_many([j_in], CFG)[0], want)


def test_batched_tables_match_jax_across_shape_groups(tmp_path):
    chains = _multichain_inputs(tmp_path)
    t_in = [tdev.prepare_chain_inputs(bp, al) for bp, al in chains]
    j_in = [jdev.prepare_chain_inputs(bp, al) for bp, al in chains]
    got = tdev.containment_key_tables_many(t_in, CFG, device="cpu")
    want = jdev.containment_key_tables_many(j_in, CFG)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _tables_equal(g, w)


def test_bubble_blocked_tables_match_unblocked(monkeypatch):
    bubble_paths, alignments = _sim_chain_inputs(0.05, num_bubbles=30,
                                                 reads_per_hap=40)
    t_in = tdev.prepare_chain_inputs(bubble_paths, alignments)
    want = tdev.containment_key_tables(t_in, CFG, device="cpu")
    # force three bubble blocks
    monkeypatch.setattr(tdev, "_KEY_TABLE_BUDGET", 3 * 64 * 128 * 4 // 3)
    _tables_equal(tdev.containment_key_tables(t_in, CFG, device="cpu"),
                  want)


@pytest.mark.parametrize("error_rate", [0.0, 0.08])
def test_chain_matrix_from_keys_matches_original(error_rate):
    bubble_paths, alignments = _sim_chain_inputs(error_rate, num_bubbles=12,
                                                 reads_per_hap=16)
    t_in = tdev.prepare_chain_inputs(bubble_paths, alignments)
    j_in = jdev.prepare_chain_inputs(bubble_paths, alignments)
    full_k, part_k, gate_k = tdev.containment_key_tables(t_in, CFG,
                                                         device="cpu")
    sweep_t = tmat.partial_sweep_from_stats(t_in, full_k, CFG)
    sweep_j = jmat.partial_sweep_from_stats(j_in, _dense(full_k), CFG)
    np.testing.assert_array_equal(sweep_t, sweep_j)
    got = tmat.chain_matrix_from_keys(t_in, part_k, gate_k, sweep_t, CFG)
    want = jmat.chain_matrix_from_keys(j_in, _dense(part_k),
                                       _dense(gate_k), sweep_j, CFG)
    np.testing.assert_array_equal(got.matrix.alleles, want.matrix.alleles)
    np.testing.assert_array_equal(got.matrix.positions,
                                  want.matrix.positions)
    assert got.matrix.read_names == want.matrix.read_names
    np.testing.assert_array_equal(got.mapq, want.mapq)
    np.testing.assert_array_equal(got.name_ids, want.name_ids)


def test_device_readsets_match_host_oracle():
    bubble_paths, alignments = _sim_chain_inputs(0.05)
    host = build_chain_readsets(bubble_paths, alignments, CFG)
    dev = tdev.build_chain_readsets_device(bubble_paths, alignments, CFG,
                                           device="cpu")
    _readsets_equal(host.full, dev.full)
    _readsets_equal(host.partial_filtered, dev.partial_filtered)
    assert host.projected_positions == dev.projected_positions
