"""The port's sharded layouts against the JAX package's, in process on the
CPU: the JAX package on the 8 virtual CPU devices of tests/conftest.py,
the port on ``devices=["cpu"] * n``.

Key tables and DP paths must be exactly equal; row-sharded scores exactly
equal to the port's unsharded scores and within rtol = atol = 1e-4 (the
JAX device tests' tolerance) of the JAX package's sharded scores; result
files byte-equal.  Where the JAX package's data-sharded projection packs
shard-local alignment indices (alignments past the first shard), the
port is held to the unsharded tables instead."""

import dataclasses
import glob
import logging
import os
import shutil
import threading

import jax
import numpy as np
import pytest
import torch

from ahsoka_tpu.config import PhasingConfig as JaxConfig
from ahsoka_tpu_torch.config import PhasingConfig

from test_device_parity import _sim_chain_inputs
from test_dp import random_dp_inputs

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
TOL = dict(rtol=1e-4, atol=1e-4)


def _dense(t):
    return t.to_dense() if hasattr(t, "to_dense") else np.asarray(t)


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _cpus(n):
    return ["cpu"] * n


def _chain_inputs(num_bubbles, reads_per_hap, error_rate=0.05):
    from ahsoka_tpu.project.device import prepare_chain_inputs as jax_prep
    from ahsoka_tpu_torch.project.device import prepare_chain_inputs

    bp, al = _sim_chain_inputs(error_rate, num_bubbles=num_bubbles,
                               reads_per_hap=reads_per_hap)
    return jax_prep(bp, al), prepare_chain_inputs(bp, al)


@pytest.mark.parametrize("chunk", [256, 8])
@pytest.mark.parametrize("shards", [2, 4, 8])
def test_sharded_projection_matches_jax_package(shards, chunk):
    """Twin of test_sharded.py:22.  At chunk 256 every alignment lies in
    the first shard and the JAX package's sharded tables are the
    reference; at chunk 8 the alignments spread over every shard and the
    port's tables equal the unsharded ones (global alignment indices)."""
    from ahsoka_tpu.project.device import \
        containment_key_tables as jax_tables
    from ahsoka_tpu_torch.project.device import containment_key_tables

    jin, tin = _chain_inputs(6, 12)
    assert tin.num_alignments > 8 * shards
    cfg = PhasingConfig(data_shards=shards)
    got = containment_key_tables(tin, cfg, chunk=chunk, device="cpu",
                                 devices=_cpus(shards))
    want = (jax_tables(jin, dataclasses.replace(JaxConfig(),
                                                data_shards=shards),
                       chunk=chunk) if chunk == 256
            else jax_tables(jin, JaxConfig()))
    unsharded = containment_key_tables(tin, PhasingConfig(), device="cpu")
    for a, b, c in zip(got, want, unsharded):
        assert np.array_equal(_dense(a), _dense(b))
        assert np.array_equal(_dense(a), _dense(c))


@pytest.mark.parametrize("shards", [1, 4])
def test_bubble_blocked_projection_matches_unblocked(shards, monkeypatch):
    """Twin of test_sharded.py:37: bubble blocks, sharded or not, give the
    single-carry tables (and the JAX package's)."""
    import ahsoka_tpu_torch.project.device as pd
    from ahsoka_tpu.project.device import \
        containment_key_tables as jax_tables

    jin, tin = _chain_inputs(9, 11)
    cfg = PhasingConfig(data_shards=shards)
    single = pd.containment_key_tables(tin, cfg, chunk=8, device="cpu",
                                       devices=_cpus(shards))
    monkeypatch.setattr(pd, "_KEY_TABLE_BUDGET", 64)   # force ~B blocks
    blocked = pd.containment_key_tables(tin, cfg, chunk=8, device="cpu",
                                        devices=_cpus(shards))
    monkeypatch.undo()
    want = jax_tables(jin, JaxConfig())
    for a, b, c in zip(single, blocked, want):
        assert np.array_equal(_dense(a), _dense(b))
        assert np.array_equal(_dense(a), _dense(c))


def _scoring_matrix(mode, seed=None):
    from ahsoka_tpu.project.readset import build_chain_readsets
    from ahsoka_tpu.score.pairwise import AlleleMatrix, readset_to_matrix

    if seed is None:
        bp, al = _sim_chain_inputs(0.08, num_bubbles=6, reads_per_hap=15)
        return readset_to_matrix(build_chain_readsets(
            bp, al, JaxConfig(score_mode=mode)).partial_filtered)
    # a wider tetraploid matrix: 300 reads (R_pad 512) over 90 positions
    rng = np.random.default_rng(seed)
    haps = rng.integers(0, 3, size=(4, 90))
    alleles = np.full((300, 90), -1, dtype=np.int16)
    for r in range(300):
        s0 = int(rng.integers(0, 84))
        cols = np.arange(s0, s0 + int(rng.integers(3, 7)))
        row = haps[r % 4, cols].copy()
        flip = rng.random(len(cols)) < 0.05
        row[flip] = (row[flip] + 1) % 3
        alleles[r, cols] = row
    return AlleleMatrix(alleles=alleles,
                        positions=np.arange(90, dtype=np.int32),
                        read_names=[f"r{r}" for r in range(300)])


@pytest.mark.parametrize("mode", ["whatshap", "fresh"])
@pytest.mark.parametrize("shards", [2, 4, 8])
def test_sharded_scoring_matches_single_device(shards, mode):
    """Twin of test_sharded.py:95: row blocks over ``shards`` CPU devices
    give the port's unsharded scores exactly, and the JAX package's
    sharded scores within the scoring tolerance; also on a wider
    tetraploid matrix."""
    from ahsoka_tpu.score.device import score_pairs_device as jax_score
    from ahsoka_tpu_torch.score.device import score_pairs_device

    m = _scoring_matrix(mode)
    cfg = PhasingConfig(score_mode=mode)
    single = score_pairs_device(m, cfg, device="cpu")
    sharded = score_pairs_device(m, dataclasses.replace(cfg,
                                                        data_shards=shards),
                                 device="cpu", devices=_cpus(shards))
    assert np.array_equal(single, sharded)
    np.testing.assert_allclose(
        sharded, jax_score(m, JaxConfig(score_mode=mode,
                                        data_shards=shards)), **TOL)
    wide = _scoring_matrix(mode, seed=shards)
    cfg4 = dataclasses.replace(cfg, ploidy=4)
    assert np.array_equal(
        score_pairs_device(wide, cfg4, device="cpu"),
        score_pairs_device(wide, dataclasses.replace(cfg4,
                                                     data_shards=shards),
                           device="cpu", devices=_cpus(shards)))


@pytest.mark.parametrize("mode", ["whatshap", "fresh"])
def test_score_rows_core_matches_score_core(mode):
    """``_score_rows_core[_wh]`` at row0 = 0 over every row is
    ``_score_core[_wh]``; a block at row0 > 0 agrees with the JAX
    package's row-block core within the scoring tolerance."""
    from ahsoka_tpu.score import device as jdev
    from ahsoka_tpu_torch.score import device as tdev

    m = _scoring_matrix(mode, seed=11)
    a = tdev._padded_alleles(m)
    full = torch.from_numpy(a)[None]
    s = torch.tensor([0.07], dtype=torch.float32)
    kw = dict(num_alleles=3, ploidy=4, min_overlap=1)
    rows_core = (tdev._score_rows_core_wh if mode == "whatshap"
                 else tdev._score_rows_core)
    core = tdev._score_core_wh if mode == "whatshap" else tdev._score_core
    assert torch.equal(rows_core(full, full.clone(), s, 0, **kw),
                       core(full, s, **kw))
    jrows = (jdev._score_rows_core_wh if mode == "whatshap"
             else jdev._score_rows_core)
    row0, rb = 128, 128
    got = rows_core(full[:, row0:row0 + rb], full, s, row0, **kw)[0]
    want = jrows(a[row0:row0 + rb], a, np.float32(0.07), row0, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert bool((got[:, row0:row0 + rb].diagonal() == 0).all())


def _dp_batch(ploidy, n):
    return [random_dp_inputs(P=5 + i % 4, ploidy=ploidy,
                             num_clusters=2 * ploidy, seed=31 * i + ploidy)
            for i in range(n)]


@pytest.mark.parametrize("ploidy", [2, 4])
@pytest.mark.parametrize("shards", [2, 3, 8])
def test_chain_sharded_dp_matches_jax_package(shards, ploidy):
    """Chain-sharded DP at 2, 3 (uneven) and 8 shards (more shards than
    chains in a group): paths exactly those of the JAX package's
    thread_chains_batched with chain_shards, and of the unsharded DP."""
    from ahsoka_tpu.thread.dp_jax import thread_chains_batched as jax_tcb
    from ahsoka_tpu_torch.thread.dp_torch import thread_chains_batched

    dps = _dp_batch(ploidy, 9)
    got = thread_chains_batched(
        dps, PhasingConfig(ploidy=ploidy, chain_shards=shards),
        device="cpu", devices=_cpus(shards))
    assert got == jax_tcb(dps, JaxConfig(ploidy=ploidy,
                                         chain_shards=shards))
    assert got == thread_chains_batched(dps, PhasingConfig(ploidy=ploidy),
                                        device="cpu")


def test_chain_sharded_dp_runs_every_shard(monkeypatch):
    """Each non-empty shard runs the DP on its own slice of a group's
    chains, in chain order; empty shards run nothing; beam groups stay
    unsharded."""
    from ahsoka_tpu_torch.thread import dp_torch

    calls = []
    real = dp_torch.thread_states

    def spy(ca, *a, **k):
        calls.append(ca.shape[0])
        return real(ca, *a, **k)

    monkeypatch.setattr(dp_torch, "thread_states", spy)
    dps = [random_dp_inputs(P=6, ploidy=2, num_clusters=4, seed=s)
           for s in range(5)]
    dp_torch.thread_chains_batched(dps, PhasingConfig(chain_shards=8),
                                   device="cpu", devices=_cpus(8))
    assert calls == [1] * 5
    calls.clear()
    dp_torch.thread_chains_batched(dps, PhasingConfig(chain_shards=3),
                                   device="cpu", devices=_cpus(3))
    assert calls == [2, 2, 1]
    calls.clear()
    beam = PhasingConfig(ploidy=4, dp_beam_width=16, chain_shards=2)
    dp_torch.thread_chains_batched(_dp_batch(4, 3), beam, device="cpu",
                                   devices=_cpus(2))
    assert calls == [3]


def test_gates_fall_back_and_log(caplog):
    """Too few devices, a row count the shards do not divide, or row
    weights: the unsharded path, logged at info level."""
    from ahsoka_tpu_torch.dist import mesh
    from ahsoka_tpu_torch.score.device import score_pairs_device

    mesh._log_fallback.cache_clear()
    m = _scoring_matrix("whatshap")
    cfg = PhasingConfig()
    single = score_pairs_device(m, cfg, device="cpu")
    with caplog.at_level(logging.INFO, logger="ahsoka_tpu_torch"):
        three = score_pairs_device(m, dataclasses.replace(cfg,
                                                          data_shards=3),
                                   device="cpu", devices=_cpus(3))
        two_on_one = score_pairs_device(
            m, dataclasses.replace(cfg, data_shards=2), device="cpu")
        weighted = score_pairs_device(
            m, dataclasses.replace(cfg, data_shards=2), device="cpu",
            mult=np.ones(m.num_reads, dtype=np.float32), devices=_cpus(2))
    assert np.array_equal(single, three)
    assert np.array_equal(single, two_on_one)
    np.testing.assert_allclose(single, weighted, **TOL)
    text = caplog.text
    assert "64 padded rows" in text and "only 1 device" in text
    assert "row-weighted" in text and "running unsharded" in text


def test_mesh_layout():
    from ahsoka_tpu_torch.dist.mesh import make_mesh

    m = make_mesh(data=2, chain=3, devices=_cpus(8))
    assert (m.size, m.rank, len(m.local_shards())) == (6, 0, 6)
    assert [s.index for s in m.local_shards()] == list(range(6))
    with pytest.raises(ValueError):
        make_mesh(data=3, chain=3, devices=_cpus(8))


@pytest.mark.parametrize("rank", [0, 1])
def test_each_rank_takes_its_own_card(monkeypatch, rank):
    """In a process group of two ranks on a host of two cards, a bare
    ``cuda`` names the rank's own card, its default device list is that
    card alone, and the global device list holds two devices, not four."""
    from ahsoka_tpu_torch.dist import mesh

    monkeypatch.setattr(mesh, "world", lambda: (2, rank))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    own = torch.device("cuda", rank)
    assert mesh.own_card("cuda") == own
    assert mesh.own_card("cuda:0") == torch.device("cuda", 0)
    assert mesh.own_card("cpu") == torch.device("cpu")
    devices = mesh.local_devices(None, "cuda")
    assert devices == [own]
    m = mesh.gated_mesh(2, mesh.DATA_AXIS, devices, own, "test")
    assert [(s.rank, s.device) for s in m.shards] == \
        [(0, own if rank == 0 else None), (1, own if rank == 1 else None)]
    assert mesh.gated_mesh(4, mesh.DATA_AXIS, devices, own, "test") is None


def test_cli_sharding_flags_on_one_device_phase_unsharded(tmp_path):
    """``--data-shards 2 --chain-shards 2 --device cpu`` on one device
    (the gates fall back) phases golden_diploid byte-equal to the
    unsharded run."""
    from ahsoka_tpu_torch.cli.main import main

    gaf = tmp_path / "golden_diploid.gaf"
    shutil.copy(os.path.join(DATA, "golden_diploid.gaf"), gaf)
    base = ["phase", "-g", os.path.join(DATA, "golden_diploid.gfa"), "-a",
            str(gaf), "--device", "cpu"]
    assert main(base + ["-o", str(tmp_path / "u")]) == 0
    assert main(base + ["-o", str(tmp_path / "s"), "--data-shards", "2",
                        "--chain-shards", "2"]) == 0
    for suffix in ("-result.txt", "-bubbleinfo.txt"):
        assert _read(str(tmp_path / f"s{suffix}")) == \
            _read(str(tmp_path / f"u{suffix}"))
    assert _read(str(tmp_path / "s-result.txt")) == \
        _read(os.path.join(DATA, "golden_diploid-result.txt"))


def _write_inputs(tmp_path, glines, gaf):
    gfa, gaff = tmp_path / "g.gfa", tmp_path / "r.gaf"
    gfa.write_text("".join(glines))
    gaff.write_text("".join(gaf))
    return str(gfa), str(gaff)


def test_sharded_phase_end_to_end(tmp_path):
    """Twin of test_sharded.py:118 (data 4)."""
    from util import simulate_diploid
    from ahsoka_tpu_torch.pipeline import run_phase

    glines, gaf, _, _ = simulate_diploid(num_bubbles=5, reads_per_hap=8)
    gfa, gaff = _write_inputs(tmp_path, glines, gaf)
    cfg1 = PhasingConfig(debug_readset_files=False)
    run_phase(gfa, gaff, str(tmp_path / "s1"), cfg1, device="cpu")
    run_phase(gfa, gaff, str(tmp_path / "s4"),
              dataclasses.replace(cfg1, data_shards=4), device="cpu",
              devices=_cpus(4))
    assert _read(str(tmp_path / "s1-result.txt")) == \
        _read(str(tmp_path / "s4-result.txt"))


def _chain_files(stem):
    return {os.path.basename(f).split("-", 1)[1]: _read(f)
            for f in glob.glob(f"{stem}-chain*-result.txt")}


def test_full_pipeline_data_and_chain_sharded(tmp_path):
    """Twin of test_sharded.py:139: the whole pipeline (multi-chain, noisy
    reads) on 1 device and on a 4 x 2 mesh of CPU devices writes the same
    result, bubbleinfo and chain files, and those of the JAX package's
    4 x 2 virtual mesh."""
    from util import simulate_multichain
    from ahsoka_tpu.pipeline import run_phase as jax_run_phase
    from ahsoka_tpu_torch.pipeline import run_phase

    glines, gaf = simulate_multichain(num_chains=4, bubbles_per_chain=6,
                                      reads_per_hap=10, error_rate=0.05,
                                      seed=3)
    gfa, gaff = _write_inputs(tmp_path, glines, gaf)
    base = PhasingConfig(debug_readset_files=False)
    run_phase(gfa, gaff, str(tmp_path / "m1"), base, device="cpu")
    run_phase(gfa, gaff, str(tmp_path / "m8"),
              dataclasses.replace(base, data_shards=4, chain_shards=2),
              device="cpu", devices=_cpus(8))
    assert len(jax.devices()) >= 8
    jax_run_phase(gfa, gaff, str(tmp_path / "j8"),
                  JaxConfig(backend="jax", debug_readset_files=False,
                            data_shards=4, chain_shards=2))
    for other in ("m8", "j8"):
        for suffix in ("-result.txt", "-bubbleinfo.txt"):
            assert _read(str(tmp_path / f"m1{suffix}")) == \
                _read(str(tmp_path / f"{other}{suffix}")), (other, suffix)
        files = _chain_files(str(tmp_path / "m1"))
        assert files and files == _chain_files(str(tmp_path / other))


def test_collectives_stay_on_the_calling_thread(tmp_path, monkeypatch):
    """With --threads workers, every collective of a sharded run (chains
    above the pre-pass bubble cap included) runs on the calling thread,
    so every rank makes them in one order."""
    from util import simulate_multichain
    from ahsoka_tpu_torch import phase
    from ahsoka_tpu_torch.dist import mesh, step
    from ahsoka_tpu_torch.pipeline import run_phase

    seen = []
    for mod, name in ((step, "min_merge"), (step, "gather_rows")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **k):
            seen.append((_name, threading.current_thread().name))
            return _real(*a, **k)

        monkeypatch.setattr(mod, name, spy)
    monkeypatch.setattr(phase, "_PRE_PASS_MAX_BUBBLES", 3)
    glines, gaf = simulate_multichain(num_chains=4, bubbles_per_chain=6,
                                      reads_per_hap=10, error_rate=0.05,
                                      seed=3)
    gfa, gaff = _write_inputs(tmp_path, glines, gaf)
    cfg = PhasingConfig(debug_readset_files=False, threads=4)
    run_phase(gfa, gaff, str(tmp_path / "u"), cfg, device="cpu")
    run_phase(gfa, gaff, str(tmp_path / "s"),
              dataclasses.replace(cfg, data_shards=2, chain_shards=2),
              device="cpu", devices=_cpus(2))
    main = threading.main_thread().name
    assert {n for n, _t in seen} == {"min_merge", "gather_rows"}
    assert all(t == main for _n, t in seen), seen
    assert _read(str(tmp_path / "u-result.txt")) == \
        _read(str(tmp_path / "s-result.txt"))
    assert mesh.world() == (1, 0)


def test_chain_layout_refuses_shards_at_more_than_one_process(
        tmp_path, monkeypatch):
    from ahsoka_tpu_torch import phase
    from ahsoka_tpu_torch.pipeline import run_phase

    cfg = PhasingConfig(process_chain_sharding=True, data_shards=2)
    phase.check_layout(cfg)                  # one process: allowed
    monkeypatch.setattr(phase, "world", lambda: (2, 0))
    with pytest.raises(ValueError, match="data_shards/chain_shards"):
        phase.check_layout(cfg)
    with pytest.raises(ValueError, match="data_shards/chain_shards"):
        phase.check_layout(dataclasses.replace(cfg, data_shards=1,
                                               chain_shards=2))
    phase.check_layout(dataclasses.replace(cfg, data_shards=1))
    with pytest.raises(ValueError, match="process_chain_sharding requires "
                       "the batched"):
        run_phase("missing.gfa", "missing.gaf", str(tmp_path / "o"),
                  PhasingConfig(process_chain_sharding=True,
                                batch_dp=False), device="cpu")


def test_chain_layout_without_group_warns_and_runs(tmp_path, caplog):
    """process_chain_sharding with no process group: one process phases
    every chain, writes the side files, and says so."""
    from ahsoka_tpu_torch.pipeline import run_phase

    gaf = tmp_path / "golden_diploid.gaf"
    shutil.copy(os.path.join(DATA, "golden_diploid.gaf"), gaf)
    with caplog.at_level(logging.WARNING, logger="ahsoka_tpu_torch"):
        run_phase(os.path.join(DATA, "golden_diploid.gfa"), str(gaf),
                  str(tmp_path / "o"),
                  PhasingConfig(process_chain_sharding=True), device="cpu")
    assert "no torch.distributed process group" in caplog.text
    assert _read(str(tmp_path / "o-result.txt")) == \
        _read(os.path.join(DATA, "golden_diploid-result.txt"))
    assert (tmp_path / "o-bubbleinfo.txt").exists()
