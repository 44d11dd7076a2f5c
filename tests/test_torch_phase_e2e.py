"""The port end to end on the CPU: its CLI reproduces the committed golden
outputs byte for byte, and its run_phase and CLI write the same result
files as the JAX package's on synthetic multi-chain inputs: diploid,
tetraploid, triploid (through the CLI), mixed ploidy (a ploidy map from
the planted truth), hexaploid through the beam DP, and chains forced onto
banded scoring."""

import contextlib
import dataclasses
import glob
import json
import os
import shutil

import pytest
import torch

from ahsoka_tpu.config import PhasingConfig
from ahsoka_tpu.utils.synth import SynthSpec, write_synthetic
from ahsoka_tpu_torch.cli.main import main as cli_main

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _golden(name):
    return _read(os.path.join(DATA, name))


def test_cli_golden_diploid(tmp_path):
    gaf = tmp_path / "golden_diploid.gaf"
    shutil.copy(os.path.join(DATA, "golden_diploid.gaf"), gaf)
    out = str(tmp_path / "o")
    assert cli_main(["phase", "-g", os.path.join(DATA, "golden_diploid.gfa"),
                     "-a", str(gaf), "-o", out, "--device", "cpu"]) == 0
    assert _read(out + "-result.txt") == _golden("golden_diploid-result.txt")
    assert _read(out + "-bubbleinfo.txt") == \
        _golden("golden_diploid-bubbleinfo.txt")
    assert _read(str(tmp_path / "golden_diploid-alignment_identities.txt")
                 ) == _golden("golden_diploid-identities.txt")
    with open(out + "-metrics.json") as fh:
        m = json.load(fh)
    assert m["backend"] == "torch" and m["device"] == "cpu"
    assert m["chains_phased"] == 1 and m["chains_failed"] == 0


def test_cli_golden_tetraploid(tmp_path):
    gaf = tmp_path / "golden_tetra.gaf"
    shutil.copy(os.path.join(DATA, "golden_tetra.gaf"), gaf)
    out = str(tmp_path / "o")
    assert cli_main(["phase", "-g", os.path.join(DATA, "golden_tetra.gfa"),
                     "-a", str(gaf), "-o", out, "--device", "cpu",
                     "--ploidy", "4", "--no-genotypes"]) == 0
    assert _read(out + "-result.txt") == _golden("golden_tetra-result.txt")


def test_cli_only_bubbles(tmp_path):
    out = str(tmp_path / "b")
    assert cli_main(["only-bubbles", "-g",
                     os.path.join(DATA, "golden_diploid.gfa"), "-o",
                     out]) == 0
    assert _read(out + "-bubbleinfo.txt") == \
        _golden("golden_diploid-bubbleinfo.txt")


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    d = tmp_path_factory.mktemp("synth")
    spec = SynthSpec(num_chains=8, bubbles_per_chain=20, reads_per_hap=30,
                     span=3, error_rate=0.02, seed=4)
    gfa, gaf = str(d / "s.gfa"), str(d / "s.gaf")
    write_synthetic(gfa, gaf, spec)
    return d, gfa, gaf


BENCH = PhasingConfig(debug_readset_files=False, max_coverage=64)


def _chain_files(stem):
    return {os.path.basename(f).split("-", 1)[1]: _read(f)
            for f in glob.glob(f"{stem}-chain*-result.txt")}


def test_run_phase_matches_jax_package(synth):
    from ahsoka_tpu.pipeline import run_phase as jax_run_phase
    from ahsoka_tpu_torch.pipeline import run_phase

    d, gfa, gaf = synth
    jax_run_phase(gfa, gaf, str(d / "jax"), BENCH)
    art = run_phase(gfa, gaf, str(d / "torch"), BENCH, device="cpu")
    assert _read(str(d / "torch-result.txt")) == \
        _read(str(d / "jax-result.txt"))
    assert _chain_files(str(d / "torch")) == _chain_files(str(d / "jax"))
    assert len(art.threading["paths"]) == 8


def _same_outputs(stem_a, stem_b):
    assert _read(stem_a + "-result.txt") == _read(stem_b + "-result.txt")
    files = _chain_files(stem_a)
    assert files and files == _chain_files(stem_b)


def test_run_phase_tetraploid_matches_jax_package(tmp_path):
    from ahsoka_tpu.pipeline import run_phase as jax_run_phase
    from ahsoka_tpu_torch.pipeline import run_phase

    gfa, gaf = str(tmp_path / "t.gfa"), str(tmp_path / "t.gaf")
    write_synthetic(gfa, gaf, SynthSpec(
        num_chains=3, bubbles_per_chain=12, reads_per_hap=24, ploidy=4,
        span=3, error_rate=0.02, seed=7))
    cfg = dataclasses.replace(BENCH, ploidy=4, genotype_prior="balanced")
    jax_run_phase(gfa, gaf, str(tmp_path / "jax"), cfg)
    art = run_phase(gfa, gaf, str(tmp_path / "torch"), cfg, device="cpu")
    _same_outputs(str(tmp_path / "torch"), str(tmp_path / "jax"))
    assert {c.ploidy for c in art.threading["configs"]} == {4}


def test_cli_triploid_matches_jax_package(tmp_path):
    from ahsoka_tpu.cli.main import main as jax_cli_main

    gfa, gaf = str(tmp_path / "t.gfa"), str(tmp_path / "t.gaf")
    write_synthetic(gfa, gaf, SynthSpec(
        num_chains=2, bubbles_per_chain=10, reads_per_hap=20, ploidy=3,
        span=3, error_rate=0.02, seed=3))
    args = ["phase", "-g", gfa, "-a", gaf, "--ploidy", "3",
            "--genotype-prior", "balanced"]
    assert jax_cli_main(args + ["-o", str(tmp_path / "jax")]) == 0
    assert cli_main(args + ["-o", str(tmp_path / "torch"), "--device",
                            "cpu"]) == 0
    _same_outputs(str(tmp_path / "torch"), str(tmp_path / "jax"))


def test_run_phase_mixed_ploidy_matches_jax_package(tmp_path):
    from ahsoka_tpu.graph.alleles import enumerate_allele_paths
    from ahsoka_tpu.pipeline import run_phase as jax_run_phase
    from ahsoka_tpu.utils.accuracy import ploidy_map_from_truth
    from ahsoka_tpu_torch.pipeline import load_graph_and_bubbles, run_phase

    gfa, gaf = str(tmp_path / "m.gfa"), str(tmp_path / "m.gaf")
    truth = str(tmp_path / "m.truth")
    write_synthetic(gfa, gaf, SynthSpec(
        chain_plan=[(8, 2), (8, 4), (6, 3)], reads_per_hap=20,
        span=3, error_rate=0.02, seed=5), truth_path=truth)
    art = load_graph_and_bubbles(gfa, BENCH)
    pmap = ploidy_map_from_truth(
        enumerate_allele_paths(art.graph, art.index), truth)
    assert sorted(pmap.values()) == [2, 3, 4]
    cfg = dataclasses.replace(BENCH, ploidy_map=pmap,
                              genotype_prior="balanced")
    jax_run_phase(gfa, gaf, str(tmp_path / "jax"), cfg)
    art = run_phase(gfa, gaf, str(tmp_path / "torch"), cfg, device="cpu")
    _same_outputs(str(tmp_path / "torch"), str(tmp_path / "jax"))
    assert {c.ploidy for c in art.threading["configs"]} == {2, 3, 4}


def test_resume_skips_done_chains(synth):
    from ahsoka_tpu_torch.pipeline import run_phase

    d, gfa, gaf = synth
    stem = str(d / "resume")
    run_phase(gfa, gaf, stem, BENCH, device="cpu")
    first = _read(stem + "-result.txt")
    run_phase(gfa, gaf, stem, BENCH, device="cpu", resume=True)
    assert _read(stem + "-result.txt") == first
    with open(stem + "-metrics.json") as fh:
        m = json.load(fh)
    assert all(c["resumed"] for c in m["chains"])


def test_keep_going_retries_threading_per_chain(synth, monkeypatch):
    """A failed batched DP is retried chain by chain under keep_going
    (and propagates without it)."""
    from ahsoka_tpu_torch.pipeline import run_phase
    from ahsoka_tpu_torch.thread import dp_torch

    d, gfa, gaf = synth
    real = dp_torch.thread_chains_batched

    def flaky(dps, *a, **k):
        if len(dps) > 1:
            raise RuntimeError("injected batched DP failure")
        return real(dps, *a, **k)

    monkeypatch.setattr(dp_torch, "thread_chains_batched", flaky)
    with pytest.raises(RuntimeError, match="injected"):
        run_phase(gfa, gaf, str(d / "kg0"), BENCH, device="cpu")
    run_phase(gfa, gaf, str(d / "kg"), BENCH, device="cpu", keep_going=True)
    monkeypatch.setattr(dp_torch, "thread_chains_batched", real)
    run_phase(gfa, gaf, str(d / "ok"), BENCH, device="cpu")
    assert _read(str(d / "kg-result.txt")) == _read(str(d / "ok-result.txt"))


def test_banded_scoring_raises_not_implemented(synth):
    """Banded scoring is ported: chains above the threshold (every chain
    here) no longer raise NotImplementedError; they are scored banded
    and write the JAX package's result files."""
    from ahsoka_tpu.pipeline import run_phase as jax_run_phase
    from ahsoka_tpu_torch.pipeline import run_phase

    d, gfa, gaf = synth
    cfg = dataclasses.replace(BENCH, banded_scoring_threshold=8)
    jax_run_phase(gfa, gaf, str(d / "jaxbanded"), cfg)
    with _count_banded() as calls:
        run_phase(gfa, gaf, str(d / "banded"), cfg, device="cpu")
    assert len(calls) == 8
    _same_outputs(str(d / "banded"), str(d / "jaxbanded"))


@contextlib.contextmanager
def _count_banded():
    """Record each call of the port's banded scoring."""
    from ahsoka_tpu_torch.score import banded

    calls = []
    real = banded.score_pairs_banded

    def spy(matrix, *a, **k):
        calls.append(matrix.num_reads)
        return real(matrix, *a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(banded, "score_pairs_banded", spy)
        yield calls


def test_banded_chain_matches_jax_package(tmp_path):
    """The forced-banded diploid chain of tests/test_banded.py (threshold
    100): the same result file as the JAX package."""
    from util import simulate_diploid
    from ahsoka_tpu.pipeline import run_phase as jax_run_phase
    from ahsoka_tpu_torch.pipeline import run_phase

    glines, gaf, _hap_a, _hap_b = simulate_diploid(
        num_bubbles=40, reads_per_hap=120, span=4, error_rate=0.02)
    (tmp_path / "g.gfa").write_text("".join(glines))
    (tmp_path / "r.gaf").write_text("".join(gaf))
    cfg = dataclasses.replace(
        PhasingConfig(debug_readset_files=False),
        banded_scoring_threshold=100)
    args = (str(tmp_path / "g.gfa"), str(tmp_path / "r.gaf"))
    jax_run_phase(*args, str(tmp_path / "jax"), cfg)
    with _count_banded() as calls:
        run_phase(*args, str(tmp_path / "torch"), cfg, device="cpu")
    assert calls and max(calls) > 100
    _same_outputs(str(tmp_path / "torch"), str(tmp_path / "jax"))


def test_hexaploid_beam_matches_jax_package(tmp_path):
    """The hexaploid spec of tests/test_beam_dp.py (beam 512): the same
    result file as the JAX package, and the planted haplotypes
    recovered exactly."""
    from ahsoka_tpu.pipeline import run_phase as jax_run_phase
    from ahsoka_tpu.utils.accuracy import score_phased_output
    from ahsoka_tpu_torch.pipeline import run_phase

    gfa, gaf = str(tmp_path / "g.gfa"), str(tmp_path / "r.gaf")
    truth = str(tmp_path / "g.truth")
    write_synthetic(gfa, gaf, SynthSpec(num_chains=1, bubbles_per_chain=8,
                                        reads_per_hap=12, ploidy=6, span=4,
                                        error_rate=0.0), truth_path=truth)
    cfg = PhasingConfig(ploidy=6, dp_beam_width=512,
                        genotype_prior="balanced",
                        debug_readset_files=False)
    jax_run_phase(gfa, gaf, str(tmp_path / "jax"), cfg)
    art = run_phase(gfa, gaf, str(tmp_path / "torch"), cfg, device="cpu")
    _same_outputs(str(tmp_path / "torch"), str(tmp_path / "jax"))
    assert {c.ploidy for c in art.threading["configs"]} == {6}
    acc = score_phased_output(str(tmp_path / "torch"), truth)
    assert acc["phased_bubble_frac"] == 1.0
    assert acc["switch_err_vs_truth"] == 0.0
    assert acc["hamming_vs_truth"] == 0.0


def test_mixed_2_4_6_banded_matches_jax_package(tmp_path):
    """A small config5-shaped run: ploidy 2, 4 and 6 chains from the
    planted truth, the beam on the hexaploid chain and a forced banded
    threshold that sends the larger chains to banded scoring."""
    from ahsoka_tpu.graph.alleles import enumerate_allele_paths
    from ahsoka_tpu.pipeline import run_phase as jax_run_phase
    from ahsoka_tpu.utils.accuracy import ploidy_map_from_truth
    from ahsoka_tpu_torch.pipeline import load_graph_and_bubbles, run_phase

    gfa, gaf = str(tmp_path / "m.gfa"), str(tmp_path / "m.gaf")
    truth = str(tmp_path / "m.truth")
    write_synthetic(gfa, gaf, SynthSpec(
        chain_plan=[(10, 2), (8, 4), (6, 6)], span=3,
        coverage_per_hap=8.0, error_rate=0.02, seed=6), truth_path=truth)
    art = load_graph_and_bubbles(gfa, BENCH)
    pmap = ploidy_map_from_truth(
        enumerate_allele_paths(art.graph, art.index), truth)
    assert sorted(pmap.values()) == [2, 4, 6]
    cfg = dataclasses.replace(BENCH, ploidy_map=pmap, dp_beam_width=256,
                              genotype_prior="balanced",
                              banded_scoring_threshold=60)
    jax_run_phase(gfa, gaf, str(tmp_path / "jax"), cfg)
    with _count_banded() as calls:
        art = run_phase(gfa, gaf, str(tmp_path / "torch"), cfg,
                        device="cpu")
    _same_outputs(str(tmp_path / "torch"), str(tmp_path / "jax"))
    assert {c.ploidy for c in art.threading["configs"]} == {2, 4, 6}
    assert 0 < len(calls) < 3


def test_cli_profile_writes_trace(tmp_path):
    gaf = tmp_path / "golden_diploid.gaf"
    shutil.copy(os.path.join(DATA, "golden_diploid.gaf"), gaf)
    prof = tmp_path / "prof"
    assert cli_main(["phase", "-g", os.path.join(DATA, "golden_diploid.gfa"),
                     "-a", str(gaf), "-o", str(tmp_path / "o"), "--device",
                     "cpu", "--profile", str(prof)]) == 0
    with open(prof / "trace.json") as fh:
        assert "traceEvents" in json.load(fh)
    assert _read(str(tmp_path / "o-result.txt")) == \
        _golden("golden_diploid-result.txt")
