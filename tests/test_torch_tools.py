"""The port's study tools and end-to-end bench against the JAX package's
scripts, on the CPU at small sizes.

- ``scripts/bench_e2e.run_e2e`` of both packages on small synthetic
  inputs (ploidy 2, and a 2/4/6 mix with a ploidy map from the planted
  truth): the JAX row's keys and the port's extras, equal
  ``chains_phased`` and accuracy, byte-equal result files;
- ``quantify_fastpaths`` and ``profile_ce`` rows equal to the JAX
  scripts' on every field but the times (``seconds``, ``speedup``,
  ``ce_seconds``);
- ``plot_bubbles`` prints what ``scripts/plot_bubbles.py`` prints;
- every tool that touches a tensor defaults to ``cuda`` and raises
  without a card;
- chip_smoke.py's rule for study clusters that differ between the card
  and the CPU."""

import glob
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")


def _jax_script(name):
    """scripts/<name>.py of the JAX package as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax_script(name, argv, cwd):
    """The JAX script in a fresh process on the CPU -> its JSON rows."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, os.path.join(REPO, "scripts",
                                                       f"{name}.py")] + argv,
                         cwd=cwd, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]


def _without(rows, keys):
    return [{k: v for k, v in r.items() if k not in keys} for r in rows]


def test_quantify_fastpaths_rows_match_jax(tmp_path):
    from ahsoka_tpu_torch.scripts import quantify_fastpaths as qf

    argv = ["--reads", "300", "--bubbles", "100", "--regimes", "baseline"]
    want = _run_jax_script("quantify_fastpaths", argv, tmp_path)
    rows, details = qf.study(reads=(300,), bubbles=100,
                             regimes=("baseline",), device="cpu",
                             workdir=str(tmp_path / "port"))
    assert len(rows) == len(want) == 8
    assert _without(rows, ("seconds", "speedup")) == \
        _without(want, ("seconds", "speedup"))
    (d,) = details
    assert set(d["clusters"]) == {r["path"] for r in rows}


def test_profile_ce_rows_match_jax(tmp_path):
    from ahsoka_tpu_torch.scripts import profile_ce

    want = _run_jax_script("profile_ce", ["--reads", "300", "--bubbles",
                                          "50"], tmp_path)
    rows, details = profile_ce.profile(reads=(300,), bubbles=50,
                                       device="cpu",
                                       workdir=str(tmp_path / "port"))
    assert len(rows) == len(want) == 6
    assert _without(rows, ("ce_seconds",)) == _without(want, ("ce_seconds",))
    (d,) = details
    assert d["scores"].shape == (d["matrix"].num_reads,) * 2


def test_quantify_fastpaths_main_prints_rows(tmp_path, capsys):
    from ahsoka_tpu_torch.scripts import quantify_fastpaths as qf

    assert qf.main(["--reads", "200", "--bubbles", "60", "--regimes",
                    "low-overlap", "--device", "cpu", "--markdown",
                    "--workdir", str(tmp_path)]) == 0
    out = capsys.readouterr().out.splitlines()
    rows = [json.loads(line) for line in out if line.startswith("{")]
    assert [r["path"] for r in rows][:2] == ["exact", "collapsed"]
    assert sum(line.startswith("| low-overlap |") for line in out) == 8


def _bubbleinfo(tmp_path):
    """The port's only-bubbles on golden_diploid and on a three-chain
    synthetic graph -> their -bubbleinfo.txt files."""
    from ahsoka_tpu_torch.pipeline import run_only_bubbles
    from ahsoka_tpu_torch.utils.synth import SynthSpec, write_synthetic

    run_only_bubbles(os.path.join(DATA, "golden_diploid.gfa"),
                     str(tmp_path / "g"))
    gfa = str(tmp_path / "s.gfa")
    write_synthetic(gfa, str(tmp_path / "s.gaf"),
                    SynthSpec(chain_plan=[(7, 2), (30, 2), (12, 4)],
                              span=3, coverage_per_hap=2.0, seed=1))
    run_only_bubbles(gfa, str(tmp_path / "s"))
    return [str(tmp_path / "g-bubbleinfo.txt"),
            str(tmp_path / "s-bubbleinfo.txt")]


def test_plot_bubbles_prints_what_the_jax_script_prints(tmp_path, capsys):
    from ahsoka_tpu_torch.scripts import plot_bubbles

    jax_plot = _jax_script("plot_bubbles")
    for path in _bubbleinfo(tmp_path):
        assert jax_plot.main([path]) == 0
        want = capsys.readouterr().out
        assert plot_bubbles.main([path]) == 0
        got = capsys.readouterr().out
        assert got == want and got.startswith("chains: ")
    empty = tmp_path / "empty.txt"
    empty.write_text("")
    assert plot_bubbles.main([str(empty)]) == jax_plot.main([str(empty)]) == 1


def _inputs(tmp_path, spec):
    from ahsoka_tpu_torch.utils.synth import write_synthetic

    gfa, gaf, truth = (str(tmp_path / f"in.{x}") for x in
                       ("gfa", "gaf", "truth"))
    write_synthetic(gfa, gaf, spec, truth_path=truth)
    return gfa, gaf, truth


def _ploidy_map(gfa, truth):
    """The engine-chain -> ploidy map from the planted truth, by both
    packages (equal)."""
    from ahsoka_tpu.config import PhasingConfig as JaxConfig
    from ahsoka_tpu.graph.alleles import enumerate_allele_paths as jax_paths
    from ahsoka_tpu.pipeline import load_graph_and_bubbles as jax_load
    from ahsoka_tpu.utils.accuracy import ploidy_map_from_truth as jax_pmap
    from ahsoka_tpu_torch.config import PhasingConfig
    from ahsoka_tpu_torch.graph.alleles import enumerate_allele_paths
    from ahsoka_tpu_torch.pipeline import load_graph_and_bubbles
    from ahsoka_tpu_torch.utils.accuracy import ploidy_map_from_truth

    art = load_graph_and_bubbles(gfa, PhasingConfig())
    pmap = ploidy_map_from_truth(enumerate_allele_paths(art.graph,
                                                        art.index), truth)
    jart = jax_load(gfa, JaxConfig())
    assert jax_pmap(jax_paths(jart.graph, jart.index), truth) == pmap
    return pmap


def _result_files(stem):
    return sorted(os.path.basename(p)[len(os.path.basename(stem)):]
                  for p in glob.glob(f"{stem}-*result.txt"))


@pytest.mark.parametrize("mix", ["diploid", "mixed_2_4_6"])
def test_run_e2e_matches_jax(tmp_path, mix):
    from ahsoka_tpu_torch.scripts import bench_e2e
    from ahsoka_tpu_torch.utils.synth import SynthSpec

    jax_e2e = _jax_script("bench_e2e")
    if mix == "diploid":
        spec = SynthSpec(num_chains=3, bubbles_per_chain=20,
                         reads_per_hap=60, span=3, error_rate=0.02, seed=3)
        gfa, gaf, truth = _inputs(tmp_path, spec)
        kw = dict(ploidy=2, truth=truth)
    else:
        spec = SynthSpec(chain_plan=[(20, 2), (12, 4), (6, 6)], span=6,
                         coverage_per_hap=8.0, error_rate=0.02, seed=5)
        gfa, gaf, truth = _inputs(tmp_path, spec)
        kw = dict(ploidy=2, truth=truth,
                  ploidy_map=_ploidy_map(gfa, truth))
        assert sorted(set(kw["ploidy_map"].values())) == [2, 4, 6]
    want = jax_e2e.run_e2e(gfa, gaf, str(tmp_path / "jax"), threads=1,
                           backend="jax", **kw)
    got = bench_e2e.run_e2e(gfa, gaf, str(tmp_path / "port"), threads=1,
                            backend="jax", device="cpu", **kw)
    assert set(got) == set(want) | set(bench_e2e.EXTRA_KEYS)
    assert got["chains_phased"] == want["chains_phased"] == len(spec.plan())
    assert got["chains_failed"] == want["chains_failed"] == 0
    assert got["accuracy_vs_planted_truth"] == \
        want["accuracy_vs_planted_truth"]
    assert got["gaf_records"] == want["gaf_records"]
    assert got["peak_device_bytes"] is None and got["gpu"] is None
    assert got["peak_host_rss_bytes"] > 0 and got["device_warmup"] >= 0
    names = _result_files(str(tmp_path / "jax"))
    assert names == _result_files(str(tmp_path / "port"))
    assert len(names) == len(spec.plan()) + 1
    for n in names:
        with open(tmp_path / f"jax{n}", "rb") as a, \
                open(tmp_path / f"port{n}", "rb") as b:
            assert a.read() == b.read(), n


def test_bench_e2e_main_config_resume(tmp_path, capsys, monkeypatch):
    """``main`` on a config: inputs generated into the workdir, the row
    printed; ``--resume`` keeps the chain files and phases none again."""
    from ahsoka_tpu_torch.scripts import bench_e2e
    from ahsoka_tpu_torch.utils import synth

    monkeypatch.setitem(synth.CONFIGS, "bench", synth.SynthSpec(
        num_chains=2, bubbles_per_chain=12, reads_per_hap=30, span=3,
        error_rate=0.02, seed=2))
    argv = ["--config", "bench", "--device", "cpu", "--threads", "1",
            "--workdir", str(tmp_path)]
    assert bench_e2e.main(argv) == 0
    row = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert (row["config"], row["backend"], row["chains_phased"]) == \
        ("bench", "jax", 2)
    assert os.path.exists(tmp_path / "bench.truth")
    assert len(glob.glob(str(tmp_path / "bench" / "run-chain*-result.txt"))) \
        == 2
    assert bench_e2e.main(argv + ["--resume"]) == 0
    again = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert again["accuracy_vs_planted_truth"] == \
        row["accuracy_vs_planted_truth"]
    with open(tmp_path / "bench" / "run-metrics.json") as fh:
        assert all(c["resumed"] for c in json.load(fh)["chains"])


def test_tools_default_to_cuda_and_raise_without_card(tmp_path,
                                                      monkeypatch):
    from ahsoka_tpu_torch import bench
    from ahsoka_tpu_torch.scripts import (bench_e2e, profile_ce,
                                          quantify_fastpaths, roofline)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [lambda: bench.run(quick=True),
             lambda: bench.main(["--quick"]),
             lambda: roofline.run(quick=True),
             lambda: bench_e2e.main(["--config", "config5", "--workdir",
                                     str(tmp_path)]),
             lambda: quantify_fastpaths.study(reads=(200,), bubbles=50,
                                              workdir=str(tmp_path)),
             lambda: profile_ce.profile(reads=(200,),
                                        workdir=str(tmp_path))]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    # nothing was generated before the device resolved
    assert os.listdir(tmp_path) == []


def test_smoke_study_rule(tmp_path):
    """chip_smoke.py's comparison of a study tool's clusters on the card
    and on the CPU: equal passes; a difference over equal matrices and
    equal scores is a near-tie (recorded); over different matrices it
    raises."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from ahsoka_tpu_torch.scripts import profile_ce

    _rows, (d,) = profile_ce.profile(reads=(200,), bubbles=20,
                                     skip_sparse=True, device="cpu",
                                     workdir=str(tmp_path))
    assert chip_smoke._study_vs_cpu("profile_ce", [d], [d], "cpu") == []
    other = dict(d, clusters=dict(d["clusters"],
                                  dense=np.zeros_like(d["clusters"]["dense"])))
    (why,) = chip_smoke._study_vs_cpu("profile_ce", [other], [d], "cpu")
    assert why["variants"] == ["dense"] and why["scores_within_1e-4"]
    m = d["matrix"]
    flipped = type(m)(alleles=np.where(m.alleles >= 0, 1 - m.alleles,
                                       m.alleles).astype(m.alleles.dtype),
                      positions=m.positions, read_names=m.read_names)
    with pytest.raises(AssertionError, match="unexplained"):
        chip_smoke._study_vs_cpu("profile_ce", [dict(other, matrix=flipped)],
                                 [d], "cpu")
