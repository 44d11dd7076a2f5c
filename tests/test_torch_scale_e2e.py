"""config4s and the full config3c through the JAX package and the port on
the CPU, at the bench settings (``scripts/bench_e2e.py``: no readset
debug files, coverage cap 64, the balanced prior above ploidy 2) with 2
host threads: the aggregate result and every chain file byte-equal, and
the same accuracy against the planted truth.

config4s is config4's chains at 1/10 of its count (100 chains x 50
bubbles, 100k GAF records); config3c is 20 tetraploid chains x 200
bubbles (42,720 records), the general DP group of the chip smoke."""

import glob
import importlib.util
import os

import pytest
import torch

from ahsoka_tpu_torch.scripts import bench_e2e
from ahsoka_tpu_torch.utils.synth import CONFIGS, write_synthetic

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_bench_e2e():
    spec = importlib.util.spec_from_file_location(
        "jax_script_bench_e2e", os.path.join(REPO, "scripts", "bench_e2e.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("config", ["config4s", "config3c"])
def test_scale_config_byte_equal_to_jax(tmp_path, config):
    spec = CONFIGS[config]
    gfa, gaf, truth = (str(tmp_path / f"{config}.{x}")
                       for x in ("gfa", "gaf", "truth"))
    write_synthetic(gfa, gaf, spec, truth_path=truth)
    kw = dict(ploidy=spec.ploidy, max_coverage=64, threads=2, truth=truth,
              backend="jax")
    want = _jax_bench_e2e().run_e2e(gfa, gaf, str(tmp_path / "jax"), **kw)
    got = bench_e2e.run_e2e(gfa, gaf, str(tmp_path / "port"), device="cpu",
                            **kw)
    assert got["chains_phased"] == want["chains_phased"] == spec.num_chains
    assert got["chains_failed"] == want["chains_failed"] == 0
    assert got["accuracy_vs_planted_truth"] == \
        want["accuracy_vs_planted_truth"]
    jax_files = sorted(glob.glob(str(tmp_path / "jax-*result.txt")))
    assert len(jax_files) == spec.num_chains + 1
    for path in jax_files:
        suffix = os.path.basename(path)[len("jax"):]
        with open(path, "rb") as a, \
                open(tmp_path / f"port{suffix}", "rb") as b:
            assert a.read() == b.read(), suffix
    assert len(glob.glob(str(tmp_path / "port-*result.txt"))) == \
        len(jax_files)
