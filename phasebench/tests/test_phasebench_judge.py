"""The comparison that decides ``correct``, on one tiny job on the CPU:
the program's outputs pass, the control (the reference with TF32 score
GEMMs) and the program with its timed path broken do not."""

import os

import numpy as np
import pytest

from phasebench import judge, run
from phasebench.jobs import make_pool
from phasebench.reference import phase as R
from phasebench.reference.config import PhasingConfig as RefConfig
from phasebench.tests.tiny import tiny_cell

SEED = 2 ** 31 + 977


def _run(cell, trace=False, workers=1, **kw):
    # a window longer than the pool lasts: every run phases all its jobs
    return run.run_cell(cell, SEED, 600.0, trace, device="cpu",
                        workers=workers, **kw)


@pytest.mark.parametrize("name", ["chr20-diploid.slices",
                                  "tetraploid.chains200"])
@pytest.mark.parametrize("trace", [False, True])
def test_program_outputs_pass_on_a_tiny_job(trace, name):
    cell = tiny_cell(name)
    r = _run(cell, trace)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] == 9
    assert r["checks"]["score_gap"]["value"] <= \
        r["checks"]["score_gap"]["limit"]
    # a CPU run carries no device number
    if trace:
        if name == "chr20-diploid.slices":
            # its rate is per-layer there, moving the device peak
            assert set(r["metrics"]) == {"window.records_per_s"}
        else:
            assert {"pipeline.parse_s", "job_s_p95"} <= set(r["metrics"])
            assert "window.records_per_s" not in r["metrics"]
        assert not any(k.startswith(("kernels.", "device."))
                       for k in r["metrics"])
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(r["metrics"]) == set(run.end_to_end(cell)) - {
            "peak_device_gib"}
    assert r["device"]["platform"] == "cpu"
    assert list(r)[-1] == "checks"


def test_the_measurement_path_refuses_to_run_without_a_card(monkeypatch,
                                                            capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "chr20-diploid.slices", "--seed", "1",
                   "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out.strip() == ""
    assert "CUDA" in out.err


def _altered_paths(orig):
    from phasebench.readings import altered_paths
    return altered_paths(orig)


def _scaled_scores(orig):
    def wrapped(*a, **kw):
        return [s * (1 + 1e-3) for s in orig(*a, **kw)]
    return wrapped


def _half_the_chains(orig):
    def wrapped(chain_id, *a, **kw):
        if chain_id % 2:
            return None          # the chain is dropped, as if it had no read
        return orig(chain_id, *a, **kw)
    return wrapped


def _unchanged_state(orig):
    def wrapped(weights, *a, **kw):
        return [[i] for i in range(weights.shape[0])]
    return wrapped


@pytest.mark.parametrize("module,name,fault,caught", [
    ("ahsoka_tpu_torch.thread.dp_torch", "thread_chains_batched",
     _altered_paths, "dp_cost_gap"),
    ("ahsoka_tpu_torch.score.device", "score_pairs_device_many",
     _scaled_scores, "score_gap"),
    ("ahsoka_tpu_torch.phase", "_chain_matrix_stage", _half_the_chains,
     "chains_unphased"),
    ("ahsoka_tpu_torch.phase", "cluster_editing", _unchanged_state,
     "cluster_diff"),
])
def test_a_broken_timed_path_is_not_correct(monkeypatch, module, name,
                                            fault, caught):
    import importlib
    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, name, fault(getattr(mod, name)))
    r = _run(tiny_cell())
    assert not r["correct"]
    c = r["checks"][caught]
    assert c["value"] > c["limit"], r["checks"]


def test_the_checks_in_worker_processes_match_the_serial_ones():
    one = _run(tiny_cell(), workers=1)
    two = _run(tiny_cell(), workers=2)
    assert one["correct"] and two["correct"]
    assert one["checks"] == two["checks"]


def test_a_job_outside_the_sample_is_held_to_the_chain_order(monkeypatch):
    """Only the window's first job is sampled; a later job whose
    ``-result.txt`` lists two chains the other way round is caught."""
    from ahsoka_tpu_torch import pipeline
    orig = pipeline.run_phase

    def swapped(gfa, gaf, outstem, *a, **kw):
        art = orig(gfa, gaf, outstem, *a, **kw)
        if f"{os.sep}job0{os.sep}" not in outstem:
            path = f"{outstem}-result.txt"
            with open(path) as fh:
                parts = fh.read().split("chain id: ")
            parts[1], parts[2] = parts[2], parts[1]
            with open(path, "w") as fh:
                fh.write("chain id: ".join(parts))
        return art

    monkeypatch.setattr(pipeline, "run_phase", swapped)
    cell = tiny_cell()
    cell["check"] = dict(jobs=1, first_jobs=3, chains=2)
    r = _run(cell)
    assert not r["correct"]
    assert r["checks"]["files_diff"]["value"] >= 2, r["checks"]


@pytest.mark.parametrize("name", ["chr20-diploid.slices",
                                  "tetraploid.chains200"])
def test_the_control_fails_and_the_reference_passes(tmp_path, name):
    cell = tiny_cell(name)
    cell["shape"].update(num_chains=2)
    if cell["shape"]["ploidy"] == 4:
        # enough reads a chain that the chain collapses, as at full size
        cell["shape"].update(bubbles_per_chain=20, reads_per_hap=120)
    cfg = RefConfig(**dict(cell["config"]["settings"], threads=1))
    (gfa, gaf), = make_pool(cell["shape"], SEED, [0], str(tmp_path), 1)
    job = R.load_job(gfa, gaf, cfg)
    ids = [cid for _s, cid in job.size_sorting]
    limits = cell["limits"]
    ref = judge.judge_job(job, judge.from_reference(job, ids, cfg,
                                                    "float64"), ids, cfg)
    assert judge.verdict(ref, limits), ref
    assert ref["score_gap"] == 0.0
    control = judge.judge_job(
        job, judge.from_reference(job, ids, cfg, "tf32"), ids, cfg)
    assert control["score_gap"] > 3 * limits["score_gap"], control
    assert not judge.verdict(control, limits)


def test_the_torch_solver_takes_the_numpy_solver_steps(tmp_path):
    import torch

    from phasebench.reference.editing import cluster_editing
    cell = tiny_cell()
    cfg = RefConfig(**dict(cell["config"]["settings"], threads=1))
    (gfa, gaf), = make_pool(cell["shape"], SEED, [1], str(tmp_path), 1)
    job = R.load_job(gfa, gaf, cfg)
    for _s, cid in job.size_sorting:
        m = R.chain_matrix(job, cid, cfg)
        cm = R.chain_collapse(m, cfg)
        w = R.solver_weights(R.chain_scores(m, cm, cfg), cm)
        assert cluster_editing(w) == cluster_editing(
            w, device=torch.device("cpu"))


@pytest.mark.parametrize("seed,ties", [(1, False), (2, True), (3, True),
                                        (4, False)])
def test_the_torch_solver_matches_on_random_weights(seed, ties):
    """Signed weights, with many exact ties where ``ties``: the torch
    steps (one read back a step) decide as the numpy steps do."""
    import torch

    from phasebench.reference.editing import cluster_editing
    rng = np.random.default_rng(seed)
    n = 40
    w = rng.integers(-3, 4, (n, n)).astype(np.float64) if ties \
        else rng.normal(size=(n, n))
    w[rng.random((n, n)) < 0.3] = 0.0
    w = np.triu(w, 1)
    w = w + w.T
    assert cluster_editing(w) == cluster_editing(
        w, device=torch.device("cpu"))


@pytest.mark.gpu
def test_a_short_run_on_the_card_is_correct():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    # the tetraploid cell: the device's per-layer metrics are read there
    r = run.run_cell(tiny_cell("tetraploid.chains200"), SEED, 0.5, True,
                     device="cuda", workers=2)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
    assert "device.idle_share" in r["metrics"]
