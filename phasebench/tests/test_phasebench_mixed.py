"""Plan-shaped jobs, planted ploidy maps and the judge of a ragged
mixed-ploidy job (beam chains, banded chains), on the CPU; and the
existing cells' job pools, held to digests pinned before plans existed."""

import functools
import hashlib
import json
import os
import time

import numpy as np
import pytest
import torch

from phasebench import judge, run
from phasebench.jobs import (job_spec, make_pool, ploidy_map_path,
                             read_ploidy_map, truth_path)
from phasebench.reference import phase as R
from phasebench.reference.config import PhasingConfig as RefConfig
from phasebench.synth import chain_plan
from phasebench.tests.mixed import TINY_SEED, tiny_mixed_cell

SEED = 2 ** 31 + 977

# sha256 of (GFA, GAF) of the warm-up job (-1) and job 0 of each cell at
# SEED, from the harness before chain plans were added
PINNED = {
    ("chr20-diploid.slices", -1): (
        "5d0051be2d096be23db99684bc7581881dca8a8a6f51c23b39bafdb96bd7fa7e",
        "664888f71b199c2c6cf4aefabb5ed05f578897dc72464b8adcce1a960f8dd389"),
    ("chr20-diploid.slices", 0): (
        "5d0051be2d096be23db99684bc7581881dca8a8a6f51c23b39bafdb96bd7fa7e",
        "24f3563332cbf57811f0183493c841eb02849c1afa7033460bf800bcde441e07"),
    ("tetraploid.chains200", -1): (
        "98b27d13e23d0b60380393de12f94b6e0a7b859c8adbafd4e9160cdceee668c5",
        "977c158c27f8cf9225c68052fc09d99669b77f487fef921cbd50206cd886fa98"),
    ("tetraploid.chains200", 0): (
        "98b27d13e23d0b60380393de12f94b6e0a7b859c8adbafd4e9160cdceee668c5",
        "8440adf2fb4d676bdf6e7429f1e107c3ea68711660c96fc6056da3aa7e7273dc"),
}


def _sha(path):
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


@pytest.mark.parametrize("name,index", sorted(PINNED))
def test_existing_cells_make_the_pinned_jobs(tmp_path, name, index):
    cell = run.load_cell(name)
    (gfa, gaf), = make_pool(cell["shape"], SEED, [index], str(tmp_path), 1)
    assert (_sha(gfa), _sha(gaf)) == PINNED[(name, index)]
    assert not os.path.exists(truth_path(gfa))
    assert not os.path.exists(ploidy_map_path(gfa))


def test_plan_shaped_jobs_are_deterministic(tmp_path):
    cell = tiny_mixed_cell()
    shape = cell["shape"]
    a = make_pool(shape, SEED, [0, 1], str(tmp_path / "a"), 1)
    b = make_pool(shape, SEED, [0, 1], str(tmp_path / "b"), 2)
    for (ga, fa), (gb, fb) in zip(a, b):
        for x, y in ((ga, gb), (fa, fb), (truth_path(ga), truth_path(gb))):
            assert _sha(x) == _sha(y)
    assert _sha(a[0][1]) != _sha(a[1][1])
    spec = job_spec(shape, SEED, 0)
    plan = shape["plan"]
    assert spec.plan() == chain_plan(
        plan["num_chains"], plan["min_bubbles"], plan["max_bubbles"],
        plan["ploidy_mix"], spec.seed)
    assert spec.span == 6 and spec.coverage_per_hap == 8.0


def test_a_workload_overrides_the_plan_as_it_overrides_shape_keys():
    from phasebench.tests.mixed import mixed_cell
    cell = mixed_cell()
    config = cell["config"]
    over = run.make_cell(dict(cell, job={"num_chains": 7, "span": 5}),
                         config)
    assert over["shape"]["plan"]["num_chains"] == 7
    assert over["shape"]["span"] == 5
    assert config["plan"]["num_chains"] == 40


def test_the_planted_map_is_the_generators_plan(tmp_path):
    cell = tiny_mixed_cell()
    settings = dict(cell["config"]["settings"], threads=1)
    (gfa, _gaf), = make_pool(cell["shape"], TINY_SEED, [0], str(tmp_path),
                             1, planted=settings)
    pmap = read_ploidy_map(ploidy_map_path(gfa))
    job = R.load_job(gfa, None, RefConfig(**settings))
    plan = job_spec(cell["shape"], TINY_SEED, 0).plan()
    assert sorted(pmap) == sorted(job.allele_paths)
    assert sorted((len(job.allele_paths[c]), k) for c, k in pmap.items()) \
        == sorted(plan)
    assert {k for _nb, k in plan} == {2, 4, 6}


def _run(cell, seed=TINY_SEED, device="cpu"):
    torch.set_num_threads(1)
    return run.run_cell(cell, seed, 600.0 if device == "cpu" else 1.0,
                        False, device=device,
                        workers=1 if device == "cpu" else None)


def _reference_parts(log: str) -> dict:
    """The reference's seconds by kind of step, from a run's log."""
    line, = [x for x in log.splitlines() if x.startswith("reference: ")]
    return json.loads(line.split("in this process: ", 1)[1])


def test_the_tiny_mixed_cell_is_correct(capsys):
    """Ploidy 2, 4 and 6 by a planted map, the beam at ploidy 6, one
    chain banded: every check holds; the banded chain's clusters are
    counted unchecked."""
    r = _run(tiny_mixed_cell())
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] == 4
    assert r["unchecked"] == {"chains_solver_unchecked": 1}
    assert r["checks"]["edges_diff"] == {"value": 0, "limit": 0}
    parts = _reference_parts(capsys.readouterr().out)
    assert {"solver", "band", "beam"} <= set(parts)
    assert list(r)[-1] == "checks"


# the fault wrappers carry the original's attributes (``functools.wraps``):
# the program counts its CUDA launches on them (``thread_beam.launches``)
def _middle_state_zero(orig):
    @functools.wraps(orig)
    def wrapped(*a, **kw):
        states = orig(*a, **kw).clone()
        states[:, states.shape[1] // 2] = 0
        return states
    return wrapped


def _narrow_beam(width):
    def fault(orig):
        @functools.wraps(orig)
        def wrapped(*a, **kw):
            return orig(*a, **dict(kw, beam_width=min(width,
                                                      kw["beam_width"])))
        return wrapped
    return fault


def _ties_reversed(orig):
    """The prune keeping the highest state index on ties, not the
    lowest."""
    @functools.wraps(orig)
    def prune(cost, B):
        S = cost.shape[1]
        vals, idx = torch.sort(cost.flip(1), dim=1, stable=True)
        return vals[:, :B].contiguous(), (S - 1 - idx[:, :B]).contiguous()
    return prune


# a fault in the program's beam: the name in ``thread/dp_beam.py`` it
# replaces, and the wrapper of the original
BEAM_FAULTS = {
    "middle state zero": ("thread_beam", _middle_state_zero),
    "beam 2": ("thread_beam", _narrow_beam(2)),
    "beam 64": ("thread_beam", _narrow_beam(64)),
    "ties reversed": ("_prune", _ties_reversed),
}


def _plant(monkeypatch, fault):
    from ahsoka_tpu_torch.thread import dp_beam
    name, wrap = BEAM_FAULTS[fault]
    monkeypatch.setattr(dp_beam, name, wrap(getattr(dp_beam, name)))


@pytest.mark.parametrize("fault", ["middle state zero", "beam 2"])
def test_an_altered_beam_path_is_not_correct(monkeypatch, fault):
    _plant(monkeypatch, fault)
    r = _run(tiny_mixed_cell())
    assert not r["correct"]
    c = r["checks"]["dp_cost_gap"]
    assert c["value"] > c["limit"], r["checks"]


BAND_FAULTS = {
    # (u, v, w) -> the altered edge list, and the number that catches it
    "scaled": (lambda u, v, w: (u, v, w * (1 + 1e-3)), "score_gap"),
    "a third dropped": (lambda u, v, w: (u[::3], v[::3], w[::3]),
                        "score_gap"),
    "a block pair skipped": (
        lambda u, v, w: [x[(u // 64 == v // 64)] for x in (u, v, w)],
        "score_gap"),
    "listed twice": (lambda u, v, w: (np.r_[u, u[:5]], np.r_[v, v[:5]],
                                      np.r_[w, w[:5]]), "edges_diff"),
    "swapped": (lambda u, v, w: (v, u, w), "edges_diff"),
}


@pytest.mark.parametrize("fault", sorted(BAND_FAULTS))
def test_altered_band_scores_are_not_correct(monkeypatch, fault):
    from ahsoka_tpu_torch.score import banded
    orig = banded.score_pairs_banded
    alter, caught = BAND_FAULTS[fault]

    def altered(*a, **kw):
        return alter(*orig(*a, **kw))
    monkeypatch.setattr(banded, "score_pairs_banded", altered)
    r = _run(tiny_mixed_cell())
    assert not r["correct"]
    c = r["checks"][caught]
    assert c["value"] > c["limit"], r["checks"]


def test_band_gaps_take_every_pair_of_either_list():
    want = (np.array([0, 0, 1, 2]), np.array([1, 3, 2, 3]),
            np.array([5.0, -0.5, 2.0, 1e-15]))
    assert judge.band_gaps(want, want, 4) == (0, 0.0)
    # the tiny pair left out, one pair moved by 1e-6 of its score
    got = (want[0][:3], want[1][:3], want[2][:3] * [1, 1, 1 + 1e-6])
    bad, gap = judge.band_gaps(got, want, 4)
    assert bad == 0 and gap == pytest.approx(1e-6)
    # a pair left out reads its whole score; a pair the band lacks, its own
    assert judge.band_gaps([x[1:] for x in want], want, 4)[1] == 1.0
    extra = [np.r_[x, y] for x, y in zip(want, ([1], [3], [0.25]))]
    assert judge.band_gaps(extra, want, 4) == (0, 0.25)
    # no edge: u >= v, a row outside the chain, a pair twice
    bad = [np.r_[x, y] for x, y in zip(want, ([3, 1, 0], [3, 4, 1],
                                               [1.0, 1.0, 5.0]))]
    assert judge.band_gaps(bad, want, 4) == (3, 0.0)
    assert judge.band_gaps(want, (np.zeros(0, int),) * 2 + (np.zeros(0),),
                           4) == (0, 5.0)


def test_the_batched_driver_scores_every_chain_at_the_global_ploidy(
        tmp_path):
    """The program's dense scores of a chain mapped to ploidy 4 are the
    reference's at the global ploidy 2, not at the chain's own."""
    import dataclasses

    from ahsoka_tpu_torch.config import PhasingConfig
    from ahsoka_tpu_torch.pipeline import run_phase

    from phasebench.capture import Capture
    torch.set_num_threads(1)
    cell = tiny_mixed_cell()
    settings = dict(cell["config"]["settings"], threads=1)
    (gfa, gaf), = make_pool(cell["shape"], TINY_SEED, [0], str(tmp_path),
                            1, planted=settings)
    pmap = read_ploidy_map(ploidy_map_path(gfa))
    cap = Capture()
    cap.install()
    try:
        cap.start(True)
        run_phase(gfa, gaf, str(tmp_path / "out"), device="cpu",
                  config=dataclasses.replace(PhasingConfig(**settings),
                                             ploidy_map=pmap))
    finally:
        cap.uninstall()
    rcfg = RefConfig(**dict(settings, ploidy_map=pmap))
    job = R.load_job(gfa, gaf, rcfg)
    seen = 0
    for cid, k in pmap.items():
        rec = cap.chains[cid]
        if k == 2 or rec.banded:
            continue
        ccfg = R.chain_config(rcfg, cid)
        m = R.chain_matrix(job, cid, ccfg)
        cm = R.chain_collapse(m, ccfg)
        at_global = R.chain_scores(m, cm, rcfg)
        at_own = R.chain_scores(m, cm, ccfg)
        assert judge.score_gap(rec.scores, at_global) < 1e-4
        assert judge.score_gap(rec.scores, at_own) > 1e-2
        seen += 1
    assert seen


def _job0(cell, seed, work):
    """Job 0 of ``seed`` with its planted map, its reference config and
    the chains a run samples of it."""
    settings = dict(cell["config"]["settings"], threads=1)
    (gfa, gaf), = make_pool(cell["shape"], seed, [0], str(work), 1,
                            planted=settings)
    cfg = RefConfig(**dict(settings,
                           ploidy_map=read_ploidy_map(ploidy_map_path(gfa))))
    job = R.load_job(gfa, gaf, cfg)
    return job, cfg, judge.sample_chains(job.size_sorting, seed,
                                         cell["check"]["chains"])


def _banded_ids(job, cfg, ids):
    out = []
    for cid in ids:
        ccfg = R.chain_config(cfg, cid)
        m = R.chain_matrix(job, cid, ccfg)
        if R.is_banded(m, R.chain_collapse(m, ccfg), ccfg):
            out.append(cid)
    return out


def test_the_control_of_a_mixed_job_fails_and_the_reference_passes(
        tmp_path):
    cell = tiny_mixed_cell()
    job, cfg, ids = _job0(cell, TINY_SEED, tmp_path)
    limits = cell["limits"]
    ref = judge.judge_job(job, judge.from_reference(job, ids, cfg,
                                                    "float64"), ids, cfg)
    assert judge.verdict(ref, limits), ref
    assert ref["score_gap"] == 0.0 and ref["dp_cost_gap"] == 0.0
    assert ref["chains_solver_unchecked"] == 1
    control = judge.judge_job(
        job, judge.from_reference(job, ids, cfg, "tf32"), ids, cfg)
    assert control["score_gap"] > 3 * limits["score_gap"], control
    assert not judge.verdict(control, limits)
    # the banded chain's control (its band at TF32, its rows one
    # cluster) fails on its own
    band, = _banded_ids(job, cfg, ids)
    alone = judge.judge_job(
        job, judge.from_reference(job, [band], cfg, "tf32"), [band], cfg)
    assert alone["score_gap"] > 3 * limits["score_gap"], alone
    assert not judge.verdict(alone, limits)


# the test-local config5-shaped cell on a card: a seed whose run samples
# a banded chain (9,460 rows), and three seeds for the control
CARD_SEED = 2147484817
CONTROL_SEEDS = (2147484965, 2147484662, 2147484817)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("fault,correct", [(None, True),
                                           ("beam 64", False),
                                           ("ties reversed", True)])
def test_the_mixed_cell_on_the_card(monkeypatch, capsys, fault, correct):
    """40 chains of config5's plan through ``run_cell``: correct, and a
    beam cut to 64 states not.  Reversed ties keep a path of the same
    cost, which the judge accepts by design.  Prints the reading: every
    check number, the beam chains' ``dp_cost_gap``, the program's job
    seconds and the reference's by kind."""
    from phasebench.tests.mixed import mixed_cell
    _card()
    if fault:
        _plant(monkeypatch, fault)
    beams = []
    orig = judge.finish_chain

    def finish(p, device=None):
        n = orig(p, device)
        if p.kind == "beam":
            beams.append((p.dp.num_positions, n["dp_cost_gap"]))
        return n
    monkeypatch.setattr(judge, "finish_chain", finish)
    r = _run(mixed_cell(), CARD_SEED, "cuda")
    log = capsys.readouterr().out
    jobs, = [json.loads(x.split(": ", 1)[1]) for x in log.splitlines()
             if x.startswith("job seconds: ")]
    with capsys.disabled():
        print(json.dumps(dict(
            seed=CARD_SEED, fault=fault, correct=r["correct"],
            checks={k: c["value"] for k, c in r["checks"].items()},
            unchecked=r["unchecked"], beam_chains=beams, job_seconds=jobs,
            reference_parts=_reference_parts(log),
            peak_bytes=r["device"]["memory_peak_bytes"],
            card=r["device"]["kind"])))
    assert r["correct"] == correct, r["checks"]
    assert r["failed"] == 0 and beams
    if fault is None:
        assert r["unchecked"]["chains_solver_unchecked"] >= 1


@pytest.mark.gpu
@pytest.mark.parametrize("seed", CONTROL_SEEDS)
def test_the_control_of_the_mixed_cell_fails_on_the_card(tmp_path, seed):
    """The plain reference with TF32 score GEMMs in the program's place
    on the chains a run of ``seed`` samples of job 0, judged as a run
    judges them, reads incorrect; and so does each banded chain's
    control alone.  Prints the numbers and the seconds by kind."""
    from phasebench.tests.mixed import mixed_cell
    dev = _card()
    cell = mixed_cell()
    job, cfg, ids = _job0(cell, seed, tmp_path)
    limits = cell["limits"]
    reading = dict(seed=seed, chains=ids)
    for name, chains in (("sample", ids),
                         *((f"banded {c}", [c])
                           for c in _banded_ids(job, cfg, ids))):
        t = time.perf_counter()
        produced = judge.from_reference(job, chains, cfg, "tf32", dev)
        made = time.perf_counter() - t
        parts = {}
        n = judge.judge_job(job, produced, chains, cfg, device=dev,
                            seconds=parts)
        reading[name] = dict(numbers=n, produced_s=made, judge_parts=parts)
        assert not judge.verdict(n, limits), (name, n)
    print(json.dumps(reading))


def test_the_test_local_cell_file_holds_config5s_plan():
    from ahsoka_tpu_torch.utils.synth import CONFIGS

    from phasebench.tests.mixed import mixed_cell
    cell = mixed_cell()
    plan = cell["shape"]["plan"]
    spec = CONFIGS["config5"]
    assert (cell["shape"]["span"], plan["coverage_per_hap"],
            cell["shape"]["error_rate"]) == (spec.span,
                                             spec.coverage_per_hap,
                                             spec.error_rate)
    assert chain_plan(3000, plan["min_bubbles"], plan["max_bubbles"],
                      plan["ploidy_mix"], 5) == spec.plan()
    assert cell["config"]["settings"]["dp_beam_width"] == 2048
    json.dumps(cell)
    assert np.isclose(sum(plan["ploidy_mix"].values()), 1.0)


def test_the_wrapped_stages_keep_the_programs_counters():
    """The program counts CUDA launches on its stage functions
    (``score_pairs_banded.launches += 1`` through the module's name):
    the capture's wrappers carry the attribute."""
    from ahsoka_tpu_torch.score import banded

    from phasebench.capture import Capture
    cap = Capture()
    cap.install()
    try:
        assert banded.score_pairs_banded.__wrapped__ is not None
        banded.score_pairs_banded.launches += 1
    finally:
        cap.uninstall()
    assert not hasattr(banded.score_pairs_banded, "__wrapped__")


def test_a_fixed_warmup_job_is_the_same_work_for_every_seed():
    cell = tiny_mixed_cell()
    warm = cell["warmup_shape"]
    assert "warmup_shape" not in run.load_cell("tetraploid.chains200")
    for seed in (1, SEED):
        assert job_spec(warm, seed, -1).plan() == [(12, 2), (12, 4),
                                                   (10, 6)]
    assert job_spec(cell["shape"], 1, 0).plan() != \
        job_spec(cell["shape"], SEED, 0).plan()
