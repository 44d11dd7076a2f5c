"""The JAX package's reference digests (``ahsoka_tpu_torch/data/
jax_reference.json``, written by ``tools/jax_reference.py``) and
chip_smoke.py's check of a run against them, on the CPU.

- each entry equals the JAX package's digests recomputed here at 2 host
  threads (the file was written at 8): its spec, settings and ploidy map,
  every result file and the accuracy against the planted truth; the
  port's CPU run of the same inputs writes the same files.  config4s,
  config3c and mixed run in Tier-1; config5s and config2, the two largest
  configurations (each 10-27 minutes through each package on 8 cores),
  are marked ``slow``;
- ``run_digests`` on the golden diploid run;
- ``chip_smoke.reference_verdict``: an ``allowed`` chain and a near-tie
  pass; a differing allele matrix, a near-tie whose CPU file is not the
  reference's and more than 5% of the chains differing fail; the
  near-tie evidence of a real run (dense and banded scoring) on the CPU.
"""

import dataclasses
import os
import shutil
import sys

import pytest
import torch

from ahsoka_tpu_torch.scripts.bench_e2e import bench_settings
from ahsoka_tpu_torch.utils import digest

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
THREADS = 2
CONFIGS = ["config4s", "config3c", "mixed",
           pytest.param("config5s", marks=pytest.mark.slow),
           pytest.param("config2", marks=pytest.mark.slow)]


def _chip_smoke():
    sys.path.insert(0, REPO)
    import chip_smoke
    return chip_smoke


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """name -> (entry, work dir, truth, ploidy map); each configuration's
    inputs are written once and phased by each package at most once."""
    cache = {}

    def get(name):
        if name not in cache:
            from ahsoka_tpu_torch.utils.synth import write_synthetic

            spec = digest.reference_spec(name)
            work = tmp_path_factory.mktemp(name)
            gfa, gaf, truth = (str(work / f"{name}.{x}")
                               for x in ("gfa", "gaf", "truth"))
            write_synthetic(gfa, gaf, spec, truth_path=truth)
            pmap = None
            if len({k for _, k in spec.plan()}) > 1:
                from ahsoka_tpu.config import PhasingConfig
                from ahsoka_tpu.graph.alleles import enumerate_allele_paths
                from ahsoka_tpu.pipeline import load_graph_and_bubbles
                from ahsoka_tpu.utils.accuracy import ploidy_map_from_truth

                art = load_graph_and_bubbles(gfa, PhasingConfig())
                pmap = ploidy_map_from_truth(
                    enumerate_allele_paths(art.graph, art.index), truth)
            cache[name] = dict(entry=digest.load_reference()[name],
                               gfa=gfa, gaf=gaf, truth=truth, pmap=pmap,
                               work=work)
        return cache[name]
    return get


@pytest.mark.parametrize("config", CONFIGS)
def test_reference_entry_equals_jax_package(runs, config):
    from ahsoka_tpu.config import PhasingConfig
    from ahsoka_tpu.pipeline import run_phase
    from ahsoka_tpu.utils.accuracy import score_phased_output

    r = runs(config)
    entry, spec = r["entry"], digest.reference_spec(config)
    cfg = PhasingConfig(**bench_settings(spec.ploidy, r["pmap"], THREADS))
    assert entry["spec"] == digest.spec_fields(spec)
    assert entry["seed"] == spec.seed
    assert entry["config"] == digest.config_fields(cfg)
    assert entry["ploidy_map"] == digest.ploidy_map_json(r["pmap"])
    assert entry["threads"] == 8
    stem = str(r["work"] / "jax")
    run_phase(r["gfa"], r["gaf"], stem, config=cfg)
    got = digest.run_digests(stem)
    assert got == entry["digests"]
    assert len(got["chains"]) == len(spec.plan())
    assert score_phased_output(stem, r["truth"]) == \
        entry["accuracy_vs_planted_truth"]


@pytest.mark.parametrize("config", CONFIGS)
def test_port_cpu_digests_equal_reference(runs, config):
    from ahsoka_tpu_torch.config import PhasingConfig
    from ahsoka_tpu_torch.pipeline import run_phase

    r = runs(config)
    cfg = PhasingConfig(**bench_settings(
        digest.reference_spec(config).ploidy, r["pmap"], THREADS))
    assert digest.config_fields(cfg) == r["entry"]["config"]
    stem = str(r["work"] / "port")
    run_phase(r["gfa"], r["gaf"], stem, cfg, device="cpu")
    diff = digest.compare_digests(r["entry"]["digests"],
                                  digest.run_digests(stem))
    assert diff["files"] == [] or diff["chains"]
    assert not diff["extra"]
    assert diff["chains"] == digest.allowed_chains(r["entry"])


def test_run_digests_golden_diploid(tmp_path):
    from ahsoka_tpu_torch.config import PhasingConfig
    from ahsoka_tpu_torch.pipeline import run_phase

    gaf = tmp_path / "golden_diploid.gaf"
    shutil.copy(os.path.join(DATA, "golden_diploid.gaf"), gaf)
    stem = str(tmp_path / "o")
    run_phase(os.path.join(DATA, "golden_diploid.gfa"), str(gaf), stem,
              PhasingConfig(), device="cpu")
    got = digest.run_digests(stem)
    assert got["result"] == digest.file_digest(
        os.path.join(DATA, "golden_diploid-result.txt"))
    assert got["bubbleinfo"] == digest.file_digest(
        os.path.join(DATA, "golden_diploid-bubbleinfo.txt"))
    chain_files = sorted(f for f in os.listdir(tmp_path)
                         if f.startswith("o-chain")
                         and f.endswith("-result.txt"))
    assert [f"o-chain{c}-result.txt" for c in got["chains"]] == chain_files
    assert len(chain_files) == 1
    assert digest.compare_digests(got, got) == {"files": [], "chains": [],
                                                "extra": []}
    # a chain file missing from a run is a differing chain
    os.remove(tmp_path / chain_files[0])
    assert digest.compare_digests(got, digest.run_digests(stem))["chains"] \
        == [int(c) for c in got["chains"]]


# ------------------------------------------------ chip_smoke's verdict
def _entry(chains: int) -> dict:
    return {"digests": {"result": "r", "bubbleinfo": "b",
                        "chains": {str(c): f"jax{c}" for c in range(chains)}}}


def _differing(entry: dict, chains, digest_of=lambda c: f"port{c}") -> dict:
    got = {"result": "r2" if chains else "r", "bubbleinfo": "b",
           "chains": dict(entry["digests"]["chains"])}
    for c in chains:
        got["chains"][str(c)] = digest_of(c)
    return got


def _near_tie(c, **kw):
    why = {"chain": c, "matrix_equal": True, "scores_close": True,
           "same_clusters": False, "cpu_digest": f"jax{c}"}
    why.update(kw)
    return why


def _no_explain(c):
    raise AssertionError(f"chain {c} was re-run")


def test_verdict_equal_run():
    smoke = _chip_smoke()
    entry = _entry(40)
    out = smoke.reference_verdict("x", entry, _differing(entry, []),
                                  _no_explain)
    assert out == {"config": "x", "chains": 40, "equal": 40,
                   "near_tie": [], "allowed": [], "near_tie_evidence": []}


def test_verdict_accepts_an_allowed_chain():
    smoke = _chip_smoke()
    entry = _entry(40)
    entry["allowed"] = [{"chain": 7, "stage": "clusters",
                         "max_abs_w": 1.5e-5, "jax_digest": "jax7",
                         "port_digest": "port7", "why": "float32 sum"}]
    out = smoke.reference_verdict("x", entry, _differing(entry, [7]),
                                  _no_explain)
    assert out["allowed"] == [7] and out["equal"] == 39
    assert out["near_tie"] == []
    # the allowed chain with another digest than the port's recorded one
    # is no longer allowed: it needs the near-tie evidence
    seen = []
    out = smoke.reference_verdict(
        "x", entry, _differing(entry, [7], lambda c: "other"),
        lambda c: seen.append(c) or _near_tie(c))
    assert seen == [7] and out["near_tie"] == [7] and out["allowed"] == []


def test_verdict_accepts_a_near_tie():
    smoke = _chip_smoke()
    entry = _entry(40)
    out = smoke.reference_verdict("x", entry, _differing(entry, [3, 30]),
                                  _near_tie)
    assert out["near_tie"] == [3, 30] and out["equal"] == 38
    assert [w["chain"] for w in out["near_tie_evidence"]] == [3, 30]


@pytest.mark.parametrize("fault", [
    dict(matrix_equal=False), dict(scores_close=False),
    dict(same_clusters=True), dict(cpu_digest="port3")])
def test_verdict_rejects_an_unexplained_chain(fault):
    smoke = _chip_smoke()
    entry = _entry(40)
    with pytest.raises(AssertionError, match="chain 3 differs"):
        smoke.reference_verdict("x", entry, _differing(entry, [3]),
                                lambda c: _near_tie(c, **fault))


def test_verdict_rejects_more_than_5_percent_before_rerunning():
    smoke = _chip_smoke()
    entry = _entry(40)
    # 2 of 40 is 5%: re-run; 3 of 40 is not
    smoke.reference_verdict("x", entry, _differing(entry, [1, 2]), _near_tie)
    with pytest.raises(AssertionError, match="3 of 40 chains differ"):
        smoke.reference_verdict("x", entry, _differing(entry, [1, 2, 3]),
                                _no_explain)


def test_verdict_rejects_other_files():
    smoke = _chip_smoke()
    entry = _entry(40)
    for got in (dict(_differing(entry, []), bubbleinfo="b2"),
                dict(_differing(entry, []), result="r2")):
        with pytest.raises(AssertionError, match="beyond its chains"):
            smoke.reference_verdict("x", entry, got, _no_explain)
    got = _differing(entry, [])
    got["chains"]["99"] = "extra"
    with pytest.raises(AssertionError, match="beyond its chains"):
        smoke.reference_verdict("x", entry, got, _no_explain)


@pytest.mark.parametrize("banded", [False, True])
def test_near_tie_evidence_on_the_cpu(tmp_path, banded):
    """chip_smoke's per-chain evidence with the CPU in the card's place: a
    chain whose reference digest was altered has equal matrices, scores
    and clusters on both sides, so it is no near-tie and the verdict
    fails; with banded scoring forced, the edge lists are compared."""
    from ahsoka_tpu_torch.config import PhasingConfig
    from ahsoka_tpu_torch.pipeline import run_phase
    from ahsoka_tpu_torch.utils.synth import SynthSpec, write_synthetic

    smoke = _chip_smoke()
    spec = SynthSpec(num_chains=20, bubbles_per_chain=6, reads_per_hap=12,
                     span=3, error_rate=0.02, seed=4)
    gfa, gaf, truth = (str(tmp_path / f"s.{x}") for x in ("gfa", "gaf",
                                                          "truth"))
    write_synthetic(gfa, gaf, spec, truth_path=truth)
    cfg = PhasingConfig(debug_readset_files=False, max_coverage=64)
    if banded:
        cfg = dataclasses.replace(cfg, banded_scoring_threshold=8)
    stem = str(tmp_path / "run")
    art = run_phase(gfa, gaf, stem, cfg, device="cpu")
    assert art.gaf_columns is not None
    got = digest.run_digests(stem)
    r = {"art": art, "config": cfg, "work": str(tmp_path)}
    chain = int(next(iter(got["chains"])))
    why = smoke._near_tie_evidence("cpu", r, chain)
    assert why["matrix_equal"] and why["scores_close"]
    assert why["same_clusters"] and why["max_abs_score_diff"] == 0.0
    assert why["banded"] is banded
    assert why["cpu_digest"] == got["chains"][str(chain)]
    entry = {"digests": dict(got, chains=dict(got["chains"]))}
    entry["digests"]["chains"][str(chain)] = "0" * 64
    entry["digests"]["result"] = "0" * 64
    with pytest.raises(AssertionError, match=f"chain {chain} differs"):
        smoke.reference_verdict(
            "s", entry, got, lambda c: smoke._near_tie_evidence("cpu", r, c))
