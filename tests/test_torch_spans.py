"""The span-and-counter recorder (``ahsoka_tpu_torch/utils/substage.py``)
and what ``run_phase`` writes of it into ``-metrics.json``, on the CPU."""

import glob
import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from ahsoka_tpu_torch.config import PhasingConfig
from ahsoka_tpu_torch.pipeline import run_phase
from ahsoka_tpu_torch.utils import substage
from ahsoka_tpu_torch.utils.synth import SynthSpec, write_synthetic

HERE = os.path.dirname(os.path.abspath(__file__))
METRICS = os.path.join(os.path.dirname(HERE), "phasebench", "metrics")

# the batched driver's stages on the job's thread, in the order they run
MAIN_STAGES = ("parse_gfa", "find_bubbles", "write_bubbleinfo", "parse_gaf",
               "allele_paths", "device_warmup", "pre_pass", "matrix_pool",
               "score_slice", "cluster_pool", "cluster_rest", "dp", "emit",
               "write_metrics")


def _settings(**kw):
    """The tetraploid cell's run settings, a pool of three threads."""
    with open(os.path.join(os.path.dirname(METRICS), "configs",
                           "tetraploid.json")) as fh:
        settings = json.load(fh)["settings"]
    settings.update(threads=3, **kw)
    return PhasingConfig(**settings)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("spans")
    gfa, gaf = str(d / "g.gfa"), str(d / "r.gaf")
    write_synthetic(gfa, gaf, SynthSpec(num_chains=4, bubbles_per_chain=12,
                                        reads_per_hap=24, ploidy=4, span=3,
                                        error_rate=0.02, seed=7))
    return d, gfa, gaf


def _run(inputs, tag, config=None, **kw):
    d, gfa, gaf = inputs
    out = str(d / tag)
    run_phase(gfa, gaf, out, config or _settings(), device="cpu", **kw)
    with open(out + "-metrics.json") as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def plain(inputs):
    """Two runs of the same job, no profiler."""
    return _run(inputs, "a"), _run(inputs, "b")


@pytest.fixture(scope="module")
def traced(inputs):
    """One run under a CPU profiler: its metrics and the exported trace."""
    d = inputs[0]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        m = _run(inputs, "t")
    path = str(d / "t-trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        return m, json.load(fh)["traceEvents"]


def test_spans_nest_and_self_is_wall_less_child_coverage():
    import time

    with substage.job():
        with substage.span("outer") as outer:
            time.sleep(0.02)
            with substage.span("inner") as inner:
                time.sleep(0.03)
            with substage.span("inner"):
                time.sleep(0.01)
        snap = substage.snapshot()
    spans = snap["spans"]
    assert inner.parent is outer and outer.parent.name == "job"
    assert spans["inner"]["calls"] == 2
    assert spans["outer"]["self_s"] == pytest.approx(
        spans["outer"]["wall_s"] - spans["inner"]["wall_s"], abs=1e-9)
    assert spans["outer"]["self_s"] >= 0.02
    # the root, still open, counts up to the snapshot
    assert spans["job"]["calls"] == 1
    assert spans["job"]["self_s"] == pytest.approx(
        spans["job"]["wall_s"] - spans["outer"]["wall_s"], abs=1e-4)


def test_pool_spans_take_the_pool_span_and_the_job_id():
    with substage.job() as root:
        with substage.span("pool") as pool:
            def task(i):
                with substage.within(pool):
                    with substage.span("work") as sp:
                        sum(range(20000))
                return sp, threading.get_ident()

            with ThreadPoolExecutor(max_workers=2) as ex:
                done = list(ex.map(task, range(4)))
        snap = substage.snapshot()
    assert any(t != threading.get_ident() for _sp, t in done)
    for sp, _t in done:
        assert sp.parent is pool and sp.job == root.job == snap["job"]
    # a worker's span covers nothing of the pool's on another thread
    assert snap["spans"]["pool"]["self_s"] == pytest.approx(
        snap["spans"]["pool"]["wall_s"], abs=1e-9)


def test_concurrent_spans_and_counts_lose_no_update():
    """More threads than cores, switching as often as the interpreter
    allows: every span and count a worker makes is in the aggregate."""
    import sys

    threads, each = 16, 400
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with substage.job():
            with substage.span("pool") as pool:
                def task(_):
                    with substage.within(pool):
                        for _ in range(each):
                            with substage.span("work"):
                                substage.count("ticks")
                            substage.add("sub.ticks", 2)

                with ThreadPoolExecutor(max_workers=threads) as ex:
                    futures = [ex.submit(task, i) for i in range(threads)]
                    for f in futures:
                        f.result(timeout=120)
            snap = substage.snapshot()
            subs = substage.substages()
    finally:
        sys.setswitchinterval(old)
    assert snap["spans"]["work"]["calls"] == threads * each
    assert snap["counters"]["ticks"] == threads * each
    assert subs == {"sub.ticks": 2.0 * threads * each}


def test_cpu_is_within_wall_and_counters_repeat(plain):
    first, second = plain
    for m in plain:
        for name, s in m["spans"].items():
            assert 0 <= s["cpu_s"] <= s["wall_s"], name
            assert 0 <= s["self_s"] <= s["wall_s"] + 1e-9, name
    # a job's aggregate starts from nothing: one root, one parse a job
    assert first["job"] != second["job"]
    for m in plain:
        assert m["spans"]["job"]["calls"] == 1
        assert m["spans"]["parse_gfa"]["calls"] == 1
        assert {k: v["calls"] for k, v in m["spans"].items()} == \
            {k: v["calls"] for k, v in first["spans"].items()}
    assert first["counters"] == second["counters"]
    c = first["counters"]
    assert c["device.round_trips"] > 0 and c["device.upload_bytes"] > 0
    assert c["device.fetch_bytes"] > 0 and c["scoring.slices"] >= 1
    assert c["chains.pre_pass"] == 4
    assert c["chains.dense"] + c.get("chains.banded", 0) == 4
    assert c["rows.after_collapse"] <= c["rows.before_collapse"]


def test_every_main_stage_is_a_child_of_the_job(traced):
    m, _trace = traced
    events = m["span_events"]
    root = events[0]
    assert root["name"] == "job" and root["parent"] is None
    children = [e for e in events if e["parent"] == root["id"]]
    names = [e["name"] for e in children]
    assert all(e["thread"] == root["thread"] for e in children)
    order = [n for n in dict.fromkeys(names) if n in MAIN_STAGES]
    assert order == [n for n in MAIN_STAGES if n in order]
    assert set(MAIN_STAGES) - set(names) <= {"cluster_rest"}
    # children of the job are disjoint and cover it
    spans = sorted((e["t0"], e["t1"]) for e in children)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    covered = sum(t1 - t0 for t0, t1 in spans)
    assert covered >= 0.95 * (root["t1"] - root["t0"])
    job = m["spans"]["job"]
    assert job["wall_s"] - job["self_s"] >= 0.95 * job["wall_s"]


def test_worker_spans_sit_under_their_pool(traced):
    m, _trace = traced
    by_id = {e["id"]: e for e in m["span_events"]}
    main = m["span_events"][0]["thread"]
    workers = [e for e in m["span_events"] if e["thread"] != main]
    assert workers, "the pool of three threads ran nothing off the job's"
    pools = {"matrix_pool", "cluster_pool", "cluster_rest"}
    for e in workers:
        up = by_id[e["parent"]]
        while up["thread"] != main:
            up = by_id[up["parent"]]
        assert up["name"] in pools, e
        assert up["t0"] <= e["t0"] and e["t1"] <= up["t1"]
    names = {e["name"] for e in workers}
    assert {"matrix", "clustering.solver", "dp_inputs"} <= names


def test_the_benchmark_keys_are_written(inputs, plain):
    """Every ``stage_seconds`` and ``substages`` key a metric file of the
    benchmark names, after a dense and a banded run."""
    banded = _run(inputs, "banded", _settings(banded_scoring_threshold=8))
    assert banded["counters"]["chains.banded"] >= 1
    stages, subs = set(), set()
    for m in (plain[0], banded):
        stages |= set(m["stage_seconds"])
        subs |= set(m["stage_seconds"]["substages"])
    named = 0
    for path in glob.glob(os.path.join(METRICS, "*.json")):
        with open(path) as fh:
            meta = json.load(fh)
        if meta.get("reader") == "stage_sum":
            assert set(meta["keys"]) <= stages, meta["name"]
            named += 1
        elif meta.get("reader") == "substage_sum":
            assert set(meta["keys"]) - {"matrix.covcap"} <= subs, \
                meta["name"]
            named += 1
    assert named >= 5
    assert "matrix.covcap" in _run(
        inputs, "cap", _settings(max_coverage=4))["stage_seconds"][
            "substages"]
    for m in (plain[0], banded):
        assert "device_rtt_est" not in m["stage_seconds"]
        assert {"projection", "threading"}.isdisjoint(
            k for c in m["chains"] for k in c["stage_seconds"])


def test_the_per_chain_driver_takes_the_same_names(inputs):
    m = _run(inputs, "perchain", _settings(batch_dp=False))
    assert {"matrix", "clustering.solver", "dp_inputs", "dp", "emit"} \
        <= set(m["spans"])
    assert m["spans"]["dp"]["calls"] == m["chains_phased"]
    assert m["stage_seconds"]["dp_device_window"] == pytest.approx(
        m["spans"]["dp"]["wall_s"])


def test_no_profiler_no_events_and_no_ranges(inputs, plain, monkeypatch):
    from torch.autograd import profiler

    opened = []
    real = profiler.record_function
    monkeypatch.setattr(profiler, "record_function",
                        lambda name, *a: (opened.append(name),
                                          real(name, *a))[1])
    m = _run(inputs, "quiet")
    assert "span_events" not in m and "span_events" not in plain[0]
    assert opened == []


def test_ranges_and_events_under_a_profiler(traced):
    m, trace = traced
    ranges = [e for e in trace if e.get("ph") == "X"
              and e.get("name", "").startswith("ahsoka.")]
    names = {e["name"] for e in ranges}
    assert {"ahsoka." + n for n in MAIN_STAGES} - {"ahsoka.cluster_rest"} \
        <= names
    assert "ahsoka.job" not in names
    offset = substage.place(m["span_events"], trace)
    assert offset is not None
    main = m["span_events"][0]["thread"]
    first = {}
    for e in sorted(ranges, key=lambda e: e["ts"]):
        first.setdefault(e["name"], e)
    errors = []
    for ev in m["span_events"]:
        rng = first.get("ahsoka." + ev["name"])
        if ev["thread"] != main or rng is None or ev["parent"] is None:
            continue
        first.pop("ahsoka." + ev["name"])
        errors.append(abs(ev["t0"] * 1e6 + offset - rng["ts"]))
        # a span ends before its range does
        assert ev["t1"] * 1e6 + offset <= rng["ts"] + rng["dur"] + 1000.0
    # placed within 1 ms of its range; a process descheduled between a
    # span's clock reading and its range's moves that one event alone
    assert len(errors) >= len(MAIN_STAGES) - 1
    assert sorted(errors)[len(errors) // 2] < 1000.0
    assert sum(e < 1000.0 for e in errors) >= 0.75 * len(errors), errors


def test_profile_dir_puts_the_workers_on_their_own_rows(inputs):
    d = inputs[0]
    m = _run(inputs, "prof", profile_dir=str(d / "prof"))
    with open(d / "prof" / "trace.json") as fh:
        trace = json.load(fh)["traceEvents"]
    main = m["span_events"][0]["thread"]
    workers = [e for e in m["span_events"] if e["thread"] != main]
    rows = [e for e in trace if e.get("cat") == "ahsoka_span"]
    assert len(rows) == len(workers) > 0
    assert {e["tid"] for e in rows} == {e["thread"] for e in workers}
    assert main not in {e["tid"] for e in rows}
    names = [e for e in trace if e.get("ph") == "M"
             and e.get("name") == "thread_name"
             and e["args"]["name"].startswith("ahsoka worker")]
    assert len(names) == len({e["tid"] for e in rows})
    # on the trace's clock: inside their pool's range
    pools = [e for e in trace if e.get("name") in (
        "ahsoka.matrix_pool", "ahsoka.cluster_pool", "ahsoka.cluster_rest")]
    for e in rows:
        assert any(p["ts"] - 1000 <= e["ts"]
                   and e["ts"] + e["dur"] <= p["ts"] + p["dur"] + 1000
                   for p in pools), e
