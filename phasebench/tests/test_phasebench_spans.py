"""The per-layer metrics that read the program's spans and counters:
``project.wall_s``, ``cluster.wall_s``, ``cluster.wait_share``,
``device.round_trips`` and ``device.idle_unspanned_share``."""

import json
import os

import pytest

from phasebench.run import load_metrics
from phasebench.trace import Trace

US = 1e6
NEW = ("project.wall_s", "cluster.wall_s", "cluster.wait_share",
       "device.round_trips", "device.idle_unspanned_share")


def _read(name, ctx):
    meta = load_metrics()[name]
    return meta["read"](ctx, meta)


def _spans(**walls):
    return {k: {"calls": 1, "wall_s": w, "self_s": w, "cpu_s": c}
            for k, (w, c) in walls.items()}


def test_wall_seconds_sum_the_named_spans_a_job():
    jobs = [{"spans": _spans(pre_pass=(0.5, 0.1), matrix_pool=(0.25, 0.0),
                             cluster_pool=(1.0, 0.0),
                             cluster_rest=(0.5, 0.0))},
            {"spans": _spans(pre_pass=(0.25, 0.1), matrix_pool=(0.25, 0.0),
                             cluster_pool=(2.0, 0.0))}]
    ctx = {"jobs": jobs}
    assert _read("project.wall_s", ctx) == pytest.approx(0.625)
    assert _read("cluster.wall_s", ctx) == pytest.approx(1.75)
    # a program that writes no spans: nothing to read
    ctx = {"jobs": [{"stage_seconds": {}}]}
    for name in NEW[:4]:
        assert _read(name, ctx) is None


def test_wait_share_is_the_solver_time_off_the_cpu():
    jobs = [{"spans": _spans(**{"clustering.solver": (3.0, 2.0)})},
            {"spans": _spans(**{"clustering.solver": (1.0, 1.0)})}]
    assert _read("cluster.wait_share", {"jobs": jobs}) == pytest.approx(25.0)


def test_round_trips_average_the_counter():
    jobs = [{"counters": {"device.round_trips": 10}},
            {"counters": {"device.round_trips": 20, "other": 5}}]
    assert _read("device.round_trips", {"jobs": jobs}) == 15


def _events(spans):
    """span_events of one job: (name, id, parent, thread, t0, t1)."""
    return [dict(zip(("name", "id", "parent", "thread", "t0", "t1"), s))
            for s in spans]


def test_idle_attribution_places_each_job_by_its_anchor(tmp_path):
    # window 0-20 s; device busy 3-4 s and 13-14 s; job A's parse range
    # starts at 1 s (its events' clock starts 1 s earlier), job B's at 11 s
    trace = [
        {"ph": "X", "cat": "user_annotation", "name": "phasebench.window",
         "ts": 0, "dur": 20 * US},
        {"ph": "X", "cat": "kernel", "name": "dpk_forward", "ts": 3 * US,
         "dur": 1 * US},
        {"ph": "X", "cat": "kernel", "name": "dpk_forward", "ts": 13 * US,
         "dur": 1 * US},
        {"ph": "X", "cat": "user_annotation", "name": "ahsoka.parse_gfa",
         "ts": 1 * US, "dur": 1 * US},
        {"ph": "X", "cat": "user_annotation", "name": "ahsoka.parse_gfa",
         "ts": 11 * US, "dur": 2 * US},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": trace}))
    t = Trace(str(path))
    # job A, its clock at 0 = 0.5 s of the trace: the root 0.5-8.5, stages
    # parse 1-2 and a pool 2-6 on the job's thread (7), a worker span (8)
    # 5-8 that outlasts the pool: 6-8 is not spanned
    a = _events([("job", 1, None, 7, 0.0, 8.0),
                 ("parse_gfa", 2, 1, 7, 0.5, 1.5),
                 ("cluster_pool", 3, 1, 7, 1.5, 5.5),
                 ("clustering.solver", 4, 3, 8, 4.5, 7.5)])
    # job B, its clock at 0 = 10 s: the root 10-16, parse 11-13
    b = _events([("job", 1, None, 7, 0.0, 6.0),
                 ("parse_gfa", 2, 1, 7, 1.0, 3.0)])
    ctx = {"trace": t, "jobs": [{"span_events": a}, {"span_events": b}]}
    idle = 20.0 - 2.0
    # spanned and idle: 1-3 and 4-6 (job A), 11-13 (job B)
    want = 100.0 * (idle - (2.0 + 2.0 + 2.0)) / idle
    assert _read("device.idle_unspanned_share", ctx) == pytest.approx(want)
    # the window's jobs and the trace's anchors do not pair: no reading
    ctx["jobs"] = ctx["jobs"][:1]
    assert _read("device.idle_unspanned_share", ctx) is None
    ctx["jobs"] = [{"stage_seconds": {}}]
    assert _read("device.idle_unspanned_share", ctx) is None


def test_a_tiny_cell_run_reads_every_new_metric(tmp_path):
    """The program's own jobs, under a CPU profiler with the harness's
    window range, read by the five readers."""
    import torch

    from ahsoka_tpu_torch.config import PhasingConfig
    from ahsoka_tpu_torch.pipeline import run_phase
    from phasebench.jobs import make_pool
    from phasebench.tests.tiny import tiny_cell

    cell = tiny_cell("tetraploid.chains200")
    paths = make_pool(cell["shape"], 2200000011, [0, 1], str(tmp_path), 1)
    cfg = PhasingConfig(**dict(cell["config"]["settings"], threads=2))
    jobs = []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("phasebench.window"):
            for i, (gfa, gaf) in enumerate(paths):
                out = os.path.join(str(tmp_path), f"o{i}")
                with torch.profiler.record_function("phasebench.job"):
                    run_phase(gfa, gaf, out, config=cfg, device="cpu")
                with open(out + "-metrics.json") as fh:
                    jobs.append(json.load(fh))
    trace_path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(trace_path)
    ctx = {"jobs": jobs, "trace": Trace(trace_path),
           "config": cell["config"]}
    got = {name: _read(name, ctx) for name in NEW}
    assert all(v is not None for v in got.values()), got
    assert got["project.wall_s"] > 0 and got["cluster.wall_s"] > 0
    assert 0 <= got["cluster.wait_share"] < 100
    assert got["device.round_trips"] >= 1
    # no device on the CPU: the window is idle, and the stages cover most
    # of it
    assert 0 < got["device.idle_unspanned_share"] < 50
    for name in NEW:
        meta = load_metrics()[name]
        assert meta["workloads"] == ["tetraploid.chains200"]
