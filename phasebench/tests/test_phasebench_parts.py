"""The harness's arithmetic and discovery, on the CPU."""

import json
import os

import pytest

from phasebench import roofline, stats
from phasebench.run import (HERE, ROOT, forbidden_modules, load_cell,
                            load_metrics)
from phasebench.trace import Trace


def _benchmark():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_cells_configs_and_metrics_are_found_by_name():
    bench = _benchmark()
    metrics = load_metrics()
    for w in bench["workloads"]:
        cell = load_cell(w["name"])
        assert cell["config"]["name"] == w["config"]
        assert cell["traffic"] == w["traffic"]
        assert cell["chips"] == w["chips"]
    for c in bench["configs"]:
        assert c["file"] == f"phasebench/configs/{c['name']}.json"
        with open(os.path.join(ROOT, c["file"])) as fh:
            assert json.load(fh)["reduced"] == c["reduced"]
    assert {m["name"] for m in bench["per_layer"]} == set(metrics)
    for m in bench["per_layer"]:
        for key in ("unit", "better", "source", "layer", "moves"):
            assert metrics[m["name"]][key] == m[key], (m["name"], key)
        assert callable(metrics[m["name"]]["read"])
        assert metrics[m["name"]].get("workloads") == m.get("workloads")


def test_each_cell_reports_what_the_benchmark_lists_for_it():
    from phasebench.run import END_TO_END_UNITS, end_to_end, reported_in
    bench = _benchmark()
    metrics = load_metrics()
    assert {m["name"]: m["unit"] for m in bench["end_to_end"]} == \
        END_TO_END_UNITS
    for w in bench["workloads"]:
        cell = load_cell(w["name"])
        want = [m["name"] for m in bench["end_to_end"]
                if w["name"] in m.get("workloads", [w["name"]])]
        assert sorted(end_to_end(cell)) == sorted(want)
        assert "setup_s" in want and len(want) >= 2
        layer = [m["name"] for m in bench["per_layer"]
                 if w["name"] in m.get("workloads", [w["name"]])
                 and m["moves"] in want]
        assert layer
        assert sorted(n for n, m in metrics.items()
                      if reported_in(m, cell)) == sorted(layer)


def test_every_workload_file_names_an_existing_configuration():
    for fn in os.listdir(os.path.join(HERE, "workloads")):
        cell = load_cell(fn[:-len(".json")])
        assert cell["name"] + ".json" == fn
        assert set(cell["limits"]) == {"score_gap", "dp_cost_gap"}


def test_rate_counts_a_last_job_that_overruns_the_window():
    # a 10 s window whose last job ends at 12.5 s: 1000 records / 12.5 s
    assert stats.rate(1000, 0.0, [3.0, 7.0, 12.5]) == pytest.approx(80.0)


@pytest.mark.parametrize("n,want", [(1, 1), (10, 10), (19, 19), (20, 19),
                                    (21, 20), (100, 95)])
def test_p95_is_nearest_rank(n, want):
    values = list(range(n, 0, -1))
    assert stats.nearest_rank(values, 0.95) == want


def test_job_p95_reads_the_window_jobs():
    meta = load_metrics()["job_s_p95"]
    assert meta["read"]({"job_seconds": [float(x) for x in range(1, 21)]},
                        meta) == 19.0
    assert meta["read"]({"job_seconds": []}, meta) is None


def test_union_and_gaps_of_overlapping_intervals():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7)]
    assert stats.union(iv) == [(0.0, 3.0), (5.0, 6.0)]
    assert stats.covered(iv) == pytest.approx(4.0)
    assert stats.gaps(iv, -1.0, 10.0) == [(-1.0, 0.0), (3.0, 5.0),
                                          (6.0, 10.0)]


def test_trace_idle_share_is_one_minus_the_union(tmp_path):
    us = 1e6
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "phasebench.window",
         "ts": 0, "dur": 10 * us},
        {"ph": "X", "cat": "kernel", "name": "void dpk_forward<4>(int*)",
         "ts": 1 * us, "dur": 2 * us},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
         "ts": 2 * us, "dur": 2 * us},
        {"ph": "X", "cat": "kernel",
         "name": "(anonymous namespace)::dpk_backtrace(int const*, int*)",
         "ts": 8 * us, "dur": 1 * us},
        {"ph": "X", "cat": "user_annotation", "name": "phasebench.solver",
         "ts": 4 * us, "dur": 3 * us},
        {"ph": "X", "cat": "user_annotation", "name": "phasebench.job",
         "ts": 0, "dur": 10 * us},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    t = Trace(str(path))
    assert t.window_s == pytest.approx(10.0)
    assert t.busy_s == pytest.approx(4.0)      # [1, 4] and [8, 9]
    assert t.kernel_s["dpk_forward"] == pytest.approx(2.0)
    assert t.kernel_s["dpk_backtrace"] == pytest.approx(1.0)
    idle = load_metrics()["device.idle_share"]
    assert idle["read"]({"trace": t}, idle) == pytest.approx(60.0)
    gaps = t.idle_gaps()
    assert gaps[0] == ["phasebench.solver", pytest.approx(4.0)]
    assert [g[1] for g in gaps] == pytest.approx([4.0, 1.0, 1.0])


@pytest.mark.parametrize("kernel", ["node_costs", "dpk_forward_warp",
                                    "dpk_forward", "dpk_backtrace"])
@pytest.mark.parametrize("k,C,P", [(2, 1, 50), (2, 1000, 56), (4, 1, 200),
                                   (4, 20, 256), (5, 4, 64)])
def test_roofline_counts_match_the_program_tools(kernel, k, C, P):
    from ahsoka_tpu_torch.scripts import roofline as program
    assert roofline.work(kernel, k, C, P) == program.work(kernel, k, C, P)
    assert roofline.least_seconds(*roofline.work(kernel, k, C, P)) \
        == program.least_seconds(*program.work(kernel, k, C, P))


def test_dp_roofline_counts_each_chain_at_its_own_positions():
    class T:
        kernel_s = {"dpk_forward_warp": 2e-3, "dpk_backtrace": 1e-3,
                    "other": 5.0}
    jobs = [{"chains": [{"positions": 50, "skipped": False},
                        {"positions": 0, "skipped": True}]},
            {"chains": [{"positions": 48, "skipped": False}]}]
    meta = load_metrics()["kernels.dp_roofline"]
    got = meta["read"]({"trace": T, "jobs": jobs, "config": {"ploidy": 2}},
                       meta)
    least = roofline.chain_dp_least_seconds(2, 50) \
        + roofline.chain_dp_least_seconds(2, 48)
    assert got == pytest.approx(100 * least / 3e-3)
    assert meta["read"]({"trace": None, "jobs": jobs,
                         "config": {"ploidy": 2}}, meta) is None


@pytest.mark.parametrize("names,found", [
    (["ahsoka_tpu_torch", "ahsoka_tpu_torch.pipeline", "numpy"], []),
    (["ahsoka_tpu.phase"], ["ahsoka_tpu"]),
    (["ahsoka_tpu"], ["ahsoka_tpu"]),
    (["jax.numpy"], ["jax"]),
    (["jaxlib", "flax.linen", "jaxtyping"], ["flax", "jaxlib"]),
])
def test_forbidden_modules_compare_whole_top_level_names(names, found):
    assert forbidden_modules(names) == found
