"""One run of one cell of the benchmark of ``ahsoka_tpu_torch`` on a card.

    python -m phasebench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The cell's files are found by name:
``phasebench/workloads/<cell>.json`` (its traffic and the configuration
it runs), ``phasebench/configs/<config>.json`` (the deployment and its
run settings) and ``phasebench/metrics/<metric>.json`` (the per-layer
metrics, each with its reader).

Set-up (``setup_s``): imports and the card's context; the job pool,
generated from ``--seed`` in parallel processes; one warm-up job of the
cell's shape, which loads (on a checkout's first run: builds) the
program's kernels and native libraries under ``build/`` in the
checkout.  The window then phases the pool's jobs one at a time, back to
back, through ``ahsoka_tpu_torch.pipeline.run_phase``, until ``--seconds``
have passed; the job running then finishes and counts.  After the
window, every job's files, and the chains of a sample of the jobs drawn
from the seed, are held to the plain reference (``phasebench.judge``).
The host's BLAS, OpenMP and torch intra-op pools run at one thread
beside the program's own phase threads.

The last line of standard output is one JSON object: ``correct``,
``attempted`` and ``failed`` (chains), ``metrics`` (``--trace 0``: the
end-to-end metrics the workload file lists under ``end_to_end``;
``--trace 1``: the per-layer metrics that move one of those and name the
cell, where they name any, read from a profiler trace of the window),
``device``, ``breakdown`` (traced runs), ``unchecked`` (the chains a
stage of which no plain reference checks yet: not a fault) and
``checks`` (each number compared with its limit).  A run exits 2,
printing no result, without a card.
"""

from __future__ import annotations

import time

_IMPORTED_AT = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# whole top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "ahsoka_tpu")
END_TO_END_UNITS = {"records_per_s": "records/s", "peak_device_gib": "GiB",
                    "setup_s": "s"}


def process_start() -> float:
    """Wall-clock time at which this process started (Linux), else the
    time this module was imported."""
    try:
        with open("/proc/self/stat") as fh:
            fields = fh.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.time() - (uptime - started)
    except (OSError, ValueError, IndexError):
        return _IMPORTED_AT


def forbidden_modules(names) -> List[str]:
    """The forbidden top-level names among module names, compared whole:
    ``ahsoka_tpu_torch.x`` is not ``ahsoka_tpu``."""
    return sorted({n.split(".", 1)[0] for n in names} & set(FORBIDDEN))


def _load_json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as fh:
        return json.load(fh)


def load_cell(name: str) -> dict:
    """The cell's workload file with its configuration under ``config``
    and the job shape (the configuration's, with the traffic's ``job``
    keys over it) under ``shape``.  A configuration's ``plan`` goes into
    the shape whole, and a ``job`` key that names a plan key
    (``jobs.PLAN_KEYS``) overrides it there.  A workload's
    ``warmup_job`` keys override ``shape`` in the same way for the
    warm-up job alone (``warmup_shape``): a plan drawn from the seed
    varies its warm-up's work, a fixed ``chains`` list does not."""
    cell = _load_json("workloads", f"{name}.json")
    return make_cell(cell, _load_json("configs", f"{cell['config']}.json"))


def make_cell(cell: dict, config: dict) -> dict:
    """``load_cell`` of a workload and a configuration already read."""
    from phasebench.jobs import PLAN_KEYS, SHAPE_KEYS

    def over(shape, keys):
        shape = dict(shape)
        if "plan" in shape:
            shape["plan"] = dict(shape["plan"])
        for k, v in keys.items():
            if "plan" in shape and k in PLAN_KEYS:
                shape["plan"][k] = v
            else:
                shape[k] = v
        return shape
    shape = {k: config[k] for k in SHAPE_KEYS if k in config}
    if "plan" in config:
        shape["plan"] = config["plan"]
    shape = over(shape, cell.get("job", {}))
    out = dict(cell, config=config, shape=shape)
    if "warmup_job" in cell:
        out["warmup_shape"] = over(shape, cell["warmup_job"])
    return out


def end_to_end(cell: dict) -> List[str]:
    """The end-to-end metrics the cell reports: its workload file's
    ``end_to_end`` list, else all of them."""
    return list(cell.get("end_to_end", END_TO_END_UNITS))


def reported_in(meta: dict, cell: dict) -> bool:
    """Whether a per-layer metric is read in the cell: it moves one of
    the cell's end-to-end metrics and, where it lists cells, names it."""
    return (meta["moves"] in end_to_end(cell)
            and cell["name"] in meta.get("workloads", [cell["name"]]))


def load_metrics() -> Dict[str, dict]:
    """Every per-layer metric file, with its ``read`` function: the
    module ``metrics/<name>.py`` beside it, else ``readers/<reader>``."""
    out = {}
    d = os.path.join(HERE, "metrics")
    for fn in sorted(os.listdir(d)):
        if not fn.endswith(".json"):
            continue
        m = _load_json("metrics", fn)
        own = os.path.join(d, m["name"] + ".py")
        path = own if os.path.exists(own) else os.path.join(
            HERE, "readers", m["reader"] + ".py")
        spec = importlib.util.spec_from_file_location(
            "phasebench_metric_" + m["name"].replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[m["name"]] = dict(m, read=mod.read)
    return out


def card_line() -> str:
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable: {exc}"


def sampled_jobs(cell: dict, seed: int) -> List[int]:
    """Indices of the jobs held to the reference: the window's first and
    ``check.jobs - 1`` more drawn from the seed among its first
    ``check.first_jobs``."""
    chk = cell["check"]
    rng = random.Random(seed)
    more = rng.sample(range(1, chk["first_jobs"]),
                      min(chk["jobs"] - 1, chk["first_jobs"] - 1))
    return sorted({0, *more})


# the host's math-library pools, at one thread: the program runs its own
# ``threads`` phase workers, and a BLAS or OpenMP pool in each of them
# oversubscribes the cores (PERF.md, PR 13: job seconds spread less and
# records/s rose in each of three alternating pairs)
HOST_POOLS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def pin_host_pools() -> None:
    """Set before numpy or torch is imported."""
    for k in HOST_POOLS:
        os.environ[k] = "1"


def cache_dirs() -> None:
    """Kernel caches at fixed paths inside the checkout."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build",
                                                  "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(
        ROOT, "build", "torch_extensions")


def log(*a) -> None:
    print(*a, flush=True)


def _range(trace: bool, name: str):
    """A profiler range ``phasebench.<name>`` in a traced run."""
    if not trace:
        return contextlib.nullcontext()
    import torch
    return torch.profiler.record_function("phasebench." + name)


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", workers: Optional[int] = None,
             started: Optional[float] = None) -> dict:
    """Set up, run the window, judge; returns the result line's object.
    ``device`` other than cuda is for the CPU tests: such a run's
    metrics hold no device number.  The log has each job's seconds and
    the reference's seconds by kind of step."""
    import dataclasses

    import torch

    from ahsoka_tpu_torch.config import PhasingConfig
    from ahsoka_tpu_torch.pipeline import run_phase

    from phasebench import judge
    from phasebench.capture import Capture
    from phasebench.jobs import (job_chains, make_pool, ploidy_map_path,
                                 read_ploidy_map)
    from phasebench.reference import phase as R
    from phasebench.reference.config import PhasingConfig as RefConfig

    started = process_start() if started is None else started
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.zeros(1, device=dev).sum().item()
    threads = min(os.cpu_count() or 1, 8)
    settings = dict(cell["config"]["settings"], threads=threads)
    cfg = PhasingConfig(**settings)
    workers = threads if workers is None else workers
    log(f"host: {os.cpu_count()} cores, {threads} phase threads, "
        f"{torch.get_num_threads()} torch intra-op threads, "
        + ", ".join(f"{k}={os.environ.get(k)}" for k in HOST_POOLS))
    workdir = tempfile.mkdtemp(prefix=f"phasebench-{cell['name']}-")
    try:
        pool_idx = [-1] + list(range(cell["pool_jobs"]))
        t = time.perf_counter()
        planted = cell["config"].get("ploidy_map") == "planted"
        paths = make_pool(cell["shape"], seed, pool_idx, workdir, workers,
                          planted=settings if planted else None,
                          warmup_shape=cell.get("warmup_shape"))
        # written back to disk now, not during the window
        os.sync()
        log(f"pool: {cell['pool_jobs']} jobs and a warm-up job generated "
            f"and synced in {time.perf_counter() - t:.3f} s by {workers} "
            "processes")
        # each job's ploidy map, read before any job's timer starts
        pmaps = [read_ploidy_map(ploidy_map_path(gfa)) if planted else None
                 for gfa, _gaf in paths]
        cfgs = [dataclasses.replace(cfg, ploidy_map=pm) if pm else cfg
                for pm in pmaps]
        warm, pool = paths[0], paths[1:]
        capture = Capture()
        capture.install()
        capture.start(False)
        t = time.perf_counter()
        run_phase(warm[0], warm[1], os.path.join(workdir, "warmup"),
                  config=cfgs[0], device=dev, keep_going=True)
        if cuda:
            torch.cuda.synchronize(dev)
        log(f"warm-up job: {time.perf_counter() - t:.3f} s")
        sample = sampled_jobs(cell, seed)
        metrics_meta = load_metrics() if trace else {}
        prof = None
        if trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
            capture.annotate = True
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        jobs: List[dict] = []
        recorded: Dict[int, tuple] = {}
        setup_s = time.time() - started
        t0 = time.perf_counter()
        with _range(trace, "window"):
            for i, (gfa, gaf) in enumerate(pool):
                if jobs and time.perf_counter() - t0 >= seconds:
                    break
                outstem = os.path.join(workdir, f"job{i}", "out")
                capture.start(i in sample)
                tj = time.perf_counter()
                art, error, m = None, "", None
                try:
                    with _range(trace, "job"):
                        art = run_phase(gfa, gaf, outstem,
                                        config=cfgs[i + 1], device=dev,
                                        keep_going=True)
                    if cuda:
                        torch.cuda.synchronize(dev)
                except Exception as exc:  # noqa: BLE001 - counted failed
                    error = f"{type(exc).__name__}: {exc}"
                end = time.perf_counter()
                if not error:
                    with open(f"{outstem}-metrics.json") as fh:
                        m = json.load(fh)
                jobs.append(dict(index=i, seconds=end - tj, end=end,
                                 error=error, metrics=m, gfa=gfa,
                                 outstem=outstem))
                if i in sample:
                    recorded[i] = (gfa, gaf, outstem, art, capture.chains)
            else:
                log(f"pool exhausted: all {len(pool)} jobs ran before the "
                    f"window's {seconds} s passed")
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        trace_obj = None
        if prof is not None:
            prof.__exit__(None, None, None)
            capture.annotate = False
            path = os.path.join(workdir, "trace.json")
            prof.export_chrome_trace(path)
            del prof
            from phasebench.trace import Trace
            trace_obj = Trace(path)
            log("DP kernels in the trace (s): " + json.dumps(
                {k: v for k, v in trace_obj.kernel_s.items()
                 if k.startswith("dpk_")}))
        capture.uninstall()
        del art, capture
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        n_chains = job_chains(cell["shape"])
        attempted = sum(j["metrics"]["num_chains"] if j["metrics"]
                        else n_chains for j in jobs)
        failed = sum(j["metrics"]["chains_failed"] if j["metrics"]
                     else n_chains for j in jobs)
        records = sum(j["metrics"]["gaf_records"] for j in jobs
                      if j["metrics"])
        from phasebench.stats import rate
        job_s = [j["seconds"] for j in jobs]
        rps = rate(records, t0, [j["end"] for j in jobs])
        log(f"window: {len(jobs)} jobs in "
            f"{max(j['end'] for j in jobs) - t0:.3f} s of {seconds} s; "
            f"{records} records; pool {len(pool)}")
        log(f"records/s over the window: {rps!r}; {len(job_s)} jobs")
        log("job seconds: " + json.dumps(job_s))
        for j in jobs:
            if j["error"]:
                log(f"job {j['index']} raised: {j['error']}")
        stage_sums: Dict[str, float] = {}
        for j in jobs:
            for k, v in (j["metrics"] or {}).get("stage_seconds",
                                                 {}).items():
                if isinstance(v, (int, float)):
                    stage_sums[k] = stage_sums.get(k, 0.0) + v
        log("stage seconds summed over the window's jobs: "
            + json.dumps(stage_sums))

        # the reference, after the window and the peak reading
        rconfig = RefConfig(**settings)
        ref_dev = dev if cuda else None
        t = time.perf_counter()
        tasks = []
        staged = threaded = 0
        for j in jobs:
            i = j["index"]
            if i not in recorded:
                tasks.append(judge.Task(j["gfa"], None,
                                        judge.from_files(j["outstem"]),
                                        True, (), ()))
                continue
            gfa, gaf, outstem, art_i, chains = recorded.pop(i)
            order = R.load_job(gfa, None, rconfig).size_sorting
            ids = judge.sample_chains(order, seed + i,
                                      cell["check"]["chains"])
            produced = judge.from_program(outstem, art_i, chains)
            tasks += judge.tasks_of_job(gfa, gaf, produced, ids,
                                        ploidy_map=pmaps[i + 1])
            staged += len(ids)
            threaded += len(produced.chains)
        for i in sample:
            if i not in {j["index"] for j in jobs}:
                log(f"sampled job {i} was not reached in the window")
        parts: Dict[str, float] = {}
        numbers = judge.judge_tasks(tasks, rconfig, workers,
                                    device=ref_dev, seconds=parts)
        del tasks
        ref_s = time.perf_counter() - t
        log(f"reference: the files of {len(jobs)} jobs, the paths of "
            f"{threaded} chains and the stages of {staged} chains of "
            f"{len(sample)} sampled jobs checked in {ref_s:.3f} s; of "
            "it, in this process: " + json.dumps(parts))
        unchecked = {k: numbers.pop(k, 0) for k in judge.UNCHECKED}
        if not staged:
            numbers["chains_missing"] = numbers.get("chains_missing", 0) + 1
        # every chain of every window job has reads and bubbles to phase
        numbers["chains_unphased"] = sum(
            n_chains - (j["metrics"]["chains_phased"] if j["metrics"] else 0)
            for j in jobs)
        limits = cell["limits"]
        checks = {k: {"value": v, "limit": judge.limit_of(k, limits)}
                  for k, v in numbers.items()}
        correct = judge.verdict(numbers, limits) and failed == 0

        if trace:
            ctx = dict(jobs=[j["metrics"] for j in jobs if j["metrics"]],
                       job_seconds=job_s, trace=trace_obj,
                       config=cell["config"], records=records,
                       window_start=t0, job_ends=[j["end"] for j in jobs])
            metrics = {}
            for name, meta in metrics_meta.items():
                if not reported_in(meta, cell):
                    continue
                if name.startswith(("kernels.", "device.")) and not cuda:
                    continue
                v = meta["read"](ctx, meta)
                if v is not None:
                    metrics[name] = {"value": v, "unit": meta["unit"]}
        else:
            metrics = {
                "records_per_s": rps,
                "peak_device_gib": peak / 2 ** 30,
                "setup_s": setup_s,
            }
            metrics = {k: {"value": metrics[k], "unit": END_TO_END_UNITS[k]}
                       for k in end_to_end(cell)
                       if cuda or k != "peak_device_gib"}
        result = {"correct": bool(correct), "attempted": attempted,
                  "failed": failed, "metrics": metrics,
                  "device": {"platform": "gpu" if cuda else dev.type,
                             "kind": (torch.cuda.get_device_name(dev)
                                      if cuda else dev.type),
                             "count": 1, "memory_peak_bytes": peak}}
        if trace_obj is not None:
            result["device"]["busy_s"] = trace_obj.busy_s
            result["device"]["window_s"] = trace_obj.window_s
            result["breakdown"] = {"device_ops": trace_obj.device_ops(),
                                   "idle_gaps": trace_obj.idle_gaps()}
        result["unchecked"] = unchecked
        result["checks"] = checks
        return result
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    started = process_start()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    pin_host_pools()
    cell = load_cell(args.workload)
    cache_dirs()
    import torch
    torch.set_num_threads(1)

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"phasebench: the cell needs {cell['chips']} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    # the program is imported before anything is printed: a checkout
    # without it prints nothing to standard output
    import ahsoka_tpu_torch.pipeline  # noqa: F401
    log("card: " + card_line())
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      started=started)
    found = forbidden_modules(sys.modules)
    if found:
        print(f"phasebench: modules loaded that may not be: {found}",
              file=sys.stderr)
        return 3
    for k, v in result["unchecked"].items():
        print(f"unchecked {k} = {v!r} (not a fault)", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
