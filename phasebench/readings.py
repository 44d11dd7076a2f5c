"""The readings that the limits of ``correct`` are set from, on the card,
at a cell's own size.

    python -m phasebench.readings --workload <cell> --seeds 1,2,... \\
        [--control-seeds 7,8,9] [--fault-seeds 7,8,9]

For each seed of ``--seeds`` it generates the jobs a run of that seed
would hold to the reference (the same job seeds and chain samples),
phases them through ``run_phase`` and judges them: the program's
readings, from which each limit's lower reading comes.  For each seed of
``--control-seeds`` it judges the control in the program's place: the
plain reference with its score GEMMs in TF32, the precision below the
program's float32.  For each seed of ``--fault-seeds`` it judges the
program with an answer altered where it is produced: at the middle
position of each DP path, every haplotype takes the first haplotype's
cluster.  One JSON
line a seed, then a summary: the largest program reading and the
smallest control and fault readings of each number.  It also counts
the sampled chains whose clusters the reference's solver, fed its own
float64 scores, would have drawn otherwise (``own_cluster_diff``): the
stage that feeding it the program's scores skips.

For each seed of ``--witness-seeds`` it runs the reference alone, with
no program, on the chains a run of that seed samples (``--witness-check
jobs,first_jobs,chains`` sets the sample, by default the cell's), and
counts the chains whose clusters change when the solver's float64
scores are replaced by the same scores rounded to float32
(``rounded32``), moved by one float32 ulp up or down at random, drawn
from the seed (``ulp``), or computed with float32 GEMMs (``gemm32``):
whether the solver turns on differences at float32 resolution.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile


def _seeds(text):
    return [int(x) for x in text.split(",") if x.strip()] if text else []


def altered_paths(orig):
    """``thread_chains_batched`` with, at each path's middle position,
    every haplotype on the first haplotype's cluster."""
    def wrapped(*a, **kw):
        paths = orig(*a, **kw)
        out = []
        for p in paths:
            p = list(p)
            if p:
                j = len(p) // 2
                p[j] = (p[j][0],) * len(p[j])
            out.append(p)
        return out
    return wrapped


def witness_flips(job, cid, rcfg, seed, device) -> dict:
    """For one chain: 1 for each replacement of the solver's float64
    scores that changes its clusters (see the module's docstring)."""
    import numpy as np

    from phasebench.reference import phase as R
    from phasebench.reference.editing import cluster_editing

    ccfg = R.chain_config(rcfg, cid)
    m = R.chain_matrix(job, cid, ccfg)
    if m is None:
        return {}
    cm = R.chain_collapse(m, ccfg)
    if R.is_banded(m, cm, ccfg):
        return {}
    s64 = R.chain_scores(m, cm, rcfg)

    def solve(scores):
        return cluster_editing(R.solver_weights(scores, cm),
                               mode=rcfg.ce_mode, device=device)

    base = solve(s64)
    rng = np.random.default_rng([seed, cid])
    step = rng.choice([-1.0, 1.0], size=s64.shape) * np.spacing(
        np.abs(s64).astype(np.float32)).astype(np.float64)
    step = np.triu(step, 1)
    moved = np.where(s64 != 0, s64 + step + step.T, 0.0)
    return {"chains": 1,
            "rounded32": int(solve(s64.astype(np.float32)
                                   .astype(np.float64)) != base),
            "ulp": int(solve(moved) != base),
            "gemm32": int(solve(R.chain_scores(m, cm, rcfg,
                                               gemm="float32")) != base)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--witness-seeds", default="")
    ap.add_argument("--witness-check", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from phasebench.run import cache_dirs, card_line, load_cell, \
        pin_host_pools, sampled_jobs
    pin_host_pools()
    cache_dirs()
    import torch
    torch.set_num_threads(1)

    from ahsoka_tpu_torch.config import PhasingConfig
    from ahsoka_tpu_torch.pipeline import run_phase
    from ahsoka_tpu_torch.thread import dp_torch

    from phasebench import judge
    from phasebench.capture import Capture
    from phasebench.jobs import make_pool, ploidy_map_path, read_ploidy_map
    from phasebench.reference import phase as R
    from phasebench.reference.config import PhasingConfig as RefConfig
    from phasebench.reference.editing import cluster_editing

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("readings: no card", file=sys.stderr)
        return 2
    print("card: " + card_line(), flush=True)
    cell = load_cell(args.workload)
    threads = min(os.cpu_count() or 1, 8)
    settings = dict(cell["config"]["settings"], threads=threads)
    planted = cell["config"].get("ploidy_map") == "planted"
    summary: dict = {}
    capture = Capture()
    capture.install()

    def note(kind, seed, numbers, extra=None):
        line = dict(kind=kind, seed=seed, numbers=numbers, **(extra or {}))
        print(json.dumps(line), flush=True)
        for k, v in numbers.items():
            s = summary.setdefault(kind, {})
            s[k] = (max if kind == "program" else min)(s.get(k, v), v)

    runs = ([("program", s) for s in _seeds(args.seeds)]
            + [("control", s) for s in _seeds(args.control_seeds)]
            + [("fault", s) for s in _seeds(args.fault_seeds)]
            + [("witness", s) for s in _seeds(args.witness_seeds)])
    wcell = dict(cell)
    if args.witness_check:
        j, f, c = (int(x) for x in args.witness_check.split(","))
        wcell["check"] = dict(jobs=j, first_jobs=f, chains=c)
    orig_dp = dp_torch.thread_chains_batched
    for kind, seed in runs:
        work = tempfile.mkdtemp(prefix="phasebench-readings-")
        try:
            use = wcell if kind == "witness" else cell
            idx = sampled_jobs(use, seed)
            paths = make_pool(cell["shape"], seed, idx, work, threads,
                              planted=settings if planted else None)
            numbers: dict = {}
            own = 0
            ref_dev = dev if dev.type == "cuda" else None
            def configs(gfa):
                # the job's own ploidy map, where the cell plants one
                pm = read_ploidy_map(ploidy_map_path(gfa)) if planted \
                    else None
                return (PhasingConfig(**dict(settings, ploidy_map=pm)),
                        RefConfig(**dict(settings, ploidy_map=pm)))

            if kind == "witness":
                flips = {"chains": 0, "rounded32": 0, "ulp": 0,
                         "gemm32": 0}
                for i, (gfa, gaf) in zip(idx, paths):
                    _cfg, rcfg = configs(gfa)
                    job = R.load_job(gfa, gaf, rcfg)
                    for cid in judge.sample_chains(
                            job.size_sorting, seed + i,
                            use["check"]["chains"]):
                        for k, v in witness_flips(job, cid, rcfg, seed,
                                                  ref_dev).items():
                            flips[k] += v
                print(json.dumps(dict(kind=kind, seed=seed, **flips)),
                      flush=True)
                s = summary.setdefault("witness", {})
                for k, v in flips.items():
                    s[k] = s.get(k, 0) + v
                continue
            for i, (gfa, gaf) in zip(idx, paths):
                cfg, rcfg = configs(gfa)
                job = R.load_job(gfa, gaf, rcfg)
                ids = judge.sample_chains(job.size_sorting, seed + i,
                                          cell["check"]["chains"])
                if kind == "control":
                    produced = judge.from_reference(job, ids, rcfg, "tf32",
                                                    device=ref_dev)
                else:
                    if kind == "fault":
                        dp_torch.thread_chains_batched = \
                            altered_paths(orig_dp)
                    outstem = os.path.join(work, f"job{i}", "out")
                    capture.start(True)
                    try:
                        art = run_phase(gfa, gaf, outstem, config=cfg,
                                        device=dev, keep_going=True)
                    finally:
                        dp_torch.thread_chains_batched = orig_dp
                    produced = judge.from_program(outstem, art,
                                                  capture.chains)
                    if kind == "program":
                        for cid in ids:
                            out = produced.chains[cid]
                            if out.banded:
                                continue
                            ccfg = R.chain_config(rcfg, cid)
                            m = R.chain_matrix(job, cid, ccfg)
                            cm = R.chain_collapse(m, ccfg)
                            w = R.solver_weights(
                                R.chain_scores(m, cm, rcfg), cm)
                            own += int(cluster_editing(
                                w, mode=rcfg.ce_mode, device=ref_dev)
                                != out.clusters)
                judge.merge(numbers, judge.judge_job(job, produced, ids,
                                                     rcfg, device=ref_dev))
            note(kind, seed, numbers,
                 {"own_cluster_diff": own} if kind == "program" else None)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    capture.uninstall()
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
