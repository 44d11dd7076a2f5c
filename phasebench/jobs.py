"""The job pool: each job is one slice of the configuration's genome,
its own GFA and GAF, generated from the run's seed in worker processes.
This module imports neither torch nor the program, so that the workers
it starts stay off the card.

A job's shape is either the seven ``SHAPE_KEYS`` (uniform chains) or,
where it holds a ``plan`` (``PLAN_KEYS``), a ragged chain plan that each
job draws from its own seed (``synth.chain_plan``), or that the plan's
``chains`` list of [bubbles, ploidy] fixes; a plan-shaped job also gets
its truth file beside its GAF.  Where the configuration plants
the ploidy map (``"ploidy_map": "planted"``), each job's map is derived
here from the reference's own parse of its GFA and its truth file, and
written beside it as a user's ``--ploidy-map`` file is."""

from __future__ import annotations

import json
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List, Optional, Tuple

from phasebench.synth import (SynthSpec, chain_plan, ploidy_map_from_truth,
                              write_synthetic)

SHAPE_KEYS = ("num_chains", "bubbles_per_chain", "reads_per_hap", "ploidy",
              "span", "identity", "error_rate")
PLAN_KEYS = ("num_chains", "min_bubbles", "max_bubbles", "ploidy_mix",
             "coverage_per_hap", "chains")
# what a plan-shaped job takes of the shape keys; the plan sets the rest
PLAN_SHAPE_KEYS = ("span", "identity", "error_rate")


def job_seed(seed: int, index: int) -> int:
    """The seed of job ``index`` of a run (index -1: the warm-up job)."""
    return seed * 1_000_003 + index + 1


def job_spec(shape: dict, seed: int, index: int) -> SynthSpec:
    s = job_seed(seed, index)
    plan = shape.get("plan")
    if plan is None:
        return SynthSpec(seed=s, **{k: shape[k] for k in SHAPE_KEYS})
    chains = [tuple(c) for c in plan["chains"]] if "chains" in plan \
        else chain_plan(plan["num_chains"], plan["min_bubbles"],
                        plan["max_bubbles"], plan["ploidy_mix"], s)
    return SynthSpec(
        seed=s, chain_plan=chains, coverage_per_hap=plan["coverage_per_hap"],
        **{k: shape[k] for k in PLAN_SHAPE_KEYS})


def job_chains(shape: dict) -> int:
    """The number of chains a job of ``shape`` has."""
    plan = shape.get("plan")
    if plan is None:
        return shape["num_chains"]
    return len(plan["chains"]) if "chains" in plan else plan["num_chains"]


def truth_path(gfa: str) -> str:
    return os.path.join(os.path.dirname(gfa), "truth.txt")


def ploidy_map_path(gfa: str) -> str:
    return os.path.join(os.path.dirname(gfa), "ploidy_map.json")


def read_ploidy_map(path: str) -> Dict[int, int]:
    """A ``--ploidy-map`` JSON file: {chain id: ploidy}."""
    with open(path) as fh:
        return {int(c): int(k) for c, k in json.load(fh).items()}


def _write(args) -> Tuple[str, str]:
    shape, seed, index, workdir, planted = args
    d = os.path.join(workdir, f"job{index}")
    os.makedirs(d, exist_ok=True)
    gfa, gaf = os.path.join(d, "graph.gfa"), os.path.join(d, "reads.gaf")
    truth = truth_path(gfa) if "plan" in shape else None
    write_synthetic(gfa, gaf, job_spec(shape, seed, index), truth)
    if planted is not None:
        from phasebench.reference import phase as R
        from phasebench.reference.config import PhasingConfig
        paths = R.load_job(gfa, None, PhasingConfig(**planted)).allele_paths
        pmap = ploidy_map_from_truth(paths, truth)
        with open(ploidy_map_path(gfa), "w") as fh:
            json.dump({str(c): k for c, k in sorted(pmap.items())}, fh)
    return gfa, gaf


def make_pool(shape: dict, seed: int, indices: List[int], workdir: str,
              workers: int, planted: Optional[dict] = None,
              warmup_shape: Optional[dict] = None) -> List[Tuple[str, str]]:
    """(GFA, GAF) paths of the jobs ``indices``, written under
    ``workdir`` by ``workers`` spawned processes.  ``planted``: the run's
    settings, where each job's ploidy map is planted; ``warmup_shape``:
    the warm-up job's (index -1) shape, where it has its own."""
    tasks = [(warmup_shape if i == -1 and warmup_shape else shape, seed,
              i, workdir, planted) for i in indices]
    if workers <= 1:
        return [_write(t) for t in tasks]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as pool:
        return list(pool.map(_write, tasks))
