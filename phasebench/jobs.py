"""The job pool: each job is one slice of the configuration's genome,
its own GFA and GAF, generated from the run's seed in worker processes.
This module imports neither torch nor the program, so that the workers
it starts stay off the card."""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import List, Tuple

from phasebench.synth import SynthSpec, write_synthetic

SHAPE_KEYS = ("num_chains", "bubbles_per_chain", "reads_per_hap", "ploidy",
              "span", "identity", "error_rate")


def job_seed(seed: int, index: int) -> int:
    """The seed of job ``index`` of a run (index -1: the warm-up job)."""
    return seed * 1_000_003 + index + 1


def job_spec(shape: dict, seed: int, index: int) -> SynthSpec:
    return SynthSpec(seed=job_seed(seed, index),
                     **{k: shape[k] for k in SHAPE_KEYS})


def _write(args) -> Tuple[str, str]:
    shape, seed, index, workdir = args
    d = os.path.join(workdir, f"job{index}")
    os.makedirs(d, exist_ok=True)
    gfa, gaf = os.path.join(d, "graph.gfa"), os.path.join(d, "reads.gaf")
    write_synthetic(gfa, gaf, job_spec(shape, seed, index))
    return gfa, gaf


def make_pool(shape: dict, seed: int, indices: List[int], workdir: str,
              workers: int) -> List[Tuple[str, str]]:
    """(GFA, GAF) paths of the jobs ``indices``, written under
    ``workdir`` by ``workers`` spawned processes."""
    tasks = [(shape, seed, i, workdir) for i in indices]
    if workers <= 1:
        return [_write(t) for t in tasks]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as pool:
        return list(pool.map(_write, tasks))
