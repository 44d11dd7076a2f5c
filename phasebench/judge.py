"""Decide ``correct``: hold what a job produced to the plain reference.

Every job of the window is checked where the graph alone decides: its
``-bubbleinfo.txt`` and the chain order and sizes of its
``-result.txt``, against the reference's parse of the job's GFA.  In
the jobs sampled from the seed, every chain that the program threaded
is checked from its DP inputs on:

- the DP path: its cost under the reference's objective against the
  reference's least cost over the same inputs (``dp_cost_gap``,
  relative); a path of equal cost that differs in a tie is no fault;
- the chain's result file and its section of ``-result.txt``, against
  the reference's emission of that path (exact).

A sample of those chains, drawn from the seed, is checked stage by stage
from the job's GFA and GAF on:

- the allele matrix after the coverage cap, and the identical-row
  collapse (exact);
- the pair scores, against the reference's float64 scores of the
  reference's matrix (``score_gap``: the largest |difference| over
  max(1, |reference|));
- the clusters: the reference's solver run on the weights the program's
  scores give (exact).  The program computes its scores in float32, and
  the greedy solver turns on near-ties that float32 rounding decides
  (``phasebench.readings --witness-seeds`` shows it without the
  program), so it is fed the program's scores once ``score_gap`` has
  held them to the reference's;
- the DP inputs built from the reference's matrix and those clusters
  (exact), which the path and file checks above then start from.

``Produced`` holds one job's outputs, whoever made them: the program
(``from_program``) or the reference itself at a lower precision, the
control (``from_reference``).  ``check_job`` does all but the solver
and runs in worker processes; ``finish_chain`` runs the solver, on the
card where there is one, in the process that holds it.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import random
from concurrent.futures import ProcessPoolExecutor, as_completed
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from phasebench.reference import phase as R
from phasebench.reference.collapse import CollapsedReads, expand_clusters
from phasebench.reference.config import PhasingConfig
from phasebench.reference.editing import cluster_editing
from phasebench.reference.pairwise import AlleleMatrix
from phasebench.reference.postprocess import DPInputs

DP_FIELDS = ("positions", "candidates", "num_candidates", "coverage",
             "consensus", "genotypes")
# a path that is no path (a cluster that is no candidate) reads this gap
NO_PATH = 1.0e9
EXACT = ("chains_unphased", "chains_missing", "bubbles_diff", "matrix_diff", "cluster_diff",
         "dp_inputs_diff", "files_diff")
# worker tasks a job's dp chains are cut into, so that they spread
DP_TASKS = 3


@dataclasses.dataclass
class ChainOut:
    matrix: object = None
    collapse: object = None
    scores: Optional[np.ndarray] = None
    weights: Optional[np.ndarray] = None
    clusters: Optional[List[List[int]]] = None
    dp: object = None
    path: Optional[list] = None
    chain_file: Optional[str] = None
    banded: bool = False


@dataclasses.dataclass
class Produced:
    """One job's outputs: the job-level files and the recorded chains
    (``allele_paths`` None where the job was not recorded)."""
    bubbleinfo: str
    allele_paths: Optional[dict]
    result_txt: str
    chains: Dict[int, ChainOut]


def aggregate_sections(result_txt: str) -> Dict[int, tuple]:
    """{chain id: (size, [haplotype lines])} of a ``-result.txt``, and
    the chain order under the key -1."""
    out: Dict[int, tuple] = {}
    order = []
    cur = None
    for line in result_txt.splitlines(keepends=True):
        if line.startswith("chain id: "):
            cur = int(line[len("chain id: "):])
            order.append(cur)
            out[cur] = [None, []]
        elif line.startswith("size of chain: "):
            out[cur][0] = int(line[len("size of chain: "):])
        elif line.startswith("haplotype "):
            continue
        elif cur is not None:
            out[cur][1].append(line)
    result = {c: (v[0], v[1]) for c, v in out.items()}
    result[-1] = tuple(order)
    return result


def _read(path):
    try:
        with open(path) as fh:
            return fh.read()
    except FileNotFoundError:
        return None


def _plain_matrix(m):
    return None if m is None else AlleleMatrix(
        alleles=np.asarray(m.alleles), positions=np.asarray(m.positions),
        read_names=list(m.read_names))


def _plain_collapse(cm):
    return None if cm is None else CollapsedReads(
        matrix=_plain_matrix(cm.matrix), inverse=np.asarray(cm.inverse),
        mult=np.asarray(cm.mult))


def _plain_dp(dp):
    return None if dp is None else DPInputs(
        **{f: np.asarray(getattr(dp, f)) for f in DP_FIELDS})


def from_program(outstem: str, art, capture_chains) -> Produced:
    """The program's outputs of one recorded job, every recorded chain
    in the reference's own types (so that a worker process reads them
    without the program)."""
    dps = art.threading["dps"] if art is not None else []
    paths = art.threading["paths"] if art is not None else []
    path_of = {id(dp): p for dp, p in zip(dps, paths)}
    chains = {}
    for cid, rec in capture_chains.items():
        path = path_of.get(id(rec.dp))
        chains[cid] = ChainOut(
            matrix=_plain_matrix(rec.matrix),
            collapse=_plain_collapse(rec.collapse),
            scores=None if rec.scores is None else np.asarray(rec.scores),
            weights=(None if rec.weights is None
                     else np.asarray(rec.weights)),
            clusters=rec.clusters, dp=_plain_dp(rec.dp),
            path=None if path is None else [tuple(int(c) for c in t)
                                            for t in path],
            banded=rec.banded,
            chain_file=_read(f"{outstem}-chain{cid}-result.txt"))
    return Produced(bubbleinfo=_read(f"{outstem}-bubbleinfo.txt") or "",
                    allele_paths=(art.allele_paths if art is not None
                                  else {}),
                    result_txt=_read(f"{outstem}-result.txt") or "",
                    chains=chains)


def from_files(outstem: str) -> Produced:
    """The job-level files of a job that was not recorded."""
    return Produced(bubbleinfo=_read(f"{outstem}-bubbleinfo.txt") or "",
                    allele_paths=None,
                    result_txt=_read(f"{outstem}-result.txt") or "",
                    chains={})


def from_reference(job: "R.Job", chain_ids, config: PhasingConfig,
                   gemm: str, device=None) -> Produced:
    """The reference in the program's place, its score GEMMs at ``gemm``
    (the control: ``"tf32"``), on the chains ``chain_ids``."""
    chains = {}
    result_lines = []
    for size, cid in job.size_sorting:
        result_lines += [f"chain id: {cid}\n", f"size of chain: {size}\n"]
        if cid not in chain_ids:
            continue
        m = R.chain_matrix(job, cid, config)
        cm = R.chain_collapse(m, config)
        s = R.chain_scores(m, cm, config, gemm=gemm)
        w = R.solver_weights(s, cm)
        cl = cluster_editing(w, mode=config.ce_mode, device=device)
        read_cl = cl if cm is None else expand_clusters(cl, cm.inverse)
        dp = R.dp_inputs(m, read_cl, config)
        path, _cost = R.best_path(dp, config, R.dp_costs(dp, config))
        lines = R.result_lines(job, cid, dp, path, config.ploidy)
        for i, line in enumerate(lines):
            result_lines += [f"haplotype {i}:\n", line]
        chains[cid] = ChainOut(matrix=m, collapse=cm, scores=s, weights=w,
                               clusters=cl, dp=dp, path=path,
                               chain_file="".join(lines))
    return Produced(bubbleinfo=job.bubbleinfo, allele_paths=job.allele_paths,
                    result_txt="".join(result_lines), chains=chains)


def sample_chains(size_sorting, seed: int, n: int) -> List[int]:
    """``n`` chain ids of a job's chain order, drawn from ``seed``."""
    ids = [cid for _size, cid in size_sorting]
    return sorted(random.Random(seed).sample(ids, min(n, len(ids))))


def _same_matrix(a, b) -> bool:
    return (a is not None and b is not None
            and np.array_equal(a.alleles, b.alleles)
            and np.array_equal(a.positions, b.positions)
            and list(a.read_names) == list(b.read_names))


def _same_collapse(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return (_same_matrix(a.matrix, b.matrix)
            and np.array_equal(a.inverse, b.inverse)
            and np.array_equal(a.mult, b.mult))


def zero() -> Dict[str, float]:
    n: Dict[str, float] = {k: 0 for k in EXACT}
    n["score_gap"] = 0.0
    n["dp_cost_gap"] = 0.0
    return n


@dataclasses.dataclass
class Task:
    """One worker's share of a job: the job-level files (``job_level``),
    the path and file checks of ``dp_ids`` and the stages of
    ``stage_ids`` before the solver.  ``gaf`` is None where no stage is
    checked: the graph decides the rest."""
    gfa: str
    gaf: Optional[str]
    produced: Produced
    job_level: bool
    dp_ids: Sequence[int]
    stage_ids: Sequence[int]


@dataclasses.dataclass
class Pending:
    """A stage chain's solver step, left for ``finish_chain``."""
    weights: np.ndarray
    matrix: AlleleMatrix
    collapse: Optional[CollapsedReads]
    clusters: Optional[List[List[int]]]
    dp: DPInputs


def check_job(task: Task, config: PhasingConfig, job: "R.Job" = None
              ) -> Tuple[Dict[str, float], List[Pending]]:
    """The numbers of one task, and its stage chains' solver steps."""
    if job is None:
        job = R.load_job(task.gfa, task.gaf, config)
    produced = task.produced
    n = zero()
    sections = aggregate_sections(produced.result_txt)
    if task.job_level:
        n["bubbles_diff"] += int(produced.bubbleinfo != job.bubbleinfo)
        if produced.allele_paths is not None:
            n["bubbles_diff"] += int(produced.allele_paths
                                     != job.allele_paths)
        n["files_diff"] += int(sections[-1] != tuple(
            c for _s, c in job.size_sorting))
        n["files_diff"] += sum(int(sections.get(c, (None,))[0] != size)
                               for size, c in job.size_sorting)
    for cid in task.dp_ids:
        out = produced.chains.get(cid)
        if out is None or out.dp is None or out.path is None:
            n["chains_missing"] += 1
            continue
        dp = out.dp
        costs = R.dp_costs(dp, config)
        _best, best_cost = R.best_path(dp, config, costs)
        states = R.path_states(dp, out.path, config.ploidy) \
            if len(out.path) == dp.num_positions else None
        if states is None:
            n["dp_cost_gap"] = NO_PATH
            continue
        cost = R.path_cost(costs, states)
        n["dp_cost_gap"] = max(n["dp_cost_gap"], (cost - best_cost)
                               / max(1.0, abs(best_cost)))
        lines = R.result_lines(job, cid, dp, out.path, config.ploidy)
        size, section = sections.get(cid, (None, []))
        if out.chain_file != "".join(lines) or section != lines \
                or size != len(job.allele_paths[cid]):
            n["files_diff"] += 1
    pending = []
    for cid in task.stage_ids:
        out = produced.chains.get(cid)
        if out is None or out.matrix is None or out.dp is None \
                or out.banded:
            # a banded chain is one the reference here cannot solve
            n["chains_missing"] += 1
            continue
        m = R.chain_matrix(job, cid, config)
        cm = R.chain_collapse(m, config)
        if not _same_matrix(m, out.matrix) \
                or not _same_collapse(cm, out.collapse):
            n["matrix_diff"] += 1
            continue
        s = R.chain_scores(m, cm, config)
        if out.scores is None or out.scores.shape != s.shape:
            n["matrix_diff"] += 1
            continue
        gap = np.abs(np.asarray(out.scores, dtype=np.float64) - s) \
            / np.maximum(1.0, np.abs(s))
        n["score_gap"] = max(n["score_gap"], float(gap.max(initial=0.0)))
        w = R.solver_weights(np.asarray(out.scores, dtype=np.float64), cm)
        if out.weights is None or not np.array_equal(w, out.weights):
            n["cluster_diff"] += 1
            continue
        pending.append(Pending(weights=w, matrix=m, collapse=cm,
                               clusters=out.clusters, dp=out.dp))
    return n, pending


def finish_chain(p: Pending, config: PhasingConfig, device=None
                 ) -> Dict[str, float]:
    """The solver on the program's weights, then the DP inputs from the
    reference's matrix and those clusters."""
    n = zero()
    clusters = cluster_editing(p.weights, mode=config.ce_mode,
                               device=device)
    if clusters != p.clusters:
        n["cluster_diff"] += 1
        return n
    read_cl = clusters if p.collapse is None \
        else expand_clusters(clusters, p.collapse.inverse)
    dp = R.dp_inputs(p.matrix, read_cl, config)
    if not all(np.array_equal(getattr(dp, f), getattr(p.dp, f))
               for f in DP_FIELDS):
        n["dp_inputs_diff"] += 1
    return n


def judge_job(job: "R.Job", produced: Produced, stage_ids,
              config: PhasingConfig, device=None) -> Dict[str, float]:
    """Every check of one loaded job in this process: the job's files,
    the paths and files of every chain ``produced`` holds, and the
    stages of ``stage_ids``."""
    task = Task(gfa="", gaf=None, produced=produced, job_level=True,
                dp_ids=sorted(produced.chains), stage_ids=stage_ids)
    totals, pending = check_job(task, config, job=job)
    for p in pending:
        merge(totals, finish_chain(p, config, device))
    return totals


def tasks_of_job(gfa: str, gaf: str, produced: Produced,
                 stage_ids: Sequence[int]) -> List[Task]:
    """A job's checks cut into worker tasks: one a stage chain (first,
    so that the solver starts early), and its files and dp chains in
    ``DP_TASKS`` tasks."""
    light = dataclasses.replace(produced, chains={
        cid: dataclasses.replace(out, matrix=None, collapse=None,
                                 scores=None, weights=None)
        for cid, out in produced.chains.items()})
    tasks = [Task(gfa, gaf, dataclasses.replace(
        produced, chains={c: produced.chains[c]}
        if c in produced.chains else {}), False, (), (c,))
        for c in stage_ids]
    dp_ids = sorted(produced.chains)
    chunks = [dp_ids[k::DP_TASKS] for k in range(DP_TASKS)]
    for k, chunk in enumerate(chunks):
        tasks.append(Task(gfa, None, dataclasses.replace(
            light, chains={c: light.chains[c] for c in chunk}),
            k == 0, chunk, ()))
    return tasks


def judge_tasks(tasks: Sequence[Task], config: PhasingConfig,
                workers: int, device=None) -> Dict[str, float]:
    """The merged numbers of ``tasks``: ``check_job`` in ``workers``
    spawned processes (one fewer where the solver runs on a card from
    this process, which then keeps a core; none where that leaves 1),
    each solver step here as its task completes."""
    totals = zero()
    if device is not None:
        workers -= 1
    if workers <= 1:
        for t in tasks:
            n, pending = check_job(t, config)
            merge(totals, n)
            for p in pending:
                merge(totals, finish_chain(p, config, device))
        return totals
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as pool:
        futures = [pool.submit(check_job, t, config) for t in tasks]
        for f in as_completed(futures):
            n, pending = f.result()
            merge(totals, n)
            for p in pending:
                merge(totals, finish_chain(p, config, device))
    return totals


def merge(totals: Dict[str, float], n: Dict[str, float]) -> None:
    for k, v in n.items():
        if k in ("score_gap", "dp_cost_gap"):
            totals[k] = max(totals.get(k, 0.0), v)
        else:
            totals[k] = totals.get(k, 0) + v


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit (exact numbers: 0)."""
    return all(numbers[k] <= (0 if k in EXACT else limits[k])
               for k in numbers)


def limit_of(name: str, limits: Dict[str, float]) -> float:
    return 0 if name in EXACT else limits[name]
