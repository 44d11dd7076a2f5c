"""Decide ``correct``: hold what a job produced to the plain reference.

Every job of the window is checked where the graph alone decides: its
``-bubbleinfo.txt`` and the chain order and sizes of its
``-result.txt``, against the reference's parse of the job's GFA.  In
the jobs sampled from the seed, every chain that the program threaded
is checked from its DP inputs on:

- the DP path: its cost under the reference's objective against the
  reference's least cost over the same inputs (``dp_cost_gap``,
  relative); a path of equal cost that differs in a tie is no fault.
  Where the program prunes the DP to a beam (``dp_beam_width`` set and
  the chain's state space larger), the least cost is the plain beam's
  (``reference/dp_beam.py``) and the path's cost is taken along its own
  states;
- the chain's result file and its section of ``-result.txt``, against
  the reference's emission of that path (exact).

Each chain is judged at its own configuration (``R.chain_config``: the
job's ploidy map, else the global ploidy), as the program's batched
driver runs it: the matrix, collapse, banded scoring, DP inputs, DP and
files at the chain's ploidy, the dense scoring at the global one.

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

A sampled chain above ``banded_scoring_threshold`` effective rows (a
banded chain) is checked on its matrix and collapse (exact), its band
and its DP inputs, built from the reference's matrix and the program's
clusters (exact).  The band: the program's edge list holds each pair
once, u < v, both rows of the chain (``edges_diff``, exact), and its
scores are held under ``score_gap`` to the reference's own band
(``reference/banded.py``: every pair that overlaps enough and scores
nonzero, in float64), a pair that one side leaves out reading 0 there:
an edge dropped reads its whole score.  The pair sets are not compared
exactly: a pair whose shared positions all have p_d = p_s scores
about 1e-15 in float64, and 0 or a float32 rounding's worth in float32.  Its clusters come
from the program's native sparse solver, of which no plain copy exists:
such a chain is counted in ``chains_solver_unchecked``, which is
reported and is no fault.

``Produced`` holds one job's outputs, whoever made them: the program
(``from_program``) or the reference itself at a lower precision, the
control (``from_reference``).  ``check_job`` does all but the solver,
the band's scores and the plain beam, and runs in worker processes;
``finish_chain`` runs those, on the card where there is one, in the
process that holds it.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import random
import time
from concurrent.futures import ProcessPoolExecutor, as_completed
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from phasebench.reference import phase as R
from phasebench.reference.banded import band_edges
from phasebench.reference.collapse import CollapsedReads, expand_clusters
from phasebench.reference.config import PhasingConfig
from phasebench.reference.dp_beam import (beam_width, best_beam_path,
                                          path_cost)
from phasebench.reference.editing import cluster_editing
from phasebench.reference.pairwise import AlleleMatrix
from phasebench.reference.postprocess import DPInputs

DP_FIELDS = ("positions", "candidates", "num_candidates", "coverage",
             "consensus", "genotypes")
# a path that is no path (a cluster that is no candidate) reads this gap
NO_PATH = 1.0e9
EXACT = ("chains_unphased", "chains_missing", "bubbles_diff", "matrix_diff",
         "edges_diff", "cluster_diff", "dp_inputs_diff", "files_diff")
# reported beside the checks and never a fault: the sampled banded
# chains whose clusters no plain solver checks
UNCHECKED = ("chains_solver_unchecked",)
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
    # a banded chain's edges (u, v, w) as its scorer returned them
    edges: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None


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
            edges=(None if rec.edges is None
                   else tuple(np.asarray(x) for x in rec.edges)),
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


def chain_path(dp, config: PhasingConfig, device=None):
    """The reference's path of a chain's DP inputs: the plain beam's
    where the program prunes, else the exact least-cost path."""
    bw = beam_width(config)
    if bw:
        states, _cost = best_beam_path(dp, config, bw, device)
        return R.states_path(dp, states, config.ploidy)
    return R.best_path(dp, config, R.dp_costs(dp, config))[0]


def from_reference(job: "R.Job", chain_ids, config: PhasingConfig,
                   gemm: str, device=None) -> Produced:
    """The reference in the program's place, its score GEMMs at ``gemm``
    (the control: ``"tf32"``), on the chains ``chain_ids``, each at its
    own configuration.  A banded chain's edges are the band at ``gemm``;
    no plain copy of the program's sparse solver exists, and the dense
    solver on the band's [R, R] weights takes minutes at 4,096 rows and
    more than a run may at the band's sizes, so its rows go into one
    cluster: its DP inputs and path agree with those by construction,
    and only its band is held."""
    chains = {}
    result_lines = []
    for size, cid in job.size_sorting:
        result_lines += [f"chain id: {cid}\n", f"size of chain: {size}\n"]
        if cid not in chain_ids:
            continue
        ccfg = R.chain_config(config, cid)
        m = R.chain_matrix(job, cid, ccfg)
        cm = R.chain_collapse(m, ccfg)
        s = edges = w = None
        rows = m if cm is None else cm.matrix
        if R.is_banded(m, cm, ccfg):
            edges = band_edges(rows, ccfg, mult=None if cm is None
                               else cm.mult, device=device, gemm=gemm)
            cl = [list(range(rows.num_reads))]
        else:
            s = R.chain_scores(m, cm, config, gemm=gemm)
            w = R.solver_weights(s, cm)
            cl = cluster_editing(w, mode=ccfg.ce_mode, device=device)
        read_cl = cl if cm is None else expand_clusters(cl, cm.inverse)
        dp = R.dp_inputs(m, read_cl, ccfg)
        path = chain_path(dp, ccfg, device)
        lines = R.result_lines(job, cid, dp, path, ccfg.ploidy)
        for i, line in enumerate(lines):
            result_lines += [f"haplotype {i}:\n", line]
        chains[cid] = ChainOut(matrix=m, collapse=cm, scores=s, weights=w,
                               clusters=cl, dp=dp, path=path,
                               chain_file="".join(lines),
                               banded=edges is not None, edges=edges)
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


def rel_gap(got: float, want: float) -> float:
    """(got - want) / max(1, |want|); NO_PATH where ``got`` is no cost."""
    if not np.isfinite(got):
        return NO_PATH
    return (got - want) / max(1.0, abs(want))


def score_gap(got, want: np.ndarray) -> float:
    gap = np.abs(np.asarray(got, dtype=np.float64) - want) \
        / np.maximum(1.0, np.abs(want))
    return float(gap.max(initial=0.0))


def band_gaps(got: tuple, want: tuple, rows: int) -> Tuple[int, float]:
    """A band's ``edges_diff`` and ``score_gap``: ``got``'s edges that
    are no edge (u >= v, a row outside ``rows``, a pair listed twice),
    and the score gap over both edge lists' pairs, a pair missing on
    one side scoring 0 there.  ``want`` is ascending by (u, v)."""
    gu, gv, gw = (np.asarray(x) for x in got)
    wu, wv, ww = want
    ok = (gu < gv) & (gu >= 0) & (gv < rows)
    bad = int((~ok).sum())
    key = gu[ok].astype(np.int64) * rows + gv[ok]
    order = np.argsort(key, kind="stable")
    key, gw = key[order], np.asarray(gw, dtype=np.float64)[ok][order]
    first = np.ones(len(key), bool)
    first[1:] = key[1:] != key[:-1]
    bad += int((~first).sum())
    key, gw = key[first], gw[first]
    wkey = wu.astype(np.int64) * rows + wv
    if not len(wkey):
        return bad, score_gap(gw, np.zeros(len(gw)))
    pos = np.minimum(np.searchsorted(wkey, key), len(wkey) - 1)
    hit = wkey[pos] == key
    missing = np.ones(len(wkey), bool)
    missing[pos[hit]] = False
    gap = max(score_gap(gw, np.where(hit, ww[pos], 0.0)),
              score_gap(np.zeros(int(missing.sum())), ww[missing]))
    return bad, gap


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
    # the job's ploidy map, where it has one
    ploidy_map: Optional[dict] = None


@dataclasses.dataclass
class Pending:
    """A step left for ``finish_chain``, of one of three kinds:
    ``solver`` (a dense stage chain: the solver on ``weights``, then the
    DP inputs), ``band`` (a banded stage chain: its ``edges`` against the
    reference's band, then the DP inputs from the program's
    ``clusters``) and ``beam`` (a beam chain's plain beam, against the
    program path's ``cost``).
    ``config`` is the chain's own."""
    kind: str
    dp: DPInputs
    config: PhasingConfig
    matrix: Optional[AlleleMatrix] = None
    collapse: Optional[CollapsedReads] = None
    weights: Optional[np.ndarray] = None
    clusters: Optional[List[List[int]]] = None
    edges: Optional[tuple] = None
    cost: float = 0.0


def check_job(task: Task, config: PhasingConfig, job: "R.Job" = None
              ) -> Tuple[Dict[str, float], List[Pending]]:
    """The numbers of one task, and the steps it leaves for
    ``finish_chain``."""
    if task.ploidy_map:
        config = dataclasses.replace(config, ploidy_map=task.ploidy_map)
    if job is None:
        job = R.load_job(task.gfa, task.gaf, config)
    pending = []
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
        ccfg = R.chain_config(config, cid)
        states = R.path_states(dp, out.path, ccfg.ploidy) \
            if len(out.path) == dp.num_positions else None
        if states is None:
            n["dp_cost_gap"] = NO_PATH
            continue
        if beam_width(ccfg):
            pending.append(Pending(kind="beam", dp=dp, config=ccfg,
                                   cost=path_cost(dp, states, ccfg)))
        else:
            costs = R.dp_costs(dp, ccfg)
            _best, best_cost = R.best_path(dp, ccfg, costs)
            n["dp_cost_gap"] = max(n["dp_cost_gap"], rel_gap(
                R.path_cost(costs, states), best_cost))
        lines = R.result_lines(job, cid, dp, out.path, ccfg.ploidy)
        size, section = sections.get(cid, (None, []))
        if out.chain_file != "".join(lines) or section != lines \
                or size != len(job.allele_paths[cid]):
            n["files_diff"] += 1
    for cid in task.stage_ids:
        out = produced.chains.get(cid)
        if out is None or out.matrix is None or out.dp is None:
            n["chains_missing"] += 1
            continue
        ccfg = R.chain_config(config, cid)
        m = R.chain_matrix(job, cid, ccfg)
        cm = R.chain_collapse(m, ccfg)
        if not _same_matrix(m, out.matrix) \
                or not _same_collapse(cm, out.collapse):
            n["matrix_diff"] += 1
            continue
        banded = R.is_banded(m, cm, ccfg)
        if banded != out.banded:
            # the chain took the other scoring path: what the reference
            # checks of it was not recorded
            n["chains_missing"] += 1
            continue
        if banded:
            if out.edges is None or out.clusters is None:
                n["chains_missing"] += 1
                continue
            pending.append(Pending(kind="band", dp=out.dp, config=ccfg,
                                   matrix=m, collapse=cm, edges=out.edges,
                                   clusters=out.clusters))
            continue
        # the batched driver's dense scoring runs at the global config
        s = R.chain_scores(m, cm, config)
        if out.scores is None or out.scores.shape != s.shape:
            n["matrix_diff"] += 1
            continue
        n["score_gap"] = max(n["score_gap"], score_gap(out.scores, s))
        w = R.solver_weights(np.asarray(out.scores, dtype=np.float64), cm)
        if out.weights is None or not np.array_equal(w, out.weights):
            n["cluster_diff"] += 1
            continue
        pending.append(Pending(kind="solver", dp=out.dp, config=ccfg,
                               matrix=m, collapse=cm, weights=w,
                               clusters=out.clusters))
    return n, pending


def finish_chain(p: Pending, device=None) -> Dict[str, float]:
    """A ``beam`` step: the plain beam's least cost against the program
    path's.  A ``solver`` step: the solver on the program's weights,
    then the DP inputs from the reference's matrix and those clusters.
    A ``band`` step: the program's edges against the reference's band,
    then the DP inputs from the reference's matrix and the program's
    clusters."""
    n = zero()
    if p.kind == "beam":
        _states, least = best_beam_path(p.dp, p.config,
                                        beam_width(p.config), device)
        n["dp_cost_gap"] = rel_gap(p.cost, least)
        return n
    if p.kind == "band":
        rows = p.matrix if p.collapse is None else p.collapse.matrix
        ref = band_edges(rows, p.config, mult=None if p.collapse is None
                         else p.collapse.mult, device=device)
        n["edges_diff"], n["score_gap"] = band_gaps(p.edges, ref,
                                                    rows.num_reads)
        n["chains_solver_unchecked"] = 1
        clusters = p.clusters
    else:
        clusters = cluster_editing(p.weights, mode=p.config.ce_mode,
                                   device=device)
        if clusters != p.clusters:
            n["cluster_diff"] += 1
            return n
    read_cl = clusters if p.collapse is None \
        else expand_clusters(clusters, p.collapse.inverse)
    dp = R.dp_inputs(p.matrix, read_cl, p.config)
    if not all(np.array_equal(getattr(dp, f), getattr(p.dp, f))
               for f in DP_FIELDS):
        n["dp_inputs_diff"] += 1
    return n


def _finish(totals: Dict[str, float], pending: Sequence[Pending], device,
            seconds: Optional[Dict[str, float]]) -> None:
    """``finish_chain`` on each step, its seconds added to ``seconds``
    under its kind."""
    for p in pending:
        t = time.perf_counter()
        merge(totals, finish_chain(p, device))
        if seconds is not None:
            seconds[p.kind] = seconds.get(p.kind, 0.0) \
                + time.perf_counter() - t


def judge_job(job: "R.Job", produced: Produced, stage_ids,
              config: PhasingConfig, device=None,
              seconds: Optional[Dict[str, float]] = None
              ) -> Dict[str, float]:
    """Every check of one loaded job in this process: the job's files,
    the paths and files of every chain ``produced`` holds, and the
    stages of ``stage_ids``.  ``config`` carries the job's ploidy map."""
    task = Task(gfa="", gaf=None, produced=produced, job_level=True,
                dp_ids=sorted(produced.chains), stage_ids=stage_ids)
    totals, pending = check_job(task, config, job=job)
    _finish(totals, pending, device, seconds)
    return totals


def tasks_of_job(gfa: str, gaf: str, produced: Produced,
                 stage_ids: Sequence[int],
                 ploidy_map: Optional[dict] = None) -> List[Task]:
    """A job's checks cut into worker tasks: one a stage chain (first,
    so that the solver starts early), and its files and dp chains in
    ``DP_TASKS`` tasks."""
    light = dataclasses.replace(produced, chains={
        cid: dataclasses.replace(out, matrix=None, collapse=None,
                                 scores=None, weights=None, edges=None)
        for cid, out in produced.chains.items()})
    tasks = [Task(gfa, gaf, dataclasses.replace(
        produced, chains={c: produced.chains[c]}
        if c in produced.chains else {}), False, (), (c,), ploidy_map)
        for c in stage_ids]
    dp_ids = sorted(produced.chains)
    chunks = [dp_ids[k::DP_TASKS] for k in range(DP_TASKS)]
    for k, chunk in enumerate(chunks):
        tasks.append(Task(gfa, None, dataclasses.replace(
            light, chains={c: light.chains[c] for c in chunk}),
            k == 0, chunk, (), ploidy_map))
    return tasks


def judge_tasks(tasks: Sequence[Task], config: PhasingConfig,
                workers: int, device=None,
                seconds: Optional[Dict[str, float]] = None
                ) -> Dict[str, float]:
    """The merged numbers of ``tasks``: ``check_job`` in ``workers``
    spawned processes (one fewer where the steps run on a card from
    this process, which then keeps a core; none where that leaves 1),
    each ``finish_chain`` step here as its task completes, its seconds
    added to ``seconds`` by kind."""
    totals = zero()
    if device is not None:
        workers -= 1
    if workers <= 1:
        for t in tasks:
            n, pending = check_job(t, config)
            merge(totals, n)
            _finish(totals, pending, device, seconds)
        return totals
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as pool:
        futures = [pool.submit(check_job, t, config) for t in tasks]
        for f in as_completed(futures):
            n, pending = f.result()
            merge(totals, n)
            _finish(totals, pending, device, seconds)
    return totals


def merge(totals: Dict[str, float], n: Dict[str, float]) -> None:
    for k, v in n.items():
        if k in ("score_gap", "dp_cost_gap"):
            totals[k] = max(totals.get(k, 0.0), v)
        else:
            totals[k] = totals.get(k, 0) + v


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit (exact numbers: 0); the
    ``UNCHECKED`` counts are no fault."""
    return all(numbers[k] <= (0 if k in EXACT else limits[k])
               for k in numbers if k not in UNCHECKED)


def limit_of(name: str, limits: Dict[str, float]) -> float:
    return 0 if name in EXACT else limits[name]
