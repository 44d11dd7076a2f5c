"""Quantify the approximate fast paths against the exact pipeline.

Counterpart of ``scripts/quantify_fastpaths.py``, on the port's own
stages.  Runs each parity-breaking fast path

  1. banded scoring -> sparse edge list (``score/banded.py``),
  2. sparse cluster editing with the approximate lazy-heap refresh
     (``native/cluster_editing_sparse.cpp``'s default mode),
  3. per-position coverage capping (``project/subsample.py``),
  4. identical-read collapsing (``project/collapse.py``),

against the exact pipeline (dense scoring + dense cluster editing, no
cap) on noisy synthetic diploid chains, and prints one JSON row per
(regime, path, reads):

  - speedup of scoring + clustering over the reference path;
  - cluster divergence: Adjusted Rand Index against the reference's
    clusters (None when the path subsampled the reads);
  - haplotype divergence: fraction of (position, haplotype) consensus
    alleles differing from the reference's phased output (min over
    haplotype permutations), and the planted-truth switch error and
    Hamming rate for calibration.

Usage: python -m ahsoka_tpu_torch.scripts.quantify_fastpaths
           [--reads 2000 4000 8000] [--bubbles 500] [--regimes ...]
           [--device cuda|cpu] [--markdown]

Scoring, projection and the DP run on ``--device`` (default ``cuda``;
raises without a card); cluster editing is native code on the host.
Inputs are written under ``--workdir`` (default
``build/bench/quantify_fastpaths``).
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time

import numpy as np

from ahsoka_tpu_torch.scripts import BUILD_BENCH


def ari(a: np.ndarray, b: np.ndarray) -> float:
    """Adjusted Rand Index between two integer label vectors."""
    a = np.asarray(a)
    b = np.asarray(b)
    n = len(a)
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    ka, kb = ai.max() + 1, bi.max() + 1
    cont = np.zeros((ka, kb), dtype=np.int64)
    np.add.at(cont, (ai, bi), 1)

    def comb(x):
        return x * (x - 1) // 2

    sum_ij = comb(cont).sum()
    sum_a = comb(cont.sum(axis=1)).sum()
    sum_b = comb(cont.sum(axis=0)).sum()
    total = comb(n)
    exp = sum_a * sum_b / total if total else 0.0
    mx = (sum_a + sum_b) / 2.0
    return float((sum_ij - exp) / (mx - exp)) if mx != exp else 1.0


def hap_alleles(dp, path) -> np.ndarray:
    """[P, ploidy] consensus alleles of the threaded haplotypes."""
    from ahsoka_tpu_torch.cluster.postprocess import consensus_lookup

    cons = consensus_lookup(dp)
    P = dp.num_positions
    k = len(path[0])
    out = np.zeros((P, k), dtype=np.int32)
    for j in range(P):
        for i in range(k):
            out[j, i] = cons[j].get(int(path[j][i]), -1)
    return out


def hap_divergence(a: np.ndarray, b: np.ndarray) -> float:
    """min over haplotype permutations of mean allele mismatch (global
    permutation: switch errors inside count as mismatches)."""
    k = a.shape[1]
    best = 1.0
    for perm in itertools.permutations(range(k)):
        best = min(best, float(np.mean(a[:, list(perm)] != b)))
    return best


def switch_error(haps: np.ndarray, truth: np.ndarray) -> float:
    """Per-position-pair switch error of phased haplotypes against the
    planted truth (best local pairing per position, pairing changes
    between consecutive positions counted)."""
    P, k = haps.shape
    pairings = []
    for j in range(P):
        best, bperm = None, None
        for perm in itertools.permutations(range(k)):
            err = int(np.sum(haps[j, list(perm)] != truth[j]))
            if best is None or err < best:
                best, bperm = err, perm
        pairings.append(bperm)
    switches = sum(1 for j in range(1, P) if pairings[j] != pairings[j - 1])
    return switches / max(P - 1, 1)


def run_variant(matrix, config, variant: str, cap: int = 32, device="cuda"):
    """Scoring + clustering of one path -> (cluster assignment, DP inputs,
    threaded path, seconds, the matrix it clustered)."""
    from ahsoka_tpu_torch.cluster._native_ce import cluster_editing_sparse
    from ahsoka_tpu_torch.cluster.editing import (assignment_from_clusters,
                                                  cluster_editing)
    from ahsoka_tpu_torch.cluster.postprocess import \
        build_dp_inputs_from_matrix
    from ahsoka_tpu_torch.project.collapse import (collapse_reads,
                                                   expand_clusters)
    from ahsoka_tpu_torch.project.subsample import subsample_matrix
    from ahsoka_tpu_torch.score.banded import score_pairs_banded
    from ahsoka_tpu_torch.score.device import score_pairs_device
    from ahsoka_tpu_torch.thread.dp_host import assign_rows
    from ahsoka_tpu_torch.thread.dp_torch import thread_chain_device

    t0 = time.perf_counter()
    if variant.startswith("maxcov"):
        matrix, _ = subsample_matrix(matrix, cap)
    if variant in ("exact", "maxcov"):
        scores = score_pairs_device(matrix, config, device=device)
        clusters = cluster_editing(scores, mode=config.ce_mode)
    elif variant in ("collapsed", "maxcov+collapsed"):
        cm = collapse_reads(matrix)
        s_grp = score_pairs_device(cm.matrix, config,
                                   mult=cm.mult.astype(float), device=device)
        w = s_grp * np.outer(cm.mult, cm.mult)
        np.fill_diagonal(w, 0.0)
        clusters = expand_clusters(
            cluster_editing(w, mode=config.ce_mode), cm.inverse)
    elif variant == "banded-collapsed":
        cm = collapse_reads(matrix)
        eu, ev, ew = score_pairs_banded(cm.matrix, config, mult=cm.mult,
                                        device=device)
        ew = ew * cm.mult[eu] * cm.mult[ev]
        clusters = expand_clusters(
            cluster_editing_sparse(cm.num_groups, eu, ev, ew,
                                   mode=config.ce_mode), cm.inverse)
    elif variant in ("banded", "banded+sparse-approx",
                     "maxcov+banded+sparse"):
        eu, ev, ew = score_pairs_banded(matrix, config, device=device)
        clusters = cluster_editing_sparse(
            matrix.num_reads, eu, ev, ew,
            exact_priorities=variant == "banded", mode=config.ce_mode)
    else:
        raise ValueError(variant)
    seconds = time.perf_counter() - t0
    cluster_of = assignment_from_clusters(clusters, matrix.num_reads)
    dp = build_dp_inputs_from_matrix(matrix.alleles, matrix.positions,
                                     cluster_of, config)
    path = assign_rows(thread_chain_device(dp, config, device=device),
                       config.ploidy)
    return np.asarray(cluster_of), dp, path, seconds, matrix


# divergence regimes: conditions under which the approximate paths can
# depart from exact (high error, skewed haplotype coverage, low read
# overlap) plus the clean baseline
REGIMES = {
    "baseline": dict(error_rate=0.05, span=3, hap_weights=None),
    "high-error": dict(error_rate=0.15, span=3, hap_weights=None),
    "skewed-3to1": dict(error_rate=0.10, span=3, hap_weights=(3.0, 1.0)),
    "low-overlap": dict(error_rate=0.10, span=2, hap_weights=None),
}


def chain_study_input(R: int, bubbles: int, regime: str, seed: int,
                      config, workdir: str, device):
    """One synthetic chain of the regime -> (AlleleMatrix, planted truth
    branches {chain: [nodes of haplotype h]}, node -> (bubble position,
    allele index))."""
    from ahsoka_tpu_torch.phase import ChainPhasingResult, _chain_matrix_stage
    from ahsoka_tpu_torch.pipeline import prepare_phase_inputs
    from ahsoka_tpu_torch.utils.synth import SynthSpec, write_synthetic

    rg = REGIMES[regime]
    spec = SynthSpec(num_chains=1, bubbles_per_chain=bubbles,
                     reads_per_hap=R // 2, span=rg["span"],
                     error_rate=rg["error_rate"],
                     hap_weights=rg["hap_weights"], seed=seed)
    os.makedirs(workdir, exist_ok=True)
    gfa, gaf, truth_path, stem = (os.path.join(workdir, x) for x in
                                  ("g.gfa", "g.gaf", "truth.txt", "o"))
    write_synthetic(gfa, gaf, spec, truth_path=truth_path)
    art = prepare_phase_inputs(gfa, gaf, stem, config, columnar=True)
    truth_branches = {}
    with open(truth_path) as fh:
        for line in fh:
            c, _h, nodes = line.split()
            truth_branches.setdefault(int(c), []).append(
                [int(x) for x in nodes.split(",")])
    (size, chain_id), = art.size_sorting
    res = ChainPhasingResult(chain_id=chain_id, num_bubbles=size,
                             skipped=True)
    matrix = _chain_matrix_stage(chain_id, art.allele_paths[chain_id], None,
                                 stem, config, res, columns=art.gaf_columns,
                                 bucket=art.chain_buckets[chain_id],
                                 device=device)
    # inner branch node ids are unique per chain: node -> (bubble
    # position, allele index) through the allele-path table
    node_to_pos_allele = {}
    for pos, paths in art.allele_paths[chain_id].items():
        for a_idx, path_nodes in enumerate(paths):
            for n in list(path_nodes)[1:-1]:
                node_to_pos_allele[int(n)] = (int(pos), a_idx)
    return matrix, truth_branches, node_to_pos_allele


def study(reads=(2000, 4000, 8000), bubbles: int = 500,
          regimes=tuple(REGIMES), cap: int = 32, exact_limit: int = 10_000,
          seed: int = 0, device="cuda", workdir: str | None = None,
          emit=None):
    """Every (regime, reads) study -> (rows, details).  ``details``: one
    dict a study with its input ``matrix`` and each variant's cluster
    assignment (``clusters``).  ``emit(row)`` is called as each row
    lands."""
    from ahsoka_tpu_torch.config import PhasingConfig
    from ahsoka_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    workdir = workdir or os.path.join(BUILD_BENCH, "quantify_fastpaths")
    config = PhasingConfig(debug_readset_files=False)
    rows, details = [], []
    for regime, R in itertools.product(regimes, reads):
        matrix, truth_branches, node_to_pos_allele = chain_study_input(
            R, bubbles, regime, seed, config, workdir, dev)
        if R > exact_limit:
            # the dense [R, R] reference is infeasible: the exact-priority
            # sparse solver on the banded edges is the reference
            reference = "banded"
            variants = ["banded", "collapsed", "banded-collapsed",
                        "banded+sparse-approx", "maxcov+banded+sparse"]
        else:
            reference = "exact"
            variants = ["exact", "collapsed", "banded-collapsed", "banded",
                        "banded+sparse-approx", "maxcov",
                        "maxcov+collapsed", "maxcov+banded+sparse"]
        out = {}
        for v in variants:
            cl, dp, path, secs, mtx = run_variant(matrix, config, v, cap=cap,
                                                  device=dev)
            haps = hap_alleles(dp, path)
            truth = np.full_like(haps, -1)
            pos_to_jj = {int(p): jj for jj, p in enumerate(dp.positions)}
            (tchain,) = truth_branches            # single-chain study
            for h in range(config.ploidy):
                for node in truth_branches[tchain][h]:
                    hit = node_to_pos_allele.get(node)
                    if hit is None or hit[0] not in pos_to_jj:
                        continue
                    truth[pos_to_jj[hit[0]], h] = hit[1]
            out[v] = dict(cl=cl, haps=haps, secs=secs, truth=truth,
                          reads=mtx.num_reads)
        ex = out[reference]
        details.append({"regime": regime, "reads": R, "matrix": matrix,
                        "clusters": {v: o["cl"] for v, o in out.items()}})
        for v in variants:
            o = out[v]
            same_reads = o["reads"] == ex["reads"]
            rows.append({
                "regime": regime, "path": v, "reads": R,
                "reference": reference,
                "seconds": round(o["secs"], 3),
                "speedup": round(ex["secs"] / o["secs"], 2),
                "ari_vs_exact": (round(ari(o["cl"], ex["cl"]), 4)
                                 if same_reads else None),
                "hap_div_vs_exact": round(
                    hap_divergence(o["haps"], ex["haps"]), 4),
                "switch_err_vs_truth": round(
                    switch_error(o["haps"], o["truth"]), 4),
                "hamming_vs_truth": round(
                    hap_divergence(o["haps"], o["truth"]), 4),
            })
            if emit is not None:
                emit(rows[-1])
    return rows, details


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reads", type=int, nargs="+",
                    default=[2000, 4000, 8000])
    ap.add_argument("--bubbles", type=int, default=500)
    ap.add_argument("--regimes", nargs="+", default=list(REGIMES),
                    choices=list(REGIMES))
    ap.add_argument("--cap", type=int, default=32,
                    help="max_coverage for the maxcov variants")
    ap.add_argument("--exact-limit", type=int, default=10_000,
                    help="above this read count the dense-exact reference "
                         "is infeasible ([R,R] matrix); the exact-priority "
                         "sparse path becomes the reference")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--markdown", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--workdir", default=None)
    args = ap.parse_args(argv)
    rows, _details = study(args.reads, args.bubbles, args.regimes, args.cap,
                           args.exact_limit, args.seed, args.device,
                           args.workdir,
                           emit=lambda r: print(json.dumps(r), flush=True))
    if args.markdown:
        print("\n| regime | path | reads | scoring+CE s | speedup | "
              "ARI vs ref | hap divergence vs ref | switch err vs truth "
              "| hamming vs truth |")
        print("|---|---|---|---|---|---|---|---|---|")
        for r in rows:
            ari_s = "n/a (subsampled)" if r["ari_vs_exact"] is None \
                else f"{r['ari_vs_exact']:.4f}"
            print(f"| {r['regime']} | {r['path']} | {r['reads']} | "
                  f"{r['seconds']} | {r['speedup']}x | {ari_s} | "
                  f"{r['hap_div_vs_exact']:.4f} | "
                  f"{r['switch_err_vs_truth']:.4f} | "
                  f"{r['hamming_vs_truth']:.4f} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
