"""Profile the cluster-editing stage at config4-chain scale.

Counterpart of ``scripts/profile_ce.py``, on the port's own stages.  On
a config4-shaped single chain (50 bubbles, span-3 reads, 2% noise) at
several read counts it measures

  - the dense native solver (the product path for dense chains);
  - collapsed rows: identical rows scored once, weighted, clustered as
    groups (its own scoring included);
  - the sparse native solver over the nonzero edge list, with exact and
    approximate priorities, and over |w|-pruned edge lists;

and, for every variant, the cluster ARI against the first variant and the
planted-truth switch error and Hamming rate after threading, so each
speed gain carries its accuracy cost.

Usage: python -m ahsoka_tpu_torch.scripts.profile_ce [--reads 1000 2000 4000]
           [--device cuda|cpu] [--json out]

Projection, scoring and the DP run on ``--device`` (default ``cuda``;
raises without a card); the solvers are native code on the host.  The
chain's inputs are written under ``--workdir`` (default
``build/bench/profile_ce``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from ahsoka_tpu_torch.scripts import BUILD_BENCH
from ahsoka_tpu_torch.scripts.quantify_fastpaths import (ari, hap_divergence,
                                                         switch_error)


def chain_matrix(num_reads: int, bubbles: int, seed: int, config,
                 workdir: str, device="cuda"):
    """One config4-shaped chain -> (AlleleMatrix, dense scores, scoring
    seconds)."""
    from ahsoka_tpu_torch.phase import ChainPhasingResult, _chain_matrix_stage
    from ahsoka_tpu_torch.pipeline import prepare_phase_inputs
    from ahsoka_tpu_torch.score.device import score_pairs_device
    from ahsoka_tpu_torch.utils.synth import SynthSpec, write_synthetic

    spec = SynthSpec(num_chains=1, bubbles_per_chain=bubbles,
                     reads_per_hap=num_reads // 2, span=3,
                     error_rate=0.02, seed=seed)
    os.makedirs(workdir, exist_ok=True)
    gfa, gaf, stem = (os.path.join(workdir, x)
                      for x in ("g.gfa", "g.gaf", "o"))
    write_synthetic(gfa, gaf, spec)
    art = prepare_phase_inputs(gfa, gaf, stem, config, columnar=True)
    (size, cid), = art.size_sorting
    res = ChainPhasingResult(chain_id=cid, num_bubbles=size, skipped=True)
    matrix = _chain_matrix_stage(cid, art.allele_paths[cid], None, stem,
                                 config, res, columns=art.gaf_columns,
                                 bucket=art.chain_buckets[cid],
                                 device=device)
    t0 = time.perf_counter()
    scores = score_pairs_device(matrix, config, device=device)
    return matrix, scores, time.perf_counter() - t0


def edges_from_dense(scores: np.ndarray, keep_frac: float = 1.0):
    """Upper-triangle nonzero edges; keep the top |w| fraction."""
    iu = np.triu_indices(scores.shape[0], k=1)
    w = scores[iu]
    nz = w != 0
    eu, ev, ew = iu[0][nz], iu[1][nz], w[nz]
    if keep_frac < 1.0 and len(ew):
        k = max(int(len(ew) * keep_frac), 1)
        thresh = np.partition(np.abs(ew), len(ew) - k)[len(ew) - k]
        keep = np.abs(ew) >= thresh
        eu, ev, ew = eu[keep], ev[keep], ew[keep]
    return eu, ev, ew


def downstream(matrix, clusters, config, device="cuda"):
    """Clusters -> (assignment, switch error, Hamming rate) of the
    threaded haplotypes against the planted truth: synthetic haplotype h
    takes allele h at every bubble (alleles are in branch order), so the
    truth row is (0, 1, ..., k-1) at every position."""
    from ahsoka_tpu_torch.cluster.editing import assignment_from_clusters
    from ahsoka_tpu_torch.cluster.postprocess import (
        build_dp_inputs_from_matrix, consensus_lookup)
    from ahsoka_tpu_torch.thread.dp_host import assign_rows
    from ahsoka_tpu_torch.thread.dp_torch import thread_chain_device

    cluster_of = assignment_from_clusters(clusters, matrix.num_reads)
    dp = build_dp_inputs_from_matrix(matrix.alleles, matrix.positions,
                                     cluster_of, config)
    path = assign_rows(thread_chain_device(dp, config, device=device),
                       config.ploidy)
    cons = consensus_lookup(dp)
    P = dp.num_positions
    k = config.ploidy
    haps = np.zeros((P, k), dtype=np.int64)
    for j in range(P):
        for i in range(k):
            haps[j, i] = cons[j].get(int(path[j][i]), -1)
    truth = np.tile(np.arange(k), (P, 1))
    return cluster_of, switch_error(haps, truth), hap_divergence(haps, truth)


def profile(reads=(1000, 2000, 4000), bubbles: int = 50,
            keep=(1.0, 0.5, 0.25), seed: int = 0, skip_dense: bool = False,
            skip_sparse: bool = False, device="cuda",
            workdir: str | None = None, emit=None):
    """Every read count's variants -> (rows, details).  ``details``: one
    dict a read count with its ``matrix``, dense ``scores`` and each
    variant's cluster assignment (``clusters``).  ``emit(row)`` is called
    as each row lands."""
    from ahsoka_tpu_torch.cluster._native_ce import (cluster_editing_native,
                                                     cluster_editing_sparse)
    from ahsoka_tpu_torch.cluster.editing import cluster_editing
    from ahsoka_tpu_torch.config import PhasingConfig
    from ahsoka_tpu_torch.device import resolve_device
    from ahsoka_tpu_torch.project.collapse import (collapse_reads,
                                                   expand_clusters)
    from ahsoka_tpu_torch.score.device import score_pairs_device

    dev = resolve_device(device)
    workdir = workdir or os.path.join(BUILD_BENCH, "profile_ce")
    config = PhasingConfig(debug_readset_files=False)
    rows, details = [], []
    for R in reads:
        matrix, scores, t_score = chain_matrix(R, bubbles, seed, config,
                                               workdir, dev)
        n = matrix.num_reads
        eu, ev, ew = edges_from_dense(scores)
        density = 2.0 * len(ew) / max(n * (n - 1), 1)
        print(f"# reads={n} bubbles={bubbles} nnz_edges={len(ew)} "
              f"density={density:.3f} score_s={t_score:.2f}",
              file=sys.stderr)
        variants = []
        if not skip_dense:
            variants.append(("dense", None, None))
        variants.append(("collapsed", None, None))
        if not skip_sparse:
            variants.append(("sparse-exact", 1.0, True))
            for kf in keep:
                variants.append((f"sparse-approx-k{kf}", kf, False))
        base_cl = None
        assignments = {}
        for name, kf, exact in variants:
            t0 = time.perf_counter()
            if name == "dense":
                clusters = cluster_editing_native(scores, mode="whatshap")
            elif name == "collapsed":
                cm = collapse_reads(matrix)
                sg = score_pairs_device(cm.matrix, config, mult=cm.mult,
                                        device=dev)
                w = sg * np.outer(cm.mult, cm.mult)
                np.fill_diagonal(w, 0.0)
                clusters = expand_clusters(
                    cluster_editing(w, mode="whatshap"), cm.inverse)
                print(f"#   collapsed: G={cm.num_groups} of R={n}",
                      file=sys.stderr)
            else:
                u2, v2, w2 = edges_from_dense(scores, kf)
                clusters = cluster_editing_sparse(
                    n, u2, v2, w2, exact_priorities=exact, mode="whatshap")
            secs = time.perf_counter() - t0
            cl, sw, ham = downstream(matrix, clusters, config, dev)
            assignments[name] = np.asarray(cl)
            if base_cl is None:
                base_cl = cl
            rows.append({"reads": n, "variant": name,
                         "ce_seconds": round(secs, 3),
                         "clusters": len(clusters),
                         "ari_vs_first": round(ari(cl, base_cl), 4),
                         "switch_err_vs_truth": round(sw, 4),
                         "hamming_vs_truth": round(ham, 4)})
            if emit is not None:
                emit(rows[-1])
        details.append({"reads": n, "matrix": matrix, "scores": scores,
                        "clusters": assignments})
    return rows, details


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reads", type=int, nargs="+",
                    default=[1000, 2000, 4000])
    ap.add_argument("--bubbles", type=int, default=50)
    ap.add_argument("--keep", type=float, nargs="+",
                    default=[1.0, 0.5, 0.25])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None)
    ap.add_argument("--skip-dense", action="store_true")
    ap.add_argument("--skip-sparse", action="store_true",
                    help="skip the sparse-exact/approx variants (the "
                         "exact-priority refresh is superlinear)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--workdir", default=None)
    args = ap.parse_args(argv)
    rows, _details = profile(args.reads, args.bubbles, args.keep, args.seed,
                             args.skip_dense, args.skip_sparse, args.device,
                             args.workdir,
                             emit=lambda r: print(json.dumps(r), flush=True))
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(rows, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
