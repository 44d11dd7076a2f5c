"""End-to-end pipeline throughput of the port on the synthetic configs.

Counterpart of ``scripts/bench_e2e.py``: runs the full phase pipeline
(parse -> bubbles -> projection -> scoring -> clustering -> threading DP
-> emission) on a synthetic config or on given inputs, and prints one
JSON row with the stage seconds, the per-chain stage seconds summed,
records/s, the DP cells/s and the planted-truth accuracy, under the JAX
script's keys.  Each row also carries the peak device memory, the peak
host RSS of the process, ``device_warmup`` and the card's ``nvidia-smi``
name and power limit.

Usage:
    python -m ahsoka_tpu_torch.scripts.bench_e2e --config config5
    python -m ahsoka_tpu_torch.scripts.bench_e2e --config config4s --device cpu
    python -m ahsoka_tpu_torch.scripts.bench_e2e --gfa g.gfa --gaf a.gaf

``--device`` defaults to ``cuda`` and raises without a card.  Inputs are
generated into ``--workdir`` (default ``build/bench/``) on first use and
reused afterwards; the outputs go to ``--outstem`` (default
``build/bench/<config>/run``).  ``--resume`` continues a run at the same
outstem chain by chain (chains with a result file are not phased
again).  A failure raises; a run in which a chain failed (the run keeps
going past it, as the JAX script's does, and counts it in
``chains_failed``) prints its row and exits 1.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import resource
import sys
import time

from ahsoka_tpu_torch.scripts import BUILD_BENCH

CONFIG_NAMES = ("config2", "config3", "config3c", "config4", "config4s",
                "config5", "config5s", "bench")
# keys a row carries beyond the JAX script's
EXTRA_KEYS = ("peak_device_bytes", "peak_host_rss_bytes", "device_warmup",
              "gpu")


def ensure_inputs(config_name: str, workdir: str):
    """``<workdir>/<config>.{gfa,gaf,truth}`` (written when missing) and,
    for a mixed-ploidy config, the engine-chain -> ploidy map from the
    planted truth (``<config>.pmap.json``, the ``--ploidy-map`` a user
    would pass).  Returns (gfa, gaf, truth, spec, ploidy map or None)."""
    from ahsoka_tpu_torch.utils.synth import CONFIGS, write_synthetic

    spec = CONFIGS[config_name]
    os.makedirs(workdir, exist_ok=True)
    gfa, gaf, truth = (os.path.join(workdir, f"{config_name}.{x}")
                       for x in ("gfa", "gaf", "truth"))
    if not (os.path.exists(gfa) and os.path.exists(gaf)
            and os.path.exists(truth)):
        write_synthetic(gfa, gaf, spec, truth_path=truth)
    pmap = None
    if spec.chain_plan is not None and len({k for _, k in spec.plan()}) > 1:
        pmap_path = os.path.join(workdir, f"{config_name}.pmap.json")
        if not os.path.exists(pmap_path):
            from ahsoka_tpu_torch.config import PhasingConfig
            from ahsoka_tpu_torch.graph.alleles import enumerate_allele_paths
            from ahsoka_tpu_torch.pipeline import load_graph_and_bubbles
            from ahsoka_tpu_torch.utils.accuracy import ploidy_map_from_truth

            art = load_graph_and_bubbles(gfa, PhasingConfig())
            paths = enumerate_allele_paths(art.graph, art.index)
            pmap = ploidy_map_from_truth(paths, truth)
            with open(pmap_path, "w") as fh:
                json.dump({str(c): k for c, k in pmap.items()}, fh)
        else:
            with open(pmap_path) as fh:
                pmap = {int(c): int(k) for c, k in json.load(fh).items()}
    return gfa, gaf, truth, spec, pmap


def bench_settings(ploidy: int, ploidy_map: dict | None, threads: int,
                   max_coverage: int | None = 64, backend: str = "jax"
                   ) -> dict:
    """``PhasingConfig`` keywords of a run at the bench settings: no
    readset debug files, coverage cap ``max_coverage``, the balanced
    genotype prior above ploidy 2 (the reference's biallelic prior
    mis-scores planted k-allelic bubbles), beam width 2048 when a chain
    has ploidy 6 or more."""
    max_k = max([ploidy] + list((ploidy_map or {}).values()))
    return dict(ploidy=ploidy, debug_readset_files=False,
                max_coverage=max_coverage, threads=threads,
                ploidy_map=ploidy_map, backend=backend,
                dp_beam_width=(2048 if max_k >= 6 else 0),
                genotype_prior=("balanced" if max_k > 2 else "reference"))


def phase_e2e(gfa: str, gaf: str, outstem: str, *, ploidy: int = 2,
              max_coverage: int | None = 64, threads: int = 1,
              truth: str | None = None, ploidy_map: dict | None = None,
              backend: str = "jax", device="cuda", resume: bool = False):
    """One end-to-end run at the bench settings (no readset debug files,
    coverage cap ``max_coverage``, the balanced genotype prior above
    ploidy 2, beam width 2048 when a chain has ploidy 6 or more) ->
    (row, the run's PipelineArtifacts).  ``keep_going``: a failed chain
    is counted in ``chains_failed``, not raised.  Without ``resume`` the
    chain result files of an earlier run at ``outstem`` are removed
    first."""
    import torch

    from ahsoka_tpu_torch.config import PhasingConfig
    from ahsoka_tpu_torch.device import card_line, resolve_device
    from ahsoka_tpu_torch.pipeline import run_phase

    dev = resolve_device(device)
    cfg = PhasingConfig(**bench_settings(ploidy, ploidy_map, threads,
                                         max_coverage, backend))
    os.makedirs(os.path.dirname(outstem) or ".", exist_ok=True)
    if not resume:
        for f in glob.glob(f"{outstem}-chain*-result.txt"):
            os.remove(f)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    art = run_phase(gfa, gaf, outstem, config=cfg, device=dev,
                    resume=resume, keep_going=True)
    total = time.perf_counter() - t0
    peak_device = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else None)
    with open(f"{outstem}-metrics.json") as fh:
        m = json.load(fh)
    accuracy = None
    if truth and os.path.exists(truth):
        from ahsoka_tpu_torch.utils.accuracy import score_phased_output
        accuracy = score_phased_output(outstem, truth)
        m["accuracy_vs_planted_truth"] = accuracy
        with open(f"{outstem}-metrics.json", "w") as fh:
            json.dump(m, fh, indent=1)
    chain_stage_totals: dict = {}
    for c in m["chains"]:
        for k, v in c.get("stage_seconds", {}).items():
            chain_stage_totals[k] = chain_stage_totals.get(k, 0.0) + v
    row = {
        "total_seconds": round(total, 3),
        "stage_seconds": {k: (round(v, 3) if isinstance(v, float) else v)
                          for k, v in m["stage_seconds"].items()},
        "chain_stage_totals": {k: round(v, 3)
                               for k, v in chain_stage_totals.items()},
        "gaf_records": m["gaf_records"],
        "reads_per_s": round(m["reads_per_s"], 1),
        "reads_per_s_phase_only": round(m["reads_per_s_phase_only"], 1),
        "chains_phased": m["chains_phased"],
        "chains_failed": m["chains_failed"],
        "total_filtered_reads": m["total_filtered_reads"],
        "dp_cells_per_s_e2e": round(m["dp_cells_per_s_e2e"], 1),
        "dp_cells_per_s_device_window": (
            round(m["dp_cells_per_s_device_window"], 1)
            if m.get("dp_cells_per_s_device_window") else None),
        "accuracy_vs_planted_truth": accuracy,
        "peak_device_bytes": peak_device,
        # the process's peak resident set so far (Linux reports KiB)
        "peak_host_rss_bytes":
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
        "device_warmup": m["stage_seconds"].get("device_warmup"),
        "gpu": card_line(dev),
    }
    return row, art


def run_e2e(gfa: str, gaf: str, outstem: str, **kw) -> dict:
    """``phase_e2e``'s row (``scripts/bench_e2e.run_e2e``'s keys and
    EXTRA_KEYS)."""
    return phase_e2e(gfa, gaf, outstem, **kw)[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=CONFIG_NAMES, default=None)
    ap.add_argument("--gfa")
    ap.add_argument("--gaf")
    ap.add_argument("--truth", default=None,
                    help="planted-truth side file for the accuracy column "
                         "(implied for --config runs)")
    ap.add_argument("--workdir", default=BUILD_BENCH)
    ap.add_argument("--outstem", default=None,
                    help="default: <workdir>/<config or gfa stem>/run")
    ap.add_argument("--ploidy", type=int, default=None)
    ap.add_argument("--max-coverage", type=int, default=64)
    ap.add_argument("--threads", type=int, default=0,
                    help="host worker threads (0 = one per CPU core, "
                         "capped at 8)")
    ap.add_argument("--backend", choices=["jax", "host"], default="jax",
                    help="'jax' runs the device pipeline (the name the "
                         "CLI keeps), 'host' the numpy oracle")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--resume", action="store_true",
                    help="continue a run at the same outstem: chains with "
                         "a result file are not phased again")
    args = ap.parse_args(argv)
    from ahsoka_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)          # before minutes of synthesis
    if args.threads <= 0:
        args.threads = min(os.cpu_count() or 1, 8)
    ploidy, truth, pmap = args.ploidy, args.truth, None
    if args.config:
        gfa, gaf, truth, spec, pmap = ensure_inputs(args.config,
                                                    args.workdir)
        if ploidy is None:
            ploidy = spec.ploidy
    else:
        if not (args.gfa and args.gaf):
            ap.error("need --config or --gfa/--gaf")
        gfa, gaf = args.gfa, args.gaf
    name = args.config or os.path.splitext(os.path.basename(gfa))[0]
    outstem = args.outstem or os.path.join(args.workdir, name, "run")
    out = run_e2e(gfa, gaf, outstem, ploidy=ploidy or 2,
                  max_coverage=(None if args.max_coverage <= 0
                                else args.max_coverage),
                  threads=args.threads, truth=truth, ploidy_map=pmap,
                  backend=args.backend, device=dev, resume=args.resume)
    out["config"] = args.config or os.path.basename(gfa)
    out["backend"] = args.backend
    print(json.dumps(out))
    if out["chains_failed"]:
        # the run kept going past each failed chain; the bench fails
        print(f"bench_e2e: {out['chains_failed']} chains failed",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
