"""Command-line interface of the port.

Same subcommands and flags as the JAX package's ``ahsoka-tpu`` (its
``cli/main.py``), plus ``--device``:

    ahsoka-tpu-torch phase -g <graph.gfa> -a <alignments.gaf> -o <outstem>
                           [--device cuda|cpu] [--ploidy K] ...
    ahsoka-tpu-torch only-bubbles -g <graph.gfa> -o <outstem>

``--device cuda`` (the default) needs an NVIDIA card and raises without
one.  ``--data-shards`` / ``--chain-shards`` shard over every visible
card, or one card a rank in a ``--num-processes`` group (the CPU counts
as one device), and fall back to the unsharded path with fewer devices,
as the JAX package does.  ``--num-processes`` > 1
starts a torch.distributed process group (``--coordinator``,
``--process-id``): NCCL for the mesh layout on CUDA, gloo otherwise.
``--backend host`` runs the numpy oracle chain by chain (host readsets,
pair scores, cluster editing and DP; readset debug files always
written); ``--device`` is still resolved first, so a bare run without a
card raises there too.  Ploidy 1-6 (ploidy 6 with ``--dp-beam-width``)
runs on both devices.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import List, Optional

from ahsoka_tpu_torch.config import PhasingConfig


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="ahsoka-tpu-torch",
        description=("Haplotype assembly for diploid and polyploid "
                     "genomes from assembly graphs (GFA) and long-read "
                     "alignments (GAF), on PyTorch/CUDA"))
    sub = parser.add_subparsers(dest="command", required=True)

    phase = sub.add_parser("phase", help="full phasing pipeline")
    phase.add_argument("-g", "--graph", required=True,
                       help="genome assembly graph in GFA format")
    phase.add_argument("-a", "--alignments", required=True,
                       help="alignments of long reads to the graph, GAF")
    phase.add_argument("-o", "--output", required=True,
                       help="output stem for result files")
    phase.add_argument("-s", "--strandseq", default="",
                       help="additional long-range phasing information "
                            "(accepted for parity; unused)")
    phase.add_argument("-t", "--threads", type=int, default=1,
                       help="host worker width")
    phase.add_argument("--ploidy", type=int, default=2)
    phase.add_argument("--ploidy-map", metavar="JSON", default=None,
                       help="per-chain ploidy overrides for mixed-"
                            "ploidy samples: a JSON file mapping engine "
                            "chain ids to ploidy ({\"12\": 4, ...}); "
                            "chains absent from the map use --ploidy")
    phase.add_argument("--backend", choices=["jax", "host"], default="jax",
                       help="compute backend for projection/scoring/DP")
    phase.add_argument("--resume", action="store_true",
                       help="skip chains whose result file already exists")
    phase.add_argument("--keep-going", action="store_true",
                       help="record per-chain failures and continue")
    phase.add_argument("--profile", metavar="DIR", default=None,
                       help="write a torch.profiler trace into DIR")
    phase.add_argument("--no-genotypes", action="store_true",
                       help="disable the genotype conformity cost")
    phase.add_argument("--genotype-prior",
                       choices=["reference", "balanced"],
                       default="reference",
                       help="'reference' = balanced biallelic "
                            "((k+1)//2, k//2) like the reference's "
                            "{0:1,1:1}; 'balanced' = per-position ML "
                            "allocation over observed alleles "
                            "(recommended for ploidy > 2)")
    phase.add_argument("--max-coverage", type=int, default=None,
                       help="cap per-position read coverage before "
                            "scoring (bounds cost on deep data)")
    phase.add_argument("--dp-beam-width", type=int, default=0,
                       help="cap retained DP states per position "
                            "(beam pruning, the WhatsHap rowLimit "
                            "analog); required for ploidy 6 "
                            "(e.g. 2048), 0 = exact DP")
    phase.add_argument("--data-shards", type=int, default=1,
                       help="shard alignments over this many mesh "
                            "devices during projection")
    phase.add_argument("--chain-shards", type=int, default=1,
                       help="shard the batched threading DP's chain "
                            "axis over this many mesh devices")
    phase.add_argument("--coordinator", default=None,
                       help="coordinator address (host:port) for "
                            "multi-host runs")
    phase.add_argument("--num-processes", type=int, default=None,
                       help="total process count for multi-host runs")
    phase.add_argument("--process-id", type=int, default=None,
                       help="this process's rank for multi-host runs")
    phase.add_argument("--process-sharding", choices=["mesh", "chains"],
                       default="mesh",
                       help="multi-host layout: 'mesh' runs device "
                            "stages over the global mesh (collectives "
                            "across hosts; giant-chain workloads); "
                            "'chains' partitions chains across "
                            "processes with process-local device calls "
                            "and a rank-0 output merge (many-chain "
                            "workloads)")

    phase.add_argument("--device", default="cuda",
                       help="torch device for projection, scoring and the "
                            "DP: cuda (default; raises without a card) or "
                            "cpu (plain PyTorch versions)")

    only = sub.add_parser("only-bubbles",
                          help="stop after writing the bubbleinfo file")
    only.add_argument("-g", "--graph", required=True)
    only.add_argument("-o", "--output", required=True)
    only.add_argument("-t", "--threads", type=int, default=1)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "only-bubbles":
        from ahsoka_tpu_torch.pipeline import run_only_bubbles
        run_only_bubbles(args.graph, args.output)
        return 0
    if args.command == "phase":
        from ahsoka_tpu_torch.pipeline import run_phase
        chains = args.process_sharding == "chains"
        if args.num_processes and args.num_processes > 1:
            # every process joins the group before any device work
            from ahsoka_tpu_torch.dist.mesh import (group_backend,
                                                    initialize_distributed)
            initialize_distributed(coordinator=args.coordinator,
                                   num_processes=args.num_processes,
                                   process_id=args.process_id,
                                   backend=group_backend(args.device,
                                                         chains))
        ploidy_map = None
        if args.ploidy_map:
            import json
            with open(args.ploidy_map) as fh:
                ploidy_map = {int(c): int(k)
                              for c, k in json.load(fh).items()}
        config = dataclasses.replace(
            PhasingConfig(), ploidy=args.ploidy, backend=args.backend,
            ploidy_map=ploidy_map,
            use_genotypes=not args.no_genotypes,
            genotype_prior=args.genotype_prior,
            max_coverage=args.max_coverage, threads=args.threads,
            dp_beam_width=args.dp_beam_width, data_shards=args.data_shards,
            chain_shards=args.chain_shards, process_chain_sharding=chains)
        run_phase(args.graph, args.alignments, args.output, config,
                  device=args.device, resume=args.resume,
                  keep_going=args.keep_going, profile_dir=args.profile)
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
