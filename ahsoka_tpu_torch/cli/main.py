"""Command-line interface of the port.

Same subcommands and flags as ``ahsoka-tpu`` (ahsoka_tpu/cli/main.py),
plus ``--device``:

    ahsoka-tpu-torch phase -g <graph.gfa> -a <alignments.gaf> -o <outstem>
                           [--device cuda|cpu] [--ploidy K] ...
    ahsoka-tpu-torch only-bubbles -g <graph.gfa> -o <outstem>

``--device cuda`` (the default) needs an NVIDIA card and raises without
one.  Flags for paths the port does not run yet (data/chain sharding,
multi-process layouts, the host backend) are accepted by the parser and
raise NotImplementedError naming the ROADMAP item.  Ploidy 1-6 (ploidy 6
with ``--dp-beam-width``) runs on both devices.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import List, Optional

from ahsoka_tpu.cli.main import build_parser as _tpu_parser
from ahsoka_tpu.config import PhasingConfig


def build_parser() -> argparse.ArgumentParser:
    parser = _tpu_parser()
    parser.prog = "ahsoka-tpu-torch"
    parser.description = ("Haplotype assembly for diploid and polyploid "
                          "genomes from assembly graphs (GFA) and "
                          "long-read alignments (GAF), on PyTorch/CUDA")
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    phase = sub.choices["phase"]
    for action in phase._actions:
        if action.dest == "profile":
            action.help = "write a torch.profiler trace into DIR"
    phase.add_argument("--device", default="cuda",
                       help="torch device for projection, scoring and the "
                            "DP: cuda (default; raises without a card) or "
                            "cpu (plain PyTorch versions)")
    return parser


def _unsupported(args) -> Optional[str]:
    if args.backend != "jax":
        return ("--backend host: the host oracle is ahsoka-tpu's "
                "--backend host; the port runs the device pipeline")
    if args.data_shards > 1 or args.chain_shards > 1:
        return ("--data-shards/--chain-shards > 1: sharded layouts "
                "(ROADMAP queue 1 item 11)")
    if (args.num_processes and args.num_processes > 1) \
            or args.coordinator or args.process_sharding != "mesh":
        return ("multi-process layouts (--coordinator, --num-processes, "
                "--process-sharding chains): ROADMAP queue 1 item 11")
    return None


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "only-bubbles":
        from ahsoka_tpu_torch.pipeline import run_only_bubbles
        run_only_bubbles(args.graph, args.output)
        return 0
    if args.command == "phase":
        why = _unsupported(args)
        if why:
            raise NotImplementedError(f"not ported yet: {why}")
        from ahsoka_tpu_torch.pipeline import run_phase
        ploidy_map = None
        if args.ploidy_map:
            import json
            with open(args.ploidy_map) as fh:
                ploidy_map = {int(c): int(k)
                              for c, k in json.load(fh).items()}
        config = dataclasses.replace(
            PhasingConfig(), ploidy=args.ploidy, ploidy_map=ploidy_map,
            use_genotypes=not args.no_genotypes,
            genotype_prior=args.genotype_prior,
            max_coverage=args.max_coverage, threads=args.threads,
            dp_beam_width=args.dp_beam_width)
        run_phase(args.graph, args.alignments, args.output, config,
                  device=args.device, resume=args.resume,
                  keep_going=args.keep_going, profile_dir=args.profile)
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
