"""Roofline of the threading DP on one NVIDIA H100: what do the measured
cells/s mean against what the card can do?

Counterpart of ``scripts/roofline.py``, and the port's one roofline
model (``chip_smoke.py`` takes ``bound`` and the peaks from here).  For
each row (the bench's ``cuda`` DP function: node costs, forward, argmin,
backtrace) it

1. counts the bytes each pass must move (each input read once, each
   output written once) and its operations, from the shapes and the
   port's dtypes (``work``);
2. times the function on the card (``bench.seconds_per_call``: CUDA
   events, K back-to-back calls);
3. prints the achieved bytes/s and operations/s beside the peaks, the
   binding resource and ``roofline_frac``, the least time the card could
   take for the same work over the measured time.  A fraction above 1.05
   raises: the count is wrong, not the kernel fast.

Peaks of one H100 SXM (NVIDIA's data sheet, dense): HBM 3.35 TB/s,
67 TFLOP/s float32 on the CUDA cores, 1,979 TOP/s int8 on the tensor
cores.  They assume the 700 W limit; every row carries the card's
``nvidia-smi`` name and power limit.

Counts, per chain-position (M = 2k slots, S = C(3k-1, k) states, A = 2
alleles):

- node costs (``dp_torch.node_costs_all``): reads candidates, coverage,
  consensus [M] and num_candidates, genotypes [A] (4 bytes each) and the
  state tables once; writes node costs [S] f32.  Per state: M coverage
  terms (subtract, abs, add), the allele counts (2 M A), A genotype
  terms (subtract, abs, add) and 4 for the weights and the select.
- forward (``dpk_forward_warp`` at k <= 2, ``dpk_forward`` above):
  reads candidates [M] int32 and node costs [S] f32, writes backpointers
  [S] int32, and final costs [S] and the int8 counts table once; an
  fp32 add and compare per (source, destination) cell and the M k 0/1
  products of its intersection at the int8 tensor-core rate.
- backtrace: reads the P - 1 backpointers its path follows and writes
  the P states (int32).

Usage:  python -m ahsoka_tpu_torch.scripts.roofline [--quick] [--device cuda|cpu]
Writes build/bench/roofline.json and prints it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from math import comb

from ahsoka_tpu_torch.scripts import BUILD_BENCH

# one NVIDIA H100 SXM (data sheet, dense): HBM bytes/s, fp32 operations/s
# on the CUDA cores, int8 operations/s on the tensor cores
HBM_BYTES_S, FP32_OPS_S, INT8_OPS_S = 3.35e12, 67e12, 1979e12
MAX_FRAC = 1.05
NUM_ALLELES = 2
# row name -> (ploidy, the passes its DP function runs)
ROWS = {"diploid": (2, ("node_costs", "dpk_forward_warp", "dpk_backtrace")),
        "tetraploid": (4, ("node_costs", "dpk_forward", "dpk_backtrace"))}


def work(kernel: str, k: int, C: int, P: int):
    """(bytes, fp32 operations, int8 operations) of one pass at ploidy k
    on C chains of P positions."""
    M, S, A = 2 * k, comb(3 * k - 1, k), NUM_ALLELES
    if kernel == "node_costs":
        nbytes = 4 * C * P * (3 * M + 1 + A) + S * M + (M + 1) * S \
            + 4 * C * P * S
        return nbytes, C * P * S * (3 * M + 2 * M * A + 3 * A + 4), 0
    if kernel.endswith("backtrace"):
        return 4 * C * (2 * P), 0, 0
    if kernel not in ("dpk_forward", "dpk_forward_warp"):
        raise ValueError(f"unknown pass {kernel!r}")
    cells = C * max(P - 1, 0) * S * S
    nbytes = 4 * C * P * (M + 2 * S) + 4 * C * S + S * M
    return nbytes, 2 * cells, 2 * cells * M * k


def least_seconds(nbytes: float, fp32_ops: float, int8_ops: float):
    """(least seconds the card could take, "bytes" or "operations")."""
    byte_s = nbytes / HBM_BYTES_S
    op_s = fp32_ops / FP32_OPS_S + int8_ops / INT8_OPS_S
    return max(byte_s, op_s), ("bytes" if byte_s >= op_s else "operations")


def bound(kernel: str, k: int, C: int, P: int):
    """(least ms the card could take, "bytes" or "operations") for one
    call of ``kernel`` at ploidy k on C chains of P positions."""
    sec, by = least_seconds(*work(kernel, k, C, P))
    return sec * 1e3, by


def row(name: str, C: int, P: int, seconds: float) -> dict:
    """The roofline row of ``ROWS[name]`` at C x P measured at
    ``seconds`` a call; raises when its fraction exceeds MAX_FRAC."""
    k, passes = ROWS[name]
    tot = [sum(x) for x in zip(*(work(p, k, C, P) for p in passes))]
    nbytes, fp32_ops, int8_ops = tot
    least, by = least_seconds(nbytes, fp32_ops, int8_ops)
    S = comb(3 * k - 1, k)
    out = {"row": name, "passes": list(passes), "ploidy": k, "chains": C,
           "positions": P, "seconds": seconds,
           "cells_per_s": C * (P - 1) * S * S / seconds,
           "bytes": nbytes, "fp32_ops": fp32_ops, "int8_ops": int8_ops,
           "achieved_bytes_per_s": nbytes / seconds,
           "achieved_fp32_ops_per_s": fp32_ops / seconds,
           "achieved_int8_ops_per_s": int8_ops / seconds,
           "hbm_frac": nbytes / seconds / HBM_BYTES_S,
           "fp32_frac": fp32_ops / seconds / FP32_OPS_S,
           "int8_frac": int8_ops / seconds / INT8_OPS_S,
           "bound_seconds": least, "bound_by": by,
           "roofline_frac": least / seconds}
    if out["roofline_frac"] > MAX_FRAC:
        raise ValueError(f"roofline {name}: fraction {out['roofline_frac']:.3f}"
                         f" > {MAX_FRAC}: the work count is wrong")
    return out


def measure(name: str, C: int, P: int, dev) -> dict:
    """Time the bench's ``cuda`` DP function at ``ROWS[name]``'s ploidy on
    C x P and fold in its roofline."""
    from ahsoka_tpu_torch.bench import bench_dp, make_dp_workload

    k = ROWS[name][0]
    sec = bench_dp(make_dp_workload(C, P, k), k, ["cuda"], dev)["cuda"][
        "seconds"]
    return row(name, C, P, sec)


def run(chains: int = 1024, positions: int = 1024, device="cuda",
        quick: bool = False, tetra_chains: int = 128) -> dict:
    """Both rows: diploid at chains x positions, tetraploid at
    ``tetra_chains`` x min(positions, 256)."""
    from ahsoka_tpu_torch.device import card_line, resolve_device

    dev = resolve_device(device)
    if quick:
        chains, positions = 128, 128
    return {"device": str(dev), "gpu": card_line(dev),
            "hbm_peak_bytes_per_s": HBM_BYTES_S,
            "fp32_peak_ops_per_s": FP32_OPS_S,
            "int8_peak_ops_per_s": INT8_OPS_S,
            "rows": [measure("diploid", chains, positions, dev),
                     measure("tetraploid", tetra_chains,
                             min(positions, 256), dev)]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--chains", type=int, default=1024)
    ap.add_argument("--positions", type=int, default=1024)
    ap.add_argument("--tetra-chains", type=int, default=128)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    out = run(args.chains, args.positions, args.device, args.quick,
              args.tetra_chains)
    os.makedirs(BUILD_BENCH, exist_ok=True)
    with open(os.path.join(BUILD_BENCH, "roofline.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
