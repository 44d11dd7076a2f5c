#!/usr/bin/env python3
"""config5s in one process against the chain layout's two, on the same
host threads and one CUDA card, in alternating order.

    python3 tools/chains_order.py

Generates config5s (``dist/sim.py``'s ``--shape config5s``: inputs and a
ploidy map from the planted truth) into ``build/chains_order/``, runs the
small shape once untimed so that the native helpers and the CUDA kernels
are built, then runs config5s with ``--process-sharding chains`` at the
process counts of ``ORDER`` in turn, ``THREADS / nproc`` host threads a
process (``dist.sim.run_chains``).  ``ORDER`` makes four pairs, two with
one process first and two with two processes first, so that an order
effect (a warm page cache, a host clock that drifts) shows as a
difference between a pair's first and second run, not between the
counts.  Each run's merged outputs are compared byte for byte with the
first run's.

It prints the card's ``nvidia-smi`` name and power limit, one JSON line a
run (per rank: phase and ``clustering.solver`` thread-seconds; the
slowest rank's phase, the ranks' summed solver thread-seconds) and last a
summary: for each pair, the two-process run over the one-process run.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ahsoka_tpu_torch.dist.sim import (compare_outputs, run_chains,  # noqa: E402
                                       shaped_inputs)

ORDER = (1, 2, 2, 1, 2, 1, 1, 2)
THREADS = 8
DEVICE = "cuda"
WORK = os.path.join(ROOT, "build", "chains_order")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    os.makedirs(WORK, exist_ok=True)
    gfa, gaf, _truth, _ = shaped_inputs(WORK, "small")
    run_chains(gfa, gaf, os.path.join(WORK, "warmup"), 1, DEVICE, THREADS)
    gfa, gaf, _truth, pmap = shaped_inputs(WORK, "config5s")
    runs, first = [], None
    for i, nproc in enumerate(ORDER):
        row = run_chains(gfa, gaf, os.path.join(WORK, f"run{i}"), nproc,
                         DEVICE, THREADS // nproc, pmap, timeout=900)
        stem = row.pop("outstem")
        first = first or stem
        ranks = row["per_rank"]
        out = {"run": i, "nproc": nproc, "threads": THREADS // nproc,
               "wall_s": row["wall_s"],
               "phase_s": [r["phase_s"] for r in ranks],
               "solver_thread_s": [r["clustering_solver_thread_s"]
                                   for r in ranks],
               "max_phase_s": max(r["phase_s"] for r in ranks),
               "sum_solver_thread_s": sum(r["clustering_solver_thread_s"]
                                          for r in ranks),
               "chains_failed": sum(r["chains_failed"] for r in ranks),
               "byte_equal": not compare_outputs(first, stem)}
        runs.append(out)
        print(json.dumps(out), flush=True)
    pairs = []
    for a, b in zip(runs[::2], runs[1::2]):
        one, two = (a, b) if a["nproc"] == 1 else (b, a)
        pairs.append({"first": a["nproc"],
                      "phase_ratio": two["max_phase_s"] / one["max_phase_s"],
                      "solver_ratio": (two["sum_solver_thread_s"]
                                       / one["sum_solver_thread_s"])})
    ok = all(r["byte_equal"] and not r["chains_failed"] for r in runs)
    print(json.dumps({"ok": ok, "order": ORDER, "pairs": pairs}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
