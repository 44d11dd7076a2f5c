#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (ahsoka_tpu_torch) on one GPU.

    python3 chip_smoke.py                          # all phases, one CUDA card
    python3 chip_smoke.py --phases env,kernels     # build + kernel checks only
    python3 chip_smoke.py --phases env,config5s    # one end-to-end run
    python3 chip_smoke.py --phases env,config2     # config2, both drivers
    python3 chip_smoke.py --phases env,bench       # the benches and studies
    python3 chip_smoke.py --phases env,config5     # config5 (~3.9M records)

Runs from the repository root with no install, no jax and nothing of the
JAX package (``ahsoka_tpu``):

1. environment: torch/CUDA/nvcc versions, the card's name and power limit,
   the TF32 settings, and the builds of the CUDA kernels from
   ``ahsoka_tpu_torch/csrc`` (one nvcc per source, run in parallel, timed);
2. each DP kernel against its plain PyTorch version on the card, on
   seeded random DP inputs; backpointers, final costs and states must be
   exactly equal; median times with CUDA events:
   - ploidy 2 through the diploid wrappers (``dpk_forward_warp`` and
     ``dpk_backtrace``) at config4's DP shape (C=1000, P=56), ragged
     chain counts (C=1, C=37), a config2-length chain (C=1, P=10,000) and
     all-ties batches (C=300, and C=1 over several staged tiles);
   - the general-ploidy wrappers at config3c's DP shape (k=4, C=20,
     P=256), k=1 (C=1000, P=56), k=3 (C=37, P=56), k=5 (C=4, P=64,
     2002 states, 16 CTAs a chain; and C=200, P=12, one CTA an SM), one
     chain at each ploidy (k=1-3 at P=300, a k=1 chain at P=10,000, a long
     tetraploid chain at C=1, P=2048, k=5 at P=64), all-ties k=4 and k=5
     batches spread over clusters, and the k <= 2 forward at the edges of
     its staged tile T (P = T-1, T, T+1, 3T+5 at k=1 and 2); the general
     forward at every cluster size (1-16 CTAs a chain) at k=3, 4 and 5;
   - the backtrace on random backpointers over several staged tiles at
     every ploidy (S = 2, 10, 56, 330, 2002);
3. the golden diploid fixture through the port's ``run_only_bubbles`` and
   ``run_phase``, and the golden tetraploid one through the port's CLI
   (``--ploidy 4 --no-genotypes``), on the card, byte-equal to
   ``tests/data``;
4. config4s (config4's chains at 1/10 of its chain count: 100 chains x
   50 bubbles, 100k GAF records; cut from config4 to keep the whole smoke
   near five minutes once config5s joined it) end to end on the card with
   the bench settings (no readset debug files, coverage cap 64): every
   chain phased with no failure, ``dpk_forward_warp`` and
   ``dpk_backtrace`` launched by the run, paths identical to re-threading
   the run's DP inputs with the plain versions on the CPU, planted-truth
   switch error below 0.01;
5. config3c (20 tetraploid chains x 200 bubbles, 42,720 GAF records) end
   to end on the card with the same settings and the balanced genotype
   prior: every chain phased, ``dpk_forward`` and ``dpk_backtrace``
   launched, paths identical to a plain CPU re-threading, switch error
   below 0.02; then a small mixed-ploidy run (one chain each of ploidy 2,
   3, 4 and 5, a ploidy map from the planted truth) that launches all
   three kernels,
   paths identical to a plain CPU re-threading;
5a. ``perchain``: config4s, config3c and mixed again through the per-chain
   driver (``batch_dp=False``) on the same inputs: result, bubbleinfo and
   every chain file byte-equal to the batched run's, one forward and one
   backtrace launch a phased chain (counted), paths identical to the
   batched run's and to a plain CPU re-threading; each run's phase wall,
   DP window and ``device_warmup`` beside the batched run's, and the largest |d| between one-chain and batched dense scores
   on the card;
5b. ``host``: the host backend (the numpy oracle) on both goldens,
   byte-equal to ``tests/data``; mixed with ``max_coverage=None`` and no
   collapsing through the host backend against the card's batched run,
   chain by chain: byte-equal, or equal allele matrices, scores within
   rtol = atol = 1e-4 and a different clustering (a near-tie the float32
   and float64 scores break apart); the card's DP kernels on the host's
   DP inputs: the native DP's paths (sorted tuples) and the host's
   optimal cost within rtol 1e-5; the native sequential DP
   (``thread/_native_dp.py``) against the card's paths on config4s's and
   config3c's DP inputs; the log-depth DP (``thread/dp_assoc.py``) on the
   card against the CPU, its final minimum cost within rtol 1e-5 of
   ``dpk_forward_warp``'s on one diploid chain of P = 10,000;
6. the beam-pruned DP (ploidy 6, ``thread/dp_beam.py``, torch code) on the
   card against the same function on the CPU at config5s's longest
   hexaploid shape (k=6, B=2048, C=2, P=112) and on an all-ties batch:
   node costs, final costs, beam states, backpointers and states exactly
   equal; CUDA-event median on the card, host clock on the CPU;
7. banded scoring (``score/banded.py``) on the card against the CPU on one
   seeded chain of 8,000 reads over 1,500 positions: edges (u, v) equal
   and in the same order, weights within rtol = atol = 1e-5; wall time of
   both;
8. config5s (the JAX package's whole-genome shape at 1/10 scale: 300
   ragged chains of ploidy 2, 4 and 6, ~396k GAF records) end to end on
   the card with the bench settings, the balanced genotype prior, beam
   width 2048 and a ploidy map from the planted truth: every chain
   phased, all three kernels launched, the beam taken by every hexaploid
   DP group, banded scoring by at least one chain, paths identical to a
   plain CPU re-threading (the beam groups included), switch error below
   0.02;
9. the sharded layouts (``dist/``), on the inputs and against the outputs
   of phases 5 and 8 (``--phases`` with ``sharded`` runs config3c and
   config5s too):
   - NCCL at world size 1: ``all_reduce(MIN)`` keeps int32 and NO_MATCH,
     the uneven row gather is exact;
   - the mesh layout on config3c: ``data_shards = chain_shards = 2`` over
     ``devices = [cuda:0, cuda:0]`` under an NCCL group of world size 1
     (the projection's min-merge and the row and state gathers take
     their NCCL calls, counted); result, bubbleinfo and every chain file
     byte-equal to phase 5's, ``dpk_forward`` and ``dpk_backtrace``
     launched once per non-empty shard of each DP group, paths identical
     to a plain CPU re-threading; the largest |d| between the run's
     row-sharded and unsharded scores on the card, and on a seeded
     2,048-read chain, where it must be 0;
   - the chain layout on config5s: ``--process-sharding chains``, 2
     processes on the one card with 4 host threads each, a gloo group
     over localhost (``dist/sim.py``): merged result, bubbleinfo and every
     chain file byte-equal to phase 8's, no failed chain; per rank the
     chains owned and failed, kernel launches, phase and cluster-editing
     seconds and peak device memory;
10. ``config2``, only when named (``--phases env,config2``): config2 (one
   chain of 10,000 bubbles, 50k GAF records) through both drivers on the
   card, byte-equal, with banded scoring, the sparse solver and one C=1,
   P~10,000 diploid DP; phase wall, stage split, peak device memory and
   planted-truth switch error (below 0.01; the JAX package recorded
   0.0023 on a TPU);
11. ``bench``: the port's benches on the card: ``ahsoka_tpu_torch.bench``
   at its default size (diploid DP at 1,024 chains x 1,024 positions and
   tetraploid at 128 x 256, each through the kernels and their plain
   versions, the native sequential DP, projection reads/s): every DP
   kernel launched and ``kernel`` cuda; the roofline rows of
   ``ahsoka_tpu_torch/scripts/roofline.py`` (every fraction at or below
   1.05); ``quantify_fastpaths`` (baseline regime, 2,000 reads) and
   ``profile_ce`` (1,000 reads) on the card and on the CPU, each
   variant's clusters equal or a near-tie (phase 5b's rule);
12. ``config5``, only when named (``--phases env,config5``): config5 (3,000
   ragged chains of ploidy 2, 4 and 6, ~3.9M GAF records) through
   ``ahsoka_tpu_torch/scripts/bench_e2e.py`` with its inputs and outputs
   under ``build/bench/``: every chain phased, none failed, all three
   kernels launched, every hexaploid group on the beam, switch error below
   0.02; the bench row (stage split, DP window, peak device memory and
   host RSS) on one line.

Each end-to-end run sets the kernels' launch counts, and the counts of
beam groups and banded chains run on the card, to 0 just before it and
reads them just after, then re-threads its DP inputs once more on the
card under torch.profiler for the DP kernels' device time.  config4s,
config3c, mixed, config5s and config2 are then held to the JAX package's
reference digests (``ahsoka_tpu_torch/data/jax_reference.json``, written
on the CPU by ``tools/jax_reference.py``): the spec, the settings and
the ploidy map must be the reference's, and every result file equal to
it, or the chain is one the file ``allowed`` (a difference that comes
from the JAX package's float32 summation order, with the port's digest
recorded), or a near-tie: equal allele matrices on the card and the
CPU, dense scores within rtol = atol = 1e-4 or banded edges equal with
weights within 1e-5, a different clustering on the CPU, and the CPU's
chain file equal to the reference's.  More than 5% of a run's chains
differing fails before any chain is re-run.  Each run prints
``{"reference": {"config", "chains", "equal", "near_tie", "allowed",
...}}``; the per-chain and sharded runs are byte-equal to these runs and
inherit the check.  After the golden runs, after config5s, after the
per-chain and host runs and at the end no jax and no ahsoka_tpu module
may be loaded.  Any failure
raises and exits non-zero.  The last line is the result:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
before it stand the card's ``nvidia-smi`` name/power-limit line, a
``{"kernels": [...]}`` line with one entry per TPU kernel (row of
PERF.md's kernel table) naming the CUDA kernel that serves it, with that
kernel's launches in the row's end-to-end run (config4s for the diploid
rows, config3c for the general ones) and in its per-chain rerun
(``launches_perchain``), its error against the plain
version, both times (at config4's and config3c's DP shapes), its
roofline bound (``bound``; for a backtrace also the bytes its tiles move)
and ``library_ms`` null, and the ``{"beam": ...}``, ``{"banded": ...}``,
``{"config5s": ...}`` and ``{"dpk_forward_clusters": ...}`` lines with
the times and counts of phases 2 and 6-8, the ``{"sharded": ...}`` line
of phase 9, the ``{"perchain": ...}`` and ``{"host": ...}`` lines of
phases 5a-5b and the ``{"bench": ...}`` line of phase 11.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
DATA = os.path.join(ROOT, "tests", "data")

SWITCH, AFFINE = 32.0, 8.0            # PhasingConfig defaults
MIXED_MAX_SWITCH_ERR = 0.02
BEAM_WIDTH = 2048                     # scripts/bench_e2e.py's beam width
LIBS = ("minplus_stream",)
DP_SRC = "ahsoka_tpu_torch/csrc/minplus_stream.cu"
# TPU kernel (a row of PERF.md's kernel table) -> (CUDA kernel that serves
# it, its source, the TPU kernel it replaces with its pl.pallas_call
# site, end-to-end run that reads its launches, kernel-phase case that
# gives its times)
KERNEL_META = {
    "_dp2_kernel": ("dpk_forward_warp", DP_SRC,
                    "ahsoka_tpu/ops/minplus_diploid.py:56 (_dp2_kernel; "
                    "pl.pallas_call at ahsoka_tpu/ops/minplus_diploid.py:336)",
                    "config4s", "config4"),
    "_bt2_kernel": ("dpk_backtrace", DP_SRC,
                    "ahsoka_tpu/ops/minplus_diploid.py:188 (_bt2_kernel; "
                    "pl.pallas_call at ahsoka_tpu/ops/minplus_diploid.py:276)",
                    "config4s", "config4"),
    "_stream_kernel_ge": (
        "dpk_forward", DP_SRC,
        "ahsoka_tpu/ops/minplus_stream.py:186 (_stream_kernel_ge);"
        " ahsoka_tpu/ops/minplus_stream.py:29 (_stream_kernel); pl.pallas_call"
        " at ahsoka_tpu/ops/minplus_stream.py:411;"
        " ahsoka_tpu/ops/minplus.py:42 (_dp_kernel; pl.pallas_call at"
        " ahsoka_tpu/ops/minplus.py:131)", "config3c", "config3c"),
    "xla_scan_backtrace": (
        "dpk_backtrace", DP_SRC,
        "ahsoka_tpu/thread/dp_pallas.py:127 (the XLA-scan backtrace of "
        "thread_batch_pallas_streamed; no Pallas body)", "config3c",
        "config3c"),
}
DP_KERNELS = ("dpk_forward_warp", "dpk_forward", "dpk_backtrace")


# (ploidy, chains, positions) of the kernel-phase cases the JSON line reads
CASE_SHAPES = {"config4": (2, 1000, 56), "config3c": (4, 20, 256)}
NO_LIBRARY_CALL = ("no PyTorch call computes a min-plus scan with "
                   "first-argmin backpointers, or follows backpointers")


def log(msg: str) -> None:
    print(msg, flush=True)


def no_reference_modules(after: str) -> None:
    """Raise when jax or any ahsoka_tpu module has been imported."""
    from ahsoka_tpu_torch.host import loaded_reference_modules

    loaded = loaded_reference_modules(sys.modules)
    if loaded:
        raise AssertionError(f"after {after}: jax or the JAX package was "
                             f"imported: {loaded[:5]}")
    log(f"after {after}: no jax and no ahsoka_tpu module loaded")


# ---------------------------------------------------------------- phase 1
def phase_environment(dev) -> None:
    import torch

    from ahsoka_tpu_torch.device import card_line, fp32_settings
    from ahsoka_tpu_torch.ops import _build

    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True).stdout
    log("nvcc: " + " | ".join(l for l in nvcc.splitlines() if l.strip())[-120:])
    log(f"gpu: {card_line(dev)}")
    log(f"tf32 settings: {json.dumps(fp32_settings())}")
    t0 = time.perf_counter()
    _build.load_all(LIBS)
    log("kernel build: " + ", ".join(
        f"{name} nvcc {_build.build_seconds[name]:.2f} s" for name in LIBS)
        + f" (in parallel; load {time.perf_counter() - t0:.2f} s)")


# ---------------------------------------------------------------- phase 2
def random_dp_batch(C: int, P: int, seed: int, ploidy: int = 2):
    """Seeded numpy DP inputs shaped like tests/test_dp.py
    random_dp_inputs (2k + 1 clusters), stacked over C chains, M = 2k:
    candidates [C, P, M], num_candidates [C, P], coverage [C, P, M],
    consensus [C, P, M], genotypes [C, P, 2] (balanced biallelic)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    M = 2 * ploidy
    m = rng.integers(1, M + 1, size=(C, P))
    # distinct sorted ids per position: first m of a random permutation
    perm = np.argsort(rng.random((C, P, M + 1)), axis=2)[:, :, :M]
    perm = np.sort(perm, axis=2).astype(np.int32)
    slot = np.arange(M)[None, None, :]
    cand = np.where(slot < m[:, :, None], perm, -1).astype(np.int32)
    cov = (rng.random((C, P, M)) + 0.05) * (slot < m[:, :, None])
    cov = (cov / cov.sum(axis=2, keepdims=True)).astype(np.float32)
    cons = (rng.integers(0, 2, size=(C, P, M))
            * (slot < m[:, :, None])).astype(np.int32)
    geno = np.zeros((C, P, 2), dtype=np.float32)
    geno[:, :, 0] = (ploidy + 1) // 2
    geno[:, :, 1] = ploidy // 2
    return cand, m.astype(np.int32), cov, cons, geno


def all_ties(arrays):
    """Every chain and position: the same two candidates and uniform
    coverage -> many equal-cost paths and states (in place)."""
    cand, nc, cov, cons, _ = arrays
    cand[:] = -1
    cand[:, :, :2] = [0, 1]
    nc[:] = 2
    cov[:] = 0.0
    cov[:, :, :2] = 0.5
    cons[:] = 0
    return arrays


def _node_costs(arrays, dev, ploidy: int = 2, ties: bool = False):
    import torch

    from ahsoka_tpu_torch.state import to_torch
    from ahsoka_tpu_torch.thread.states import (full_state_counts,
                                                full_state_validity)
    from ahsoka_tpu_torch.thread.dp_torch import node_costs_all

    cand, nc, cov, cons, geno = to_torch(*arrays, device=dev)
    node = node_costs_all(cand, nc, cov, cons, geno,
                          full_state_counts(ploidy),
                          full_state_validity(ploidy), ploidy=ploidy,
                          num_alleles=2, cov_w=1.0, geno_w=1.0).contiguous()
    if ties:
        node = torch.where(node < 1e29, torch.zeros_like(node), node)
    return cand, node


def _median_ms(fn, reps: int) -> float:
    import torch

    fn()                                            # warm up
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def backtrace_tile_bytes(k: int, C: int, P: int) -> int:
    """Bytes the backtrace's staged tiles move: every backpointer row but
    row 0 of every chain (the bound counts only the P - 1 it follows)."""
    from math import comb

    return 4 * C * max(P - 1, 0) * comb(3 * k - 1, k)


def _seed(k: int, C: int, P: int) -> int:
    return abs(C * 7919 + P + (k - 2) * 104729)


def _kernel_pair_case(pair, case, dev, err) -> dict:
    """One shape: forward + backtrace kernels against their plain
    versions on the same card tensors, exactly; CUDA-event medians of
    both.  ``pair``: (forward name, forward, plain forward, backtrace
    name, backtrace, plain backtrace), the forwards taking (cand, node)."""
    import torch

    from ahsoka_tpu_torch.scripts.roofline import bound

    fname, fwd, fwd_ref, bname, bt, bt_ref = pair
    name, k, C, P, reps, plain_reps = case
    ties = name.startswith("all_ties")
    arrays = random_dp_batch(C, P, seed=_seed(k, C, P), ploidy=k)
    if ties:
        all_ties(arrays)
    cand, node = _node_costs(arrays, dev, k, ties)
    fin_k, bp_k = fwd(cand, node)
    fin_r, bp_r = fwd_ref(cand, node)
    torch.cuda.synchronize()
    fs = torch.argmin(fin_k, dim=1).to(torch.int32)
    st_k = bt(bp_k, fs)
    st_r = bt_ref(bp_k, fs)
    torch.cuda.synchronize()
    same = (torch.equal(fin_k, fin_r) and torch.equal(bp_k, bp_r)
            and torch.equal(st_k, st_r))
    err[fname] = max(err.get(fname, 0.0),
                     float((fin_k - fin_r).abs().max()),
                     float((bp_k - bp_r).abs().max()))
    err[bname] = max(err.get(bname, 0.0), float((st_k - st_r).abs().max()))
    if name == "config4":
        # the plain version on the CPU agrees too
        fin_c, bp_c = fwd_ref(cand.cpu(), node.cpu())
        same = same and torch.equal(fin_c, fin_k.cpu()) \
            and torch.equal(bp_c, bp_k.cpu())
    if ties:
        # torch.argmin on the card keeps the first minimum
        tied = fin_k == fin_k.min(dim=1, keepdim=True).values
        first = tied.to(torch.int32).argmax(dim=1).to(torch.int32)
        same = same and torch.equal(fs, first) \
            and bool((tied.sum(dim=1) > 1).any())
    if not same:
        raise AssertionError(f"kernel != plain at {name} (k={k}, C={C}, "
                             f"P={P})")
    t = {fname: (_median_ms(lambda: fwd(cand, node), reps),
                 _median_ms(lambda: fwd_ref(cand, node), plain_reps)),
         bname: (_median_ms(lambda: bt(bp_k, fs), reps),
                 _median_ms(lambda: bt_ref(bp_k, fs), plain_reps))}
    log(f"kernel parity {name} k={k} C={C} P={P}: exact; "
        + "; ".join(f"{n} {v[0]:.4f} ms vs plain {v[1]:.3f} ms "
                    f"(bound {bound(n, k, C, P)[0]:.3g} ms)"
                    for n, v in t.items())
        + f"; backtrace tiles {backtrace_tile_bytes(k, C, P)} bytes")
    return t


def _backtrace_case(k: int, C: int, P: int, err) -> None:
    """The backtrace kernel on seeded random backpointers (any state in
    every row, so the walk visits arbitrary rows and columns) against its
    plain version on the card, exactly."""
    from math import comb

    import numpy as np
    import torch

    from ahsoka_tpu_torch.ops import minplus_stream as ms
    from ahsoka_tpu_torch.ops.minplus import backtrace_ref

    S = comb(3 * k - 1, k)
    rng = np.random.default_rng(_seed(k, C, P))
    bp = torch.from_numpy(rng.integers(0, S, size=(C, P, S), dtype=np.int32))
    fs = torch.from_numpy(rng.integers(0, S, size=C, dtype=np.int32))
    bp, fs = bp.cuda(), fs.cuda()
    got = ms.backtrace_streamed(bp, fs)
    want = backtrace_ref(bp, fs)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"dpk_backtrace != plain at k={k} (S={S}), "
                             f"C={C}, P={P}")
    err["dpk_backtrace"] = max(err.get("dpk_backtrace", 0.0),
                               float((got - want).abs().max()))


def phase_kernels(dev) -> dict:
    """Kernel vs plain on the card, exact equality at every shape."""
    from math import comb

    import torch

    from ahsoka_tpu_torch.ops import minplus_diploid as md
    from ahsoka_tpu_torch.ops import minplus_stream as ms
    from ahsoka_tpu_torch.ops.minplus import (backtrace_ref,
                                              minplus_forward_ref)
    from ahsoka_tpu_torch.thread.states import full_state_counts

    kw = dict(switch_cost=SWITCH, affine_cost=AFFINE)
    diploid = ("dpk_forward_warp",
               lambda c, n: md.minplus_forward_diploid(c, n, **kw),
               lambda c, n: md.minplus_forward_diploid_ref(c, n, **kw),
               "dpk_backtrace", md.backtrace_diploid,
               md.backtrace_diploid_ref)

    def general(k):
        counts = full_state_counts(k)
        return ("dpk_forward_warp" if k <= ms.SMALL_PLOIDY else "dpk_forward",
                lambda c, n: ms.minplus_forward_streamed(
                    c, n, counts, ploidy=k, **kw),
                lambda c, n: minplus_forward_ref(
                    c, n, counts, ploidy=k, **kw),
                "dpk_backtrace", ms.backtrace_streamed, backtrace_ref)

    # (name, ploidy, chains, positions, kernel reps, plain reps): config4's
    # group, ragged chain counts, a config2-length chain (C=1,
    # P=10,000), all-ties batches of 300 chains and of one chain over
    # several tiles
    diploid_cases = [("config4", 2, 1000, 56, 20, 20),
                     ("ragged1", 2, 1, 56, 5, 5),
                     ("ragged37", 2, 37, 56, 5, 5),
                     ("config2_chain", 2, 1, 10000, 5, 1),
                     ("all_ties", 2, 300, 24, 5, 5),
                     ("all_ties_c1", 2, 1, 3 * ms.WARP_TILE + 5, 5, 1)]
    # config3c's group, many chains at k=1 and 3, one chain at each
    # ploidy (k=4: tetra_long; k=1: a config2-length chain), k=5 across
    # the largest cluster (k5, k5_c1) and with more chains than SMs
    # (k5_c200: one CTA an SM fits its shared memory), all-ties batches
    # spread over clusters (G = 4 and 16), and the k <= 2 forward at the
    # edges of its staged tile (P = T - 1, T, T + 1, 3T + 5)
    general_cases = [("config3c", 4, 20, 256, 10, 3),
                     ("k1", 1, 1000, 56, 10, 5),
                     ("k3", 3, 37, 56, 10, 5),
                     ("k5", 5, 4, 64, 5, 1),
                     ("tetra_long", 4, 1, 2048, 5, 1),
                     ("all_ties_k4", 4, 20, 24, 5, 3),
                     ("k1_c1", 1, 1, 300, 10, 1),
                     ("k1_long", 1, 1, 10000, 5, 1),
                     ("k2_c1", 2, 1, 300, 10, 1),
                     ("k3_c1", 3, 1, 300, 10, 1),
                     ("k5_c1", 5, 1, 64, 5, 1),
                     ("k5_c200", 5, 200, 12, 5, 1),
                     ("all_ties_k5", 5, 2, 20, 5, 1)]
    T = ms.WARP_TILE
    for k in (1, 2):
        for P in (T - 1, T, T + 1, 3 * T + 5):
            general_cases.append((f"tile_k{k}_P{P}", k, 3, P, 3, 1))
    timing, err, clusters = {}, {}, {}
    for case in diploid_cases:
        timing[case[0]] = _kernel_pair_case(diploid, case, dev, err)
    for case in general_cases:
        name, k, C, P = case[:4]
        clusters[name] = ms.cluster_size(C, comb(3 * k - 1, k), k, dev)
        log(f"{name}: the forward runs {clusters[name]} CTA(s) a chain")
        timing[name] = _kernel_pair_case(general(k), case, dev, err)

    # every cluster size at k = 3, 4, 5, exactly (the wrapper's launcher
    # at a given cluster size)
    for k, P in ((3, 40), (4, 40), (5, 12)):
        arrays = random_dp_batch(2, P, seed=_seed(k, 2, P), ploidy=k)
        cand, node = _node_costs(arrays, dev, k)
        fin_r, bp_r = general(k)[2](cand, node)
        for g in ms.CLUSTER_SIZES:
            fin_g, bp_g = ms._forward(cand, node, full_state_counts(k), k,
                                      g, **kw)
            torch.cuda.synchronize()
            if not (torch.equal(fin_g, fin_r) and torch.equal(bp_g, bp_r)):
                raise AssertionError(f"dpk_forward != plain at k={k} with "
                                     f"{g} CTAs a chain")
    log(f"dpk_forward at k=3, 4, 5 with {ms.CLUSTER_SIZES} CTAs a chain: "
        "exact")

    # the backtrace over several staged tiles of rows at every ploidy
    # (S = 2, 10, 56, 330, 2002), on random backpointers
    bt_cases = [(1, 2, 3000), (2, 2, 3000), (3, 2, 1000), (4, 2, 300),
                (5, 2, 64), (5, 1, 37), (2, 300, 56)]
    for k, C, P in bt_cases:
        _backtrace_case(k, C, P, err)
    log("dpk_backtrace on random backpointers, (k, C, P) "
        f"{bt_cases}: exact")

    # int32 scatter-amin on the card (projection's scatter-min by name)
    idx = torch.tensor([0, 2, 0, 1, 2, 2], device=dev)
    src = torch.tensor([5, 7, 3, 9, 2, 8], dtype=torch.int32, device=dev)
    out = torch.full((3,), 2 ** 31 - 1, dtype=torch.int32, device=dev)
    out.scatter_reduce_(0, idx, src, reduce="amin", include_self=True)
    if out.cpu().tolist() != [3, 9, 2]:
        raise AssertionError(f"int32 scatter_reduce amin wrong: {out}")
    log("int32 scatter_reduce_(amin) on the card: ok")
    return {"timing": timing, "err": err, "clusters": clusters}


# ---------------------------------------------------------------- phase 3
def phase_golden(dev) -> None:
    from ahsoka_tpu_torch.pipeline import run_only_bubbles, run_phase

    work = os.path.join(WORK, "golden")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    gaf = os.path.join(work, "golden_diploid.gaf")
    shutil.copy(os.path.join(DATA, "golden_diploid.gaf"), gaf)
    run_only_bubbles(os.path.join(DATA, "golden_diploid.gfa"),
                     os.path.join(work, "b"))
    run_phase(os.path.join(DATA, "golden_diploid.gfa"), gaf,
              os.path.join(work, "o"), device=dev)
    pairs = [("b-bubbleinfo.txt", "golden_diploid-bubbleinfo.txt"),
             ("o-result.txt", "golden_diploid-result.txt"),
             ("o-bubbleinfo.txt", "golden_diploid-bubbleinfo.txt"),
             ("golden_diploid-alignment_identities.txt",
              "golden_diploid-identities.txt")]
    for got, want in pairs:
        with open(os.path.join(work, got), "rb") as a, \
                open(os.path.join(DATA, want), "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"golden mismatch: {got} vs {want}")
    log("golden diploid on the card: result, bubbleinfo (phase and "
        "only-bubbles) and identities byte-equal")

    # tetraploid through the CLI a user calls, on the general kernels
    from ahsoka_tpu_torch.cli.main import main as cli_main
    from ahsoka_tpu_torch.thread import dp_kernels

    gaf = os.path.join(work, "golden_tetra.gaf")
    shutil.copy(os.path.join(DATA, "golden_tetra.gaf"), gaf)
    dp_kernels.reset_launch_counts()
    rc = cli_main(["phase", "-g", os.path.join(DATA, "golden_tetra.gfa"),
                   "-a", gaf, "-o", os.path.join(work, "t"), "--device",
                   str(dev), "--ploidy", "4", "--no-genotypes"])
    launches = dp_kernels.launch_counts()
    if rc != 0 or not (launches["dpk_forward"]
                       and launches["dpk_backtrace"]):
        raise AssertionError(f"golden tetraploid: rc {rc}, launches "
                             f"{launches}")
    for got, want in [("t-result.txt", "golden_tetra-result.txt"),
                      ("golden_tetra-alignment_identities.txt",
                       "golden_tetra-alignment_identities.txt")]:
        with open(os.path.join(work, got), "rb") as a, \
                open(os.path.join(DATA, want), "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"golden mismatch: {got} vs {want}")
    log(f"golden tetraploid (CLI, --ploidy 4 --no-genotypes) on the card: "
        f"result and identities byte-equal; launches {json.dumps(launches)}")


# ---------------------------------------------------------------- phase 4
def _ploidy_map_from_truth(gfa: str, truth: str, cfg) -> dict:
    from ahsoka_tpu_torch.graph.alleles import enumerate_allele_paths
    from ahsoka_tpu_torch.pipeline import load_graph_and_bubbles
    from ahsoka_tpu_torch.utils.accuracy import ploidy_map_from_truth

    art = load_graph_and_bubbles(gfa, cfg)
    paths = enumerate_allele_paths(art.graph, art.index)
    return ploidy_map_from_truth(paths, truth)


def _reset_path_counts() -> None:
    from ahsoka_tpu_torch.score.banded import score_pairs_banded
    from ahsoka_tpu_torch.thread import dp_kernels
    from ahsoka_tpu_torch.thread.dp_beam import thread_beam

    dp_kernels.reset_launch_counts()
    thread_beam.launches = 0
    score_pairs_banded.launches = 0


def _path_counts() -> dict:
    """Kernel launches, beam groups and banded chains run on the card
    since the last reset."""
    from ahsoka_tpu_torch.score.banded import score_pairs_banded
    from ahsoka_tpu_torch.thread import dp_kernels
    from ahsoka_tpu_torch.thread.dp_beam import thread_beam

    return dict(dp_kernels.launch_counts(), beam=thread_beam.launches,
                banded=score_pairs_banded.launches)


def _beam_groups(th) -> int:
    """DP groups of a run that take the beam ((P_pad, A, ploidy) groups
    of ``thread_chains_batched`` whose state space exceeds the beam)."""
    from ahsoka_tpu_torch.thread.dp_torch import (_beam_width_for,
                                                  _bucket_positions)
    from ahsoka_tpu_torch.thread.states import max_states

    return len({(_bucket_positions(dp.num_positions),
                 dp.genotypes.shape[1], c.ploidy)
                for dp, c in zip(th["dps"], th["configs"])
                if dp.num_positions
                and _beam_width_for(c, max_states(c.ploidy))})


def phase_e2e(dev, name: str, spec, cfg, kernels, max_switch_err,
              ploidy_map: bool = False, beam: bool = False,
              banded: bool = False, inputs=None) -> dict:
    """``spec`` end to end on the card: every chain phased, ``kernels``
    launched by the run, paths identical to a plain CPU re-threading of
    the run's DP inputs, planted-truth switch error below
    ``max_switch_err``.  ``ploidy_map``: per-chain ploidies from the
    planted truth.  ``beam``: every beam DP group ran on the card (and
    there is one); ``banded``: at least one chain was scored banded.
    ``inputs``: the (gfa, gaf, truth) of an earlier run of ``spec`` to
    phase again instead of generating them."""
    import dataclasses

    import torch

    from ahsoka_tpu_torch.device import synchronize
    from ahsoka_tpu_torch.pipeline import run_phase
    from ahsoka_tpu_torch.thread.dp_torch import thread_chains_batched
    from ahsoka_tpu_torch.utils.accuracy import score_phased_output
    from ahsoka_tpu_torch.utils.synth import write_synthetic

    work = os.path.join(WORK, name)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    plan = spec.plan()
    if inputs is None:
        gfa, gaf, truth = (os.path.join(work, f"{name}.{x}")
                           for x in ("gfa", "gaf", "truth"))
        t0 = time.perf_counter()
        write_synthetic(gfa, gaf, spec, truth_path=truth)
        log(f"{name}: {len(plan)} chains (bubbles, ploidy) "
            f"{sorted(set(plan))}, {spec.total_reads} GAF records "
            f"generated in {time.perf_counter() - t0:.1f} s")
    else:
        gfa, gaf, truth = inputs
    pmap = None
    if ploidy_map:
        pmap = _ploidy_map_from_truth(gfa, truth, cfg)
        log(f"{name}: ploidy map from the planted truth {pmap}")
        cfg = dataclasses.replace(cfg, ploidy_map=pmap)
    outstem = os.path.join(work, "run")

    torch.cuda.reset_peak_memory_stats(dev)
    _reset_path_counts()
    t0 = time.perf_counter()
    art = run_phase(gfa, gaf, outstem, cfg, device=dev, keep_going=False)
    synchronize(dev)
    wall = time.perf_counter() - t0
    launches = _path_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"{name} run_phase on the card: {wall:.2f} s; kernel launches, "
        f"beam groups and banded chains {json.dumps(launches)}; peak "
        f"device memory {peak} bytes")

    with open(f"{outstem}-metrics.json") as fh:
        m = json.load(fh)
    if m["chains_phased"] != len(plan) or m["chains_failed"]:
        raise AssertionError(f"{name}: {m['chains_phased']}/{len(plan)} "
                             f"chains phased, {m['chains_failed']} failed")

    t0 = time.perf_counter()
    th = art.threading
    cpu_paths = thread_chains_batched(th["dps"], cfg,
                                      chain_configs=th["configs"],
                                      device="cpu")
    if cpu_paths != th["paths"]:
        bad = sum(a != b for a, b in zip(cpu_paths, th["paths"]))
        raise AssertionError(f"{name}: {bad} chains thread differently on "
                             "the CPU plain path")
    log(f"{name}: re-threaded {len(cpu_paths)} chains with the plain "
        f"versions on the CPU in {time.perf_counter() - t0:.2f} s: paths "
        "identical")

    kernel_ms = _dp_kernel_device_ms(dev, th, cfg)
    log(f"{name}: DP kernels' device time re-threading the run's DP inputs "
        f"on the card (torch.profiler): {json.dumps(kernel_ms)}")

    acc = score_phased_output(outstem, truth)
    stages = {k: v for k, v in m["stage_seconds"].items()
              if k != "substages"}
    log(f"{name} stage_seconds {json.dumps(stages)}")
    log(f"{name} substages "
        f"{json.dumps(m['stage_seconds'].get('substages', {}))}")
    log(f"{name} accuracy vs planted truth {json.dumps(acc)}")
    slow = sorted(m["chains"], key=lambda c: -c["stage_seconds"].get(
        "clustering", 0.0))[:5]
    log(f"{name} slowest chains in clustering (chain, bubbles, reads, "
        "clusters, clustering s, scoring s): " + json.dumps(
            [(c["chain_id"], c["bubbles"], c["reads"], c["clusters"],
              c["stage_seconds"].get("clustering"),
              c["stage_seconds"].get("scoring")) for c in slow]))
    if not acc.get("switch_err_vs_truth", 1.0) < max_switch_err:
        raise AssertionError(f"{name}: switch error {acc} not below "
                             f"{max_switch_err}")
    for kname in kernels:
        if launches[kname] == 0:
            raise AssertionError(f"{name}: kernel {kname} was not launched "
                                 "by the run")
    groups = _beam_groups(th)
    if beam and not 0 < groups == launches["beam"]:
        raise AssertionError(f"{name}: {launches['beam']} of {groups} beam "
                             "DP groups ran on the card")
    if banded and launches["banded"] == 0:
        raise AssertionError(f"{name}: no chain took banded scoring")
    return {"launches": launches, "wall": wall, "beam_groups": groups,
            "config": cfg, "ploidy_map": pmap, "work": work,
            "inputs": (gfa, gaf, truth), "stem": outstem, "threading": th,
            "art": art,
            "chains": len(plan), "spec": spec, "kernels": kernels,
            "max_switch_err": max_switch_err, "banded": banded,
            "dp_kernel_device_ms": kernel_ms, "peak_device_bytes": peak,
            "stage_seconds": stages, "accuracy": acc,
            "chain_stage_seconds": [c["stage_seconds"]
                                    for c in m["chains"]],
            "clustering_solver_cpu_s": m["stage_seconds"].get(
                "substages", {}).get("clustering.solver")}


def _dp_kernel_device_ms(dev, th, cfg) -> dict:
    """Device time (ms) and launches of each DP kernel while the run's DP
    inputs are threaded once more on the card, from a torch.profiler
    trace of that re-threading alone."""
    import torch

    from ahsoka_tpu_torch.device import synchronize
    from ahsoka_tpu_torch.thread.dp_torch import thread_chains_batched

    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        thread_chains_batched(th["dps"], cfg, chain_configs=th["configs"],
                              device=dev)
        synchronize(dev)
    out = {}
    for ev in prof.key_averages():
        for kname in DP_KERNELS:
            # the demangled name: dpk_forward<4>(...), dpk_backtrace(...)
            if f"{kname}<" in ev.key or f"{kname}(" in ev.key:
                ms, n = out.get(kname, (0.0, 0))
                out[kname] = (ms + ev.self_device_time_total / 1e3,
                              n + ev.count)
    return {k: {"ms": v[0], "launches": v[1]} for k, v in out.items()}


def e2e_runs(dev, which) -> dict:
    """The end-to-end runs named in ``which`` (config4s, config3c, mixed,
    config5s), each held to the JAX package's reference digests."""
    from ahsoka_tpu_torch.config import PhasingConfig
    from ahsoka_tpu_torch.utils.synth import CONFIGS, MIXED

    threads = min(os.cpu_count() or 1, 8)
    bench = dict(debug_readset_files=False, max_coverage=64, threads=threads)
    diploid = ("dpk_forward_warp", "dpk_backtrace")
    general = ("dpk_forward", "dpk_backtrace")
    out = {}
    if "config4s" in which:
        out["config4s"] = phase_e2e(dev, "config4s",
                                    CONFIGS["config4s"],
                                    PhasingConfig(**bench), diploid,
                                    0.01)
    if "config3c" in which:
        # scripts/bench_e2e.py's settings for ploidy > 2
        out["config3c"] = phase_e2e(
            dev, "config3c", CONFIGS["config3c"],
            PhasingConfig(ploidy=4, genotype_prior="balanced", **bench),
            general, 0.02)
    if "mixed" in which:
        out["mixed"] = phase_e2e(
            dev, "mixed", MIXED,
            PhasingConfig(genotype_prior="balanced", **bench),
            DP_KERNELS, MIXED_MAX_SWITCH_ERR, ploidy_map=True)
    if "config5s" in which:
        # scripts/bench_e2e.py's settings, the beam width it passes
        out["config5s"] = phase_e2e(
            dev, "config5s", CONFIGS["config5s"],
            PhasingConfig(genotype_prior="balanced",
                          dp_beam_width=BEAM_WIDTH, **bench),
            DP_KERNELS, 0.02, ploidy_map=True, beam=True,
            banded=True)
    for name, r in out.items():
        r["reference"] = reference_check(dev, name, r)
    return out


# ------------------------------------------------- the JAX reference
# a run whose chains differ from the reference more often than this fails
# before any chain is re-run on the CPU
REFERENCE_MAX_DIFFERING = 0.05


def reference_verdict(name: str, entry: dict, got: dict, explain) -> dict:
    """Hold a run's ``run_digests`` ``got`` to the JAX package's reference
    ``entry`` (``ahsoka_tpu_torch/data/jax_reference.json``), chain by
    chain.  A differing chain passes if it is one of the entry's
    ``allowed`` chains with the port's digest recorded there, or a
    near-tie: ``explain(chain_id)`` (``_near_tie_evidence``) finds equal
    allele matrices on the card and the CPU, scores that agree (dense
    within rtol = atol = 1e-4, banded edges equal with weights within
    1e-5), a CPU clustering that differs from the card's, and a CPU chain
    file equal to the reference's.  Anything else raises; more than
    ``REFERENCE_MAX_DIFFERING`` of the chains differing raises before
    ``explain`` is called."""
    from ahsoka_tpu_torch.utils.digest import compare_digests

    diff = compare_digests(entry["digests"], got)
    chains = len(entry["digests"]["chains"])
    if diff["extra"] or "bubbleinfo" in diff["files"] \
            or ("result" in diff["files"] and not diff["chains"]):
        raise AssertionError(f"{name}: the run's files differ from the JAX "
                             f"package's beyond its chains: {diff}")
    allowed = {int(a["chain"]): a["port_digest"]
               for a in entry.get("allowed", [])}
    ok_allowed = [c for c in diff["chains"]
                  if allowed.get(c) == got["chains"].get(str(c))]
    rest = [c for c in diff["chains"] if c not in ok_allowed]
    if len(rest) > REFERENCE_MAX_DIFFERING * chains:
        raise AssertionError(f"{name}: {len(rest)} of {chains} chains differ "
                             f"from the JAX package's: {rest[:20]}")
    evidence = []
    for c in rest:
        why = explain(c)
        if not (why["matrix_equal"] and why["scores_close"]
                and not why["same_clusters"]
                and why["cpu_digest"] == entry["digests"]["chains"][str(c)]):
            raise AssertionError(f"{name}: chain {c} differs from the JAX "
                                 f"package's, unexplained: {why}")
        evidence.append(why)
    return {"config": name, "chains": chains,
            "equal": chains - len(diff["chains"]), "near_tie": rest,
            "allowed": ok_allowed, "near_tie_evidence": evidence}


def _chain_reads(art, chain_id: int) -> dict:
    """A chain's reads as the run held them: its columnar bucket, or its
    alignment objects."""
    if art.gaf_columns is not None:
        return {"alignments": None, "columns": art.gaf_columns,
                "bucket": art.chain_buckets.get(chain_id)}
    return {"alignments": art.alignments.chain_alignments(chain_id)}


def _chain_pieces(device, art, cfg, chain_id: int, stem: str) -> dict:
    """One chain of a run through the port's allele matrix, scoring and
    cluster editing on ``device``, with the batched driver's choices
    (collapsing, dense or banded scoring)."""
    import numpy as np

    from ahsoka_tpu_torch.cluster._native_ce import cluster_editing_sparse
    from ahsoka_tpu_torch.cluster.editing import cluster_editing
    from ahsoka_tpu_torch.phase import (ChainPhasingResult, _chain_collapse,
                                        _chain_matrix_stage, chain_config)
    from ahsoka_tpu_torch.score.banded import score_pairs_banded
    from ahsoka_tpu_torch.score.device import score_pairs_device

    ccfg = chain_config(cfg, chain_id)
    res = ChainPhasingResult(chain_id=chain_id, num_bubbles=0, skipped=True)
    matrix = _chain_matrix_stage(chain_id, art.allele_paths[chain_id],
                                 outstem=stem, config=ccfg, result=res,
                                 device=device, **_chain_reads(art, chain_id))
    collapse = _chain_collapse(matrix, ccfg)
    scored, mult = ((collapse.matrix, collapse.mult) if collapse is not None
                    else (matrix, None))
    banded = scored.num_reads > ccfg.banded_scoring_threshold
    if banded:
        u, v, w = score_pairs_banded(scored, ccfg, mult=mult, device=device)
        if mult is not None:
            w = w * mult[u] * mult[v]
        clusters = cluster_editing_sparse(scored.num_reads, u, v, w,
                                          mode=ccfg.ce_mode)
        scores = (u, v, w)
    else:
        scores = score_pairs_device(scored, ccfg, mult=mult, device=device)
        w = scores if mult is None else scores * np.outer(mult, mult)
        if mult is not None:
            np.fill_diagonal(w, 0.0)
        clusters = cluster_editing(w, mode=ccfg.ce_mode)
    return {"matrix": matrix, "banded": banded, "scores": scores,
            "clusters": clusters}


def _near_tie_evidence(dev, r: dict, chain_id: int) -> dict:
    """Why chain ``chain_id`` of the run ``r`` differs from the reference:
    its allele matrix, scores and clusters on the card against the CPU,
    and the digest of its chain file phased by the port on the CPU."""
    import io

    import numpy as np

    from ahsoka_tpu_torch.phase import phase_one_chain
    from ahsoka_tpu_torch.utils.digest import file_digest

    art, cfg = r["art"], r["config"]
    stem = os.path.join(r["work"], "reference_cpu", "run")
    os.makedirs(os.path.dirname(stem), exist_ok=True)
    card = _chain_pieces(dev, art, cfg, chain_id, stem)
    cpu = _chain_pieces("cpu", art, cfg, chain_id, stem)
    a, b = card["matrix"], cpu["matrix"]
    matrix_equal = (np.array_equal(a.alleles, b.alleles)
                    and a.read_names == b.read_names)
    if card["banded"] != cpu["banded"]:
        close, err = False, None
    elif card["banded"]:
        (au, av, aw), (bu, bv, bw) = card["scores"], cpu["scores"]
        same = np.array_equal(au, bu) and np.array_equal(av, bv)
        err = float(np.abs(aw - bw).max(initial=0.0)) if same else None
        close = same and bool(np.allclose(aw, bw, rtol=1e-5, atol=1e-5))
    else:
        same = card["scores"].shape == cpu["scores"].shape
        err = (float(np.abs(card["scores"] - cpu["scores"]).max(initial=0.0))
               if same else None)
        close = same and bool(np.allclose(card["scores"], cpu["scores"],
                                          rtol=1e-4, atol=1e-4))
    phase_one_chain(chain_id, art.allele_paths[chain_id], graph=art.graph,
                    outstem=stem, full_output=io.StringIO(), config=cfg,
                    backend="jax", device="cpu", **_chain_reads(art, chain_id))
    return {"chain": chain_id, "reads": a.num_reads,
            "banded": card["banded"], "matrix_equal": matrix_equal,
            "scores_close": close, "max_abs_score_diff": err,
            "clusters": [len(card["clusters"]), len(cpu["clusters"])],
            "same_clusters": card["clusters"] == cpu["clusters"],
            "cpu_digest": file_digest(
                f"{stem}-chain{chain_id}-result.txt")}


def reference_check(dev, name: str, r: dict) -> dict:
    """The run ``r`` of phase_e2e against the JAX package's reference
    entry ``name``: the spec, the settings and the ploidy map first (a
    mismatch raises), then every file (``reference_verdict``).  Prints
    the ``reference`` line."""
    from ahsoka_tpu_torch.utils.digest import (config_fields,
                                               load_reference,
                                               ploidy_map_json, run_digests,
                                               spec_fields)

    entry = load_reference()[name]
    ours = {"spec": spec_fields(r["spec"]),
            "config": config_fields(r["config"]),
            "ploidy_map": ploidy_map_json(r["ploidy_map"])}
    for key, value in ours.items():
        if value != entry[key]:
            raise AssertionError(f"{name}: the run's {key} {value} is not "
                                 f"the reference's {entry[key]}")
    t0 = time.perf_counter()
    got = run_digests(r["stem"])
    digest_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = reference_verdict(name, entry, got,
                            lambda c: _near_tie_evidence(dev, r, c))
    out.update(digest_s=digest_s, near_tie_rerun_s=time.perf_counter() - t0)
    log(json.dumps({"reference": out}))
    return out


# ------------------------------------------------- per-chain driver, host
def perchain_run(dev, name: str, r: dict) -> dict:
    """The end-to-end run ``r`` of phase_e2e again with ``batch_dp=False``
    on the same inputs: result, bubbleinfo and every chain file byte-equal
    to the batched run's, one forward and one backtrace launch a phased
    chain, paths identical to the batched run's (and, by phase_e2e, to a
    plain CPU re-threading).  Dense scores of one chain at a time against
    the same chains scored in one batched call on the card: the largest
    |d| (single-ploidy runs)."""
    import dataclasses

    import numpy as np

    from ahsoka_tpu_torch.dist.sim import compare_outputs, output_names
    from ahsoka_tpu_torch.score import device as score_device

    cfg = dataclasses.replace(r["config"], batch_dp=False)
    scored = []
    real = score_device.score_pairs_device

    def spy(matrix, config, *a, mult=None, **k):
        out = real(matrix, config, *a, mult=mult, **k)
        scored.append((matrix, mult, out))
        return out

    score_device.score_pairs_device = spy
    try:
        s = phase_e2e(dev, f"{name}_perchain", r["spec"], cfg, r["kernels"],
                      r["max_switch_err"], banded=r["banded"],
                      inputs=r["inputs"])
    finally:
        score_device.score_pairs_device = real
    bad = compare_outputs(r["stem"], s["stem"])
    if bad:
        raise AssertionError(f"{name}: the per-chain run differs from the "
                             f"batched run: {bad[:5]}")
    th, launches = s["threading"], s["launches"]
    chains = sum(1 for dp in th["dps"] if dp.num_positions)
    forward = launches["dpk_forward_warp"] + launches["dpk_forward"]
    if not forward == launches["dpk_backtrace"] == chains == s["chains"]:
        raise AssertionError(f"{name} per-chain: launches {launches} for "
                             f"{chains} threaded of {s['chains']} chains")
    if th["paths"] != r["threading"]["paths"]:
        raise AssertionError(f"{name}: per-chain paths differ from the "
                             "batched run's")
    diff = None
    if scored and not cfg.ploidy_map:
        many = score_device.score_pairs_device_many(
            [mx for mx, _mu, _o in scored], cfg,
            mults=[mu for _mx, mu, _o in scored], device=dev)
        diff = max(float(np.abs(o - b).max(initial=0.0))
                   for (_mx, _mu, o), b in zip(scored, many))
    stages, base = s["stage_seconds"], r["stage_seconds"]
    out = {"files_byte_equal": len(output_names(r["stem"])),
           "chains": chains, "launches": launches,
           "phase_s": stages["phase"], "batched_phase_s": base["phase"],
           "dp_device_window_s": stages.get("dp_device_window"),
           "batched_dp_device_window_s": base.get("dp_device_window"),
           "device_warmup_s": stages.get("device_warmup"),
           "batched_device_warmup_s": base.get("device_warmup"),
           "dp_kernel_device_ms": s["dp_kernel_device_ms"],
           "peak_device_bytes": s["peak_device_bytes"],
           "batched_peak_device_bytes": r["peak_device_bytes"],
           "chains_scored_dense": len(scored),
           "max_abs_score_diff_one_vs_batched": diff,
           "accuracy": s["accuracy"]}
    log(f"{name} per-chain (batch_dp=False) vs batched on the card: "
        + json.dumps(out))
    return out


def phase_perchain(dev, e2e) -> dict:
    """config4s, config3c and mixed through the per-chain driver."""
    return {name: perchain_run(dev, name, e2e[name])
            for name in ("config4s", "config3c", "mixed")}


def _host_goldens(dev) -> None:
    """The port's host backend (the CLI's ``--backend host``) on both
    goldens: byte-equal to tests/data, readset debug files written."""
    from ahsoka_tpu_torch.cli.main import main as cli_main

    work = os.path.join(WORK, "host_golden")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    for golden, argv, pairs in (
            ("golden_diploid", [],
             [("d-result.txt", "golden_diploid-result.txt"),
              ("d-bubbleinfo.txt", "golden_diploid-bubbleinfo.txt"),
              ("golden_diploid-alignment_identities.txt",
               "golden_diploid-identities.txt")]),
            ("golden_tetra", ["--ploidy", "4", "--no-genotypes"],
             [("t-result.txt", "golden_tetra-result.txt"),
              ("golden_tetra-alignment_identities.txt",
               "golden_tetra-alignment_identities.txt")])):
        gaf = os.path.join(work, f"{golden}.gaf")
        shutil.copy(os.path.join(DATA, f"{golden}.gaf"), gaf)
        stem = os.path.join(work, pairs[0][0].split("-")[0])
        rc = cli_main(["phase", "-g", os.path.join(DATA, f"{golden}.gfa"),
                       "-a", gaf, "-o", stem, "--device", str(dev),
                       "--backend", "host"] + argv)
        if rc != 0 or not any(f.endswith("-readset.txt")
                              for f in os.listdir(work)):
            raise AssertionError(f"host backend on {golden}: rc {rc} or "
                                 "no readset debug file")
        for got, want in pairs:
            with open(os.path.join(work, got), "rb") as a, \
                    open(os.path.join(DATA, want), "rb") as b:
                if a.read() != b.read():
                    raise AssertionError(f"host backend: {got} differs "
                                         f"from {want}")
    log("host backend on both goldens: result, bubbleinfo and identities "
        "byte-equal to tests/data, readset debug files written")


def _host_vs_card_chain(dev, art, cfg, chain_id) -> dict:
    """Why one chain's host and card results differ: the host readset's
    allele matrix against the card's, the host's float64 pair scores
    against the card's float32 ones, and the two clusterings."""
    import numpy as np

    from ahsoka_tpu_torch.cluster.editing import cluster_editing
    from ahsoka_tpu_torch.phase import (ChainPhasingResult,
                                        _chain_matrix_stage, chain_config)
    from ahsoka_tpu_torch.project.readset import build_chain_readsets
    from ahsoka_tpu_torch.score.device import score_pairs_device
    from ahsoka_tpu_torch.score.pairwise import (readset_to_matrix,
                                                 score_pairs)

    ccfg = chain_config(cfg, chain_id)
    bubble_paths = art.allele_paths[chain_id]
    alignments = art.alignments.chain_alignments(chain_id)
    host_m = readset_to_matrix(build_chain_readsets(
        bubble_paths, alignments, ccfg).partial_filtered)
    res = ChainPhasingResult(chain_id=chain_id, num_bubbles=0, skipped=True)
    card_m = _chain_matrix_stage(chain_id, bubble_paths, alignments,
                                 os.path.join(WORK, "host_mixed", "diag"),
                                 ccfg, res, device=dev)
    same_matrix = (np.array_equal(host_m.alleles, card_m.alleles)
                   and host_m.read_names == card_m.read_names)
    host_s = score_pairs(host_m, ccfg)
    card_s = score_pairs_device(card_m, ccfg, device=dev)
    host_c = cluster_editing(host_s, mode=ccfg.ce_mode)
    card_c = cluster_editing(card_s, mode=ccfg.ce_mode)
    return {"chain": chain_id, "ploidy": ccfg.ploidy,
            "reads": host_m.num_reads, "matrix_equal": same_matrix,
            "max_abs_score_diff": float(np.abs(host_s - card_s).max()),
            "scores_within_1e-4": bool(np.allclose(card_s, host_s,
                                                   rtol=1e-4, atol=1e-4)),
            "clusters": [len(host_c), len(card_c)],
            "same_clusters": host_c == card_c}


def _sorted_path(path) -> list:
    return [tuple(sorted(t)) for t in path]


def _native_path(dp, c) -> list:
    """One chain's DP inputs through the native sequential DP (float32,
    one core) -> its multiset path."""
    import numpy as np

    from ahsoka_tpu_torch.thread._native_dp import run_native_dp
    from ahsoka_tpu_torch.thread.states import state_tuples

    k = c.ploidy
    _cells, states = run_native_dp(
        dp.candidates, dp.num_candidates, dp.coverage, dp.consensus,
        dp.genotypes.astype(np.float32), k, c.switch_cost,
        c.affine_switch_cost, c.coverage_cost_weight,
        c.genotype_cost_weight if c.use_genotypes else 0.0)
    tuples = state_tuples(2 * k, k)
    return [tuple(int(dp.candidates[j, s]) for s in tuples[int(st)])
            for j, st in enumerate(states)]


def _path_cost(dp, path, c) -> float:
    """A multiset path's cost in the host oracle's float64 cost model
    (``thread/dp_host.py``)."""
    from collections import Counter

    from ahsoka_tpu_torch.thread.dp_host import node_costs
    from ahsoka_tpu_torch.thread.states import (full_state_validity,
                                                state_tuples)

    k = c.ploidy
    valid, tuples = full_state_validity(k), state_tuples(2 * k, k)
    total = 0.0
    for j, tup in enumerate(path):
        m, target = int(dp.num_candidates[j]), sorted(tup)
        s = next(s for s, slots in enumerate(tuples) if valid[m, s]
                 and sorted(int(dp.candidates[j, x]) for x in slots)
                 == target)
        total += float(node_costs(dp, j, c)[s])
        if j:
            sw = k - sum((Counter(path[j - 1]) & Counter(tup)).values())
            total += c.switch_cost * sw + c.affine_switch_cost * (sw > 0)
    return total


def _host_mixed(dev, mixed) -> dict:
    """mixed with max_coverage=None and collapsing off (where the JAX
    package compares its backends): the host backend (numpy, on the CPU)
    against the card's batched run with the same config, chain by chain.
    A chain either writes the same file, or its allele matrices are equal,
    its scores agree within the JAX package's device tolerance (rtol =
    atol = 1e-4) and the two clusterings differ (a near-tie that float32
    scores on the card and float64 ones on the host break apart).  The
    card's DP kernels thread the host's own DP inputs to the host's paths
    (sorted tuples) in every chain."""
    import dataclasses

    from ahsoka_tpu_torch.dist.sim import compare_outputs, output_names
    from ahsoka_tpu_torch.pipeline import run_phase
    from ahsoka_tpu_torch.thread.dp_torch import thread_chains_batched

    work = os.path.join(WORK, "host_mixed")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    gfa, gaf, _truth = mixed["inputs"]
    cfg = dataclasses.replace(mixed["config"], max_coverage=None,
                              ce_collapse_identical=False,
                              debug_readset_files=False)
    t0 = time.perf_counter()
    run_phase(gfa, gaf, os.path.join(work, "card"), cfg, device=dev)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    art = run_phase(gfa, gaf, os.path.join(work, "host"),
                    dataclasses.replace(cfg, backend="host"), device=dev)
    host_s = time.perf_counter() - t0
    bad = compare_outputs(os.path.join(work, "card"),
                          os.path.join(work, "host"))
    th = art.threading
    card_paths = thread_chains_batched(th["dps"], cfg,
                                       chain_configs=th["configs"],
                                       device=dev)
    dp_checks = []
    for dp, c, host_path, card_path in zip(th["dps"], th["configs"],
                                           th["paths"], card_paths):
        native = _sorted_path(_native_path(dp, c))
        host_cost = _path_cost(dp, host_path, c)
        card_cost = _path_cost(dp, card_path, c)
        if _sorted_path(card_path) != native \
                or abs(card_cost - host_cost) > 1e-5 * abs(host_cost):
            raise AssertionError(f"host mixed: the card's DP kernels thread "
                                 f"the host's ploidy-{c.ploidy} DP inputs "
                                 f"to another path than the native DP, or "
                                 f"cost {card_cost} vs the host's "
                                 f"{host_cost}")
        dp_checks.append({
            "ploidy": c.ploidy, "positions": dp.num_positions,
            "positions_off_host_path": sum(
                a != b for a, b in zip(_sorted_path(card_path),
                                       _sorted_path(host_path))),
            "cost_card": card_cost, "cost_host": host_cost})
    differing = []
    for suffix, _why in bad:
        if suffix == "-result.txt":
            continue
        chain_id = int(suffix[len("-chain"):-len("-result.txt")])
        why = _host_vs_card_chain(dev, art, cfg, chain_id)
        differing.append(why)
        if not (why["matrix_equal"] and why["scores_within_1e-4"]
                and not why["same_clusters"]):
            raise AssertionError(f"host mixed: chain {chain_id} differs "
                                 f"unexplained: {why}")
    if any(s != "-result.txt" and not s.startswith("-chain")
           for s, _w in bad) or (bad and not differing):
        raise AssertionError(f"host mixed: {bad}")
    out = {"files": len(output_names(os.path.join(work, "card"))),
           "chains": len(th["dps"]), "chains_differing": differing,
           "card_run_s": card_s, "host_run_s": host_s,
           "card_dp_on_host_inputs": dp_checks}
    log("host backend vs the card on mixed (max_coverage=None, no "
        "collapsing): " + json.dumps(out))
    return out


def _native_vs_card(e2e) -> dict:
    """The native sequential DP (one core) on config4s's and config3c's DP
    inputs: the card's paths, as sorted tuples, in every chain."""
    out = {}
    for name in ("config4s", "config3c"):
        th = e2e[name]["threading"]
        t0 = time.perf_counter()
        for dp, c, path in zip(th["dps"], th["configs"], th["paths"]):
            if _sorted_path(_native_path(dp, c)) != _sorted_path(path):
                raise AssertionError(f"native DP != the card's path in a "
                                     f"{name} chain (P={dp.num_positions})")
        out[name] = {"chains": len(th["dps"]),
                     "native_s": time.perf_counter() - t0,
                     "card_dp_device_window_s":
                         e2e[name]["stage_seconds"].get("dp_device_window")}
    log("native sequential DP == the card's paths (sorted tuples): "
        + json.dumps(out))
    return out


def _assoc_vs_kernel(dev) -> dict:
    """The log-depth associative-scan DP on the card against the CPU, and
    its final minimum cost against ``dpk_forward_warp``'s on one diploid
    chain of P = 10,000 (rtol 1e-5: the two add in different orders)."""
    import numpy as np
    import torch

    from ahsoka_tpu_torch.ops import minplus_diploid as md
    from ahsoka_tpu_torch.state import to_torch
    from ahsoka_tpu_torch.thread.dp_assoc import _assoc_forward
    from ahsoka_tpu_torch.thread.states import (full_state_counts,
                                                full_state_validity)

    P = 10000
    arrays = random_dp_batch(1, P, seed=_seed(2, 1, P), ploidy=2)
    kw = dict(ploidy=2, num_alleles=2, switch_cost=SWITCH,
              affine_cost=AFFINE, cov_w=1.0, geno_w=1.0)
    tables = (full_state_counts(2), full_state_validity(2))

    def assoc(device):
        return _assoc_forward(*to_torch(*(a[0] for a in arrays),
                                        device=device), *tables, **kw)

    fwd_card, _T = assoc(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fwd_cpu, _T = assoc("cpu")
    cpu_ms = (time.perf_counter() - t0) * 1e3
    card_ms = _median_ms(lambda: assoc(dev), 3)
    fwd_card = fwd_card.cpu()
    if not torch.allclose(fwd_card, fwd_cpu, rtol=1e-5, atol=0):
        raise AssertionError("dp_assoc: forward costs differ between the "
                             "card and the CPU")
    cand, node = _node_costs(arrays, dev, 2)
    fin, _bp = md.minplus_forward_diploid(cand, node, switch_cost=SWITCH,
                                          affine_cost=AFFINE)
    kern = float(fin.min())
    got = float(fwd_card[-1].min())
    rel = abs(got - kern) / abs(kern)
    if not rel <= 1e-5:
        raise AssertionError(f"dp_assoc final cost {got} vs dpk_forward_warp "
                             f"{kern} (rel {rel:.3g})")
    out = {"P": P, "final_cost": got, "kernel_final_cost": kern,
           "rel_diff": rel,
           "max_abs_card_vs_cpu": float(np.abs(
               fwd_card.numpy() - fwd_cpu.numpy()).max()),
           "card_ms": card_ms, "cpu_ms": cpu_ms}
    log("dp_assoc (Hillis-Steele min-plus scan) on the card: "
        + json.dumps(out))
    return out


def phase_host(dev, e2e) -> dict:
    """The host oracle: goldens, mixed against the card, the native DP and
    the log-depth DP against the kernels."""
    _host_goldens(dev)
    return {"mixed": _host_mixed(dev, e2e["mixed"]),
            "native_dp": _native_vs_card(e2e),
            "dp_assoc": _assoc_vs_kernel(dev)}


def phase_config2(dev) -> dict:
    """config2 (one chain of 10,000 bubbles, 50k GAF records) through both
    drivers on the card: byte-equal; banded scoring, the sparse solver
    and one C=1, P~10,000 diploid DP; switch error below 0.01."""
    from ahsoka_tpu_torch.config import PhasingConfig
    from ahsoka_tpu_torch.utils.synth import CONFIGS

    threads = min(os.cpu_count() or 1, 8)
    cfg = PhasingConfig(debug_readset_files=False, max_coverage=64,
                        threads=threads)
    r = phase_e2e(dev, "config2", CONFIGS["config2"], cfg,
                  ("dpk_forward_warp", "dpk_backtrace"), 0.01, banded=True)
    reference = reference_check(dev, "config2", r)
    s = perchain_run(dev, "config2", r)
    chain = r["chain_stage_seconds"][0]
    out = {"phase_s": r["stage_seconds"]["phase"], "stages": chain,
           "banded_scoring_s": chain.get("scoring"),
           "sparse_solver_thread_s": r["clustering_solver_cpu_s"],
           "peak_device_bytes": r["peak_device_bytes"],
           "switch_err_vs_truth": r["accuracy"].get("switch_err_vs_truth"),
           "jax_package_switch_err_tpu": 0.0023,
           "dp_kernel_device_ms": r["dp_kernel_device_ms"],
           "reference": reference, "perchain": s}
    log(json.dumps({"config2": out}))
    return out


def phase_config5(dev) -> dict:
    """config5 (3,000 ragged chains of ploidy 2, 4 and 6, ~3.9M GAF
    records) through the port's ``scripts/bench_e2e.py`` on the card, with
    its inputs, ploidy map and outstem under ``build/bench/``: every
    chain phased and none failed, all three DP kernels launched, every
    hexaploid DP group on the beam, switch error below 0.02."""
    from ahsoka_tpu_torch.scripts import BUILD_BENCH, bench_e2e

    t0 = time.perf_counter()
    gfa, gaf, truth, spec, pmap = bench_e2e.ensure_inputs("config5",
                                                          BUILD_BENCH)
    log(f"config5: {len(spec.plan())} chains, {spec.total_reads} GAF "
        f"records; inputs and ploidy map in {time.perf_counter() - t0:.1f} s")
    _reset_path_counts()
    row, art = bench_e2e.phase_e2e(
        gfa, gaf, os.path.join(BUILD_BENCH, "config5", "run"),
        ploidy=spec.ploidy, threads=min(os.cpu_count() or 1, 8),
        truth=truth, ploidy_map=pmap, device=dev)
    launches = _path_counts()
    groups = _beam_groups(art.threading)
    out = {"row": row, "launches": launches, "beam_groups": groups}
    log(json.dumps({"config5": out}))
    if row["chains_phased"] != len(spec.plan()) or row["chains_failed"]:
        raise AssertionError(f"config5: {row['chains_phased']} of "
                             f"{len(spec.plan())} chains phased, "
                             f"{row['chains_failed']} failed")
    if not all(launches[k] for k in DP_KERNELS):
        raise AssertionError(f"config5: launches {launches}")
    if not 0 < groups == launches["beam"]:
        raise AssertionError(f"config5: {launches['beam']} of {groups} "
                             "beam DP groups ran on the card")
    err = (row["accuracy_vs_planted_truth"] or {}).get("switch_err_vs_truth")
    if not (err is not None and err < 0.02):
        raise AssertionError(f"config5: switch error {err} not below 0.02")
    return out


# ---------------------------------------------------------------- phase 6
def phase_beam(dev) -> dict:
    """The beam DP on the card against the CPU, exactly, at config5s's
    longest hexaploid group shape and on an all-ties batch."""
    import torch

    from ahsoka_tpu_torch.thread import dp_beam
    from ahsoka_tpu_torch.thread.states import full_state_counts

    k = 6
    counts = full_state_counts(k)

    def run(cand, node):
        fin, bs, bp = dp_beam.dp_forward_beam(
            cand, node, counts, ploidy=k, beam_width=BEAM_WIDTH,
            switch_cost=SWITCH, affine_cost=AFFINE)
        slot = torch.argmin(fin, dim=1).to(torch.int32)
        return fin, bs, bp, dp_beam.backtrace_beam(bp, bs, slot)

    out = {}
    for name, C, P in (("k6", 2, 112), ("all_ties_k6", 2, 24)):
        ties = name.startswith("all_ties")
        arrays = random_dp_batch(C, P, seed=C * 7919 + P + 4 * 104729,
                                 ploidy=k)
        if ties:
            all_ties(arrays)
        cand, node = _node_costs(arrays, dev, k, ties)
        if not torch.equal(node.cpu(), _node_costs(arrays, "cpu", k,
                                                   ties)[1]):
            raise AssertionError(f"beam {name}: node costs differ between "
                                 "the card and the CPU")
        got = run(cand, node)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = run(cand.cpu(), node.cpu())
        cpu_ms = (time.perf_counter() - t0) * 1e3
        for what, g, w in zip(("final costs", "beam states", "backptrs",
                               "states"), got, want):
            if not torch.equal(g.cpu(), w):
                raise AssertionError(f"beam {name}: {what} differ between "
                                     "the card and the CPU")
        if ties and not bool((want[0] == want[0][:, :1]).sum(dim=1).gt(1)
                             .all()):
            raise AssertionError("beam all_ties_k6: no tied frontier")
        ms = _median_ms(lambda: run(cand, node), 3)
        out[name] = {"C": C, "P": P, "k": k, "B": BEAM_WIDTH,
                     "ms": ms, "cpu_ms": cpu_ms}
        log(f"beam {name} k={k} B={BEAM_WIDTH} C={C} P={P}: card == CPU "
            f"exactly; card {ms:.2f} ms, CPU {cpu_ms:.1f} ms "
            f"({torch.get_num_threads()} threads)")
    return out


# ---------------------------------------------------------------- phase 7
def banded_matrix(R: int, P: int, seed: int):
    """Seeded diploid chain matrix: R reads of 6-12 consecutive
    positions (starts sorted, so rows are ordered by first position) from
    two haplotypes over P biallelic positions, alleles flipped at 2%."""
    import numpy as np

    from ahsoka_tpu_torch.score.pairwise import AlleleMatrix

    rng = np.random.default_rng(seed)
    haps = rng.integers(0, 2, size=(2, P))
    starts = np.sort(rng.integers(0, P - 6, size=R))
    alleles = np.full((R, P), -1, dtype=np.int16)
    for r, s0 in enumerate(starts):
        cols = np.arange(s0, min(P, s0 + int(rng.integers(6, 13))))
        row = haps[r % 2, cols]
        flip = rng.random(len(cols)) < 0.02
        alleles[r, cols] = np.where(flip, 1 - row, row)
    return AlleleMatrix(alleles=alleles,
                        positions=np.arange(P, dtype=np.int32),
                        read_names=[f"read{r}" for r in range(R)])


def phase_banded(dev) -> dict:
    """Banded scoring on the card against the CPU on one seeded chain."""
    import numpy as np

    from ahsoka_tpu_torch.config import PhasingConfig
    from ahsoka_tpu_torch.device import synchronize
    from ahsoka_tpu_torch.score.banded import score_pairs_banded

    R, P = 8000, 1500
    matrix = banded_matrix(R, P, seed=9)
    cfg = PhasingConfig()
    score_pairs_banded(matrix, cfg, device=dev)          # warm up
    synchronize(dev)
    t0 = time.perf_counter()
    gu, gv, gw = score_pairs_banded(matrix, cfg, device=dev)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cu, cv, cw = score_pairs_banded(matrix, cfg, device="cpu")
    cpu_s = time.perf_counter() - t0
    if not (np.array_equal(gu, cu) and np.array_equal(gv, cv)):
        raise AssertionError("banded: edge lists differ between the card "
                             "and the CPU")
    err = float(np.abs(gw - cw).max(initial=0.0))
    if not np.allclose(gw, cw, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"banded: weights differ by up to {err}")
    log(f"banded R={R} P={P}: {len(gu)} edges, equal and in order on the "
        f"card and the CPU, max |dw| {err:.3g}; card {card_s:.3f} s, CPU "
        f"{cpu_s:.2f} s")
    return {"R": R, "P": P, "edges": int(len(gu)), "max_abs_err": err,
            "s": card_s, "cpu_s": cpu_s}


# --------------------------------------------------------------- phase 7a
def _study_vs_cpu(tool: str, card, cpu, dev) -> list:
    """A study tool's clusters on the card against a CPU run of the same
    study, variant by variant: equal, or a near-tie (the host phase's
    rule): equal allele matrices, dense scores within rtol = atol = 1e-4
    on the two devices, and a different clustering.  Returns the
    differing variants."""
    import numpy as np

    from ahsoka_tpu_torch.config import PhasingConfig
    from ahsoka_tpu_torch.score.device import score_pairs_device

    differing = []
    if len(card) != len(cpu):
        raise AssertionError(f"{tool}: {len(card)} studies on the card, "
                             f"{len(cpu)} on the CPU")
    for a, b in zip(card, cpu):
        bad = [v for v in b["clusters"]
               if not np.array_equal(a["clusters"].get(v), b["clusters"][v])]
        if not bad:
            continue
        ma, mb = a["matrix"], b["matrix"]
        same_matrix = (np.array_equal(ma.alleles, mb.alleles)
                       and ma.read_names == mb.read_names)
        cfg = PhasingConfig()
        sa = score_pairs_device(ma, cfg, device=dev)
        sb = score_pairs_device(mb, cfg, device="cpu")
        close = same_matrix and bool(np.allclose(sa, sb, rtol=1e-4,
                                                 atol=1e-4))
        why = {"tool": tool, "reads": a["reads"], "variants": bad,
               "matrix_equal": same_matrix, "scores_within_1e-4": close,
               "max_abs_score_diff": (float(np.abs(sa - sb).max())
                                      if same_matrix else None)}
        if not close:
            raise AssertionError(f"{tool}: the card's clusters differ from "
                                 f"the CPU's, unexplained: {why}")
        differing.append(why)
    return differing


def phase_bench(dev) -> dict:
    """The port's benches on the card: ``ahsoka_tpu_torch.bench`` at its
    default size (every DP kernel launched, ``kernel`` cuda, cells/s of
    the kernel, the plain version and the native DP), the roofline rows
    (every fraction at or below 1.05, or ``roofline.row`` raises), and the
    two study tools at small sizes on the card and on the CPU
    (``quantify_fastpaths``: one regime, 2,000 reads; ``profile_ce``: 1,000
    reads), their clusters held to each other (``_study_vs_cpu``)."""
    from ahsoka_tpu_torch import bench
    from ahsoka_tpu_torch.scripts import (profile_ce, quantify_fastpaths,
                                          roofline)
    from ahsoka_tpu_torch.thread import dp_kernels

    t0 = time.perf_counter()
    dp_kernels.reset_launch_counts()
    b = bench.run(device=dev)
    launches = dp_kernels.launch_counts()
    bench_s = time.perf_counter() - t0
    if not (all(launches[k] for k in DP_KERNELS) and b["kernel"] == "cuda"
            and b["plain_cells_per_s"] and b["baseline_native_cells_per_s"]
            and b["tetraploid_cells_per_s"]
            and b["tetraploid_plain_cells_per_s"]):
        raise AssertionError(f"bench: launches {launches}, result {b}")
    t0 = time.perf_counter()
    roof = roofline.run(device=dev)
    roof_s = time.perf_counter() - t0
    studies, rows, differing = {}, {}, []
    for tool, fn, kw in (
            ("quantify_fastpaths", quantify_fastpaths.study,
             dict(reads=(2000,), regimes=("baseline",))),
            ("profile_ce", profile_ce.profile, dict(reads=(1000,)))):
        t0 = time.perf_counter()
        card_rows, card = fn(device=dev, workdir=os.path.join(
            WORK, f"{tool}_card"), **kw)
        card_s = time.perf_counter() - t0
        cpu_rows, cpu = fn(device="cpu", workdir=os.path.join(
            WORK, f"{tool}_cpu"), **kw)
        if not card_rows or len(card_rows) != len(cpu_rows):
            raise AssertionError(f"{tool}: rows {card_rows} / {cpu_rows}")
        differing += _study_vs_cpu(tool, card, cpu, dev)
        rows[tool] = card_rows
        studies[tool] = {"card_s": card_s,
                         "cpu_s": time.perf_counter() - t0 - card_s}
    out = {"bench": b, "launches": launches, "bench_s": bench_s,
           "roofline": roof, "roofline_s": roof_s, "studies": studies,
           "study_rows": rows, "study_clusters_differing": differing}
    log(json.dumps({"bench": out}))
    return out


# ---------------------------------------------------------------- phase 9
def _nccl_self_check(dev) -> None:
    """The collectives on the card at world size 1: all_reduce(MIN) keeps
    int32 and NO_MATCH, and the uneven row gather is exact."""
    import torch

    from ahsoka_tpu_torch.dist.mesh import gather_rows, min_merge

    no_match = 2 ** 31 - 1
    a = torch.tensor([[5, no_match, 7]], dtype=torch.int32, device=dev)
    b = torch.tensor([[9, no_match, 3]], dtype=torch.int32, device=dev)
    out = min_merge([a, b], torch.full_like(a, no_match))
    if out.dtype != torch.int32 or out.cpu().tolist() != [[5, no_match, 3]]:
        raise AssertionError(f"NCCL min-merge wrong: {out}")
    rows = gather_rows([torch.ones((2, 3), device=dev),
                        torch.zeros((1, 3), device=dev)],
                       torch.empty((0, 3), device=dev))
    if rows.cpu().tolist() != [[1.0] * 3] * 2 + [[0.0] * 3]:
        raise AssertionError(f"NCCL row gather wrong: {rows}")


def _expected_shard_launches(th, shards: int) -> int:
    """Forward (and backtrace) launches of a chain-sharded DP: one per
    non-empty shard of each non-beam DP group."""
    from ahsoka_tpu_torch.thread.dp_torch import (_beam_width_for,
                                                  _bucket_positions)
    from ahsoka_tpu_torch.thread.states import max_states

    groups: dict = {}
    for dp, c in zip(th["dps"], th["configs"]):
        if dp.num_positions and not _beam_width_for(c, max_states(c.ploidy)):
            key = (_bucket_positions(dp.num_positions),
                   dp.genotypes.shape[1], c.ploidy)
            groups[key] = groups.get(key, 0) + 1
    return sum(min(n, shards) for n in groups.values())


def phase_sharded_mesh(dev, c3) -> dict:
    """config3c in the mesh layout (2 x 2 over one card, NCCL at world
    size 1) against phase 5's unsharded run."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from ahsoka_tpu_torch.device import synchronize
    from ahsoka_tpu_torch.dist.sim import (compare_outputs, free_port,
                                           output_names)
    from ahsoka_tpu_torch.pipeline import run_phase
    from ahsoka_tpu_torch.score import device as score_device
    from ahsoka_tpu_torch.thread.dp_torch import thread_chains_batched

    work, cfg = c3["work"], c3["config"]
    gfa, gaf = (os.path.join(work, f"config3c.{x}") for x in ("gfa", "gaf"))
    golden, stem = os.path.join(work, "run"), os.path.join(work, "mesh")
    sharded = dataclasses.replace(cfg, data_shards=2, chain_shards=2)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl",
                            init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    scored, calls = [], {"all_reduce": 0, "all_gather": 0}
    real_score = score_device.score_pairs_device
    real_coll = {n: getattr(dist, n) for n in calls}

    def score_spy(matrix, config, *a, mult=None, **k):
        out = real_score(matrix, config, *a, mult=mult, **k)
        scored.append((matrix, mult, out))
        return out

    def counted(name):
        def call(*a, **k):
            calls[name] += 1
            return real_coll[name](*a, **k)
        return call

    try:
        _nccl_self_check(dev)
        score_device.score_pairs_device = score_spy
        for n in calls:
            setattr(dist, n, counted(n))
        _reset_path_counts()
        t0 = time.perf_counter()
        art = run_phase(gfa, gaf, stem, sharded, device=dev,
                        devices=[dev, dev])
        synchronize(dev)
        wall = time.perf_counter() - t0
        launches = _path_counts()
    finally:
        score_device.score_pairs_device = real_score
        for n, fn in real_coll.items():
            setattr(dist, n, fn)
        dist.destroy_process_group()
    with open(f"{stem}-metrics.json") as fh:
        m = json.load(fh)
    if m["chains_failed"] or m["chains_phased"] != c3["chains"]:
        raise AssertionError(f"mesh config3c: {m['chains_phased']} phased, "
                             f"{m['chains_failed']} failed")
    bad = compare_outputs(golden, stem)
    if bad:
        raise AssertionError(f"mesh config3c differs from the unsharded "
                             f"run: {bad[:5]}")
    th = art.threading
    want = _expected_shard_launches(th, 2)
    if not (launches["dpk_forward"] == launches["dpk_backtrace"] == want
            and want > 0):
        raise AssertionError(f"mesh config3c: launches {launches}, "
                             f"expected {want} per kernel")
    if not (calls["all_reduce"] and calls["all_gather"]):
        raise AssertionError(f"mesh config3c: NCCL calls {calls}")
    cpu = thread_chains_batched(th["dps"], cfg, chain_configs=th["configs"],
                                device="cpu")
    if cpu != th["paths"]:
        raise AssertionError("mesh config3c: paths differ from the plain "
                             "CPU re-threading")
    # the run's scores, sharded or fallen back, against unsharded ones
    row_sharded = [(mx, o) for mx, mu, o in scored if mu is None]
    diff = max((float(np.abs(o - real_score(mx, cfg, device=dev)).max())
                for mx, o in row_sharded), default=None)
    seeded = banded_matrix(2048, 400, seed=5)
    one = real_score(seeded, cfg, device=dev)
    two = real_score(seeded, sharded, device=dev, devices=[dev, dev])
    seeded_diff = float(np.abs(one - two).max())
    if seeded_diff != 0.0:
        raise AssertionError(f"mesh config3c: row-block scores of a seeded "
                             f"2,048-read chain differ from unsharded by "
                             f"{seeded_diff}")
    stages = m["stage_seconds"]
    out = {"wall": wall, "phase_s": stages["phase"],
           "dp_device_window_s": stages.get("dp_device_window"),
           "unsharded_phase_s": c3["stage_seconds"]["phase"],
           "unsharded_dp_device_window_s":
               c3["stage_seconds"].get("dp_device_window"),
           "launches": launches, "expected_launches_per_kernel": want,
           "nccl_calls": calls,
           "files_byte_equal": len(output_names(golden)),
           "chains_scored": len(scored),
           "chains_row_sharded": len(row_sharded),
           "max_abs_score_diff_run": diff,
           "max_abs_score_diff_seeded_2048": seeded_diff}
    log(f"mesh config3c (2 x 2 over [{dev}, {dev}], NCCL world 1): "
        + json.dumps(out))
    return out


def phase_sharded_chains(c5) -> dict:
    """config5s in the chain layout (2 processes, 4 threads each, one
    card) against phase 8's single-process run."""
    from ahsoka_tpu_torch.dist.sim import (compare_outputs, output_names,
                                           run_chains)

    work = c5["work"]
    gfa, gaf = (os.path.join(work, f"config5s.{x}") for x in ("gfa", "gaf"))
    pmap_path = os.path.join(work, "config5s.pmap.json")
    with open(pmap_path, "w") as fh:
        json.dump({str(c): int(k) for c, k in c5["ploidy_map"].items()}, fh)
    golden = os.path.join(work, "run")
    row = run_chains(gfa, gaf, os.path.join(WORK, "config5s_chains"), 2,
                     "cuda", 4, ploidy_map=pmap_path, timeout=900)
    bad = compare_outputs(golden, row["outstem"])
    if bad:
        raise AssertionError(f"chains config5s differs from the single-"
                             f"process run: {bad[:5]}")
    ranks = row["per_rank"]
    owned = [r["chains_owned"] for r in ranks]
    if any(r["chains_failed"] for r in ranks) or sum(owned) != c5["chains"] \
            or not all(owned):
        raise AssertionError(f"chains config5s: per rank {ranks}")
    out = {"nproc": 2, "threads": 4, "wall": row["wall_s"],
           "files_byte_equal": len(output_names(golden)),
           "per_rank": ranks,
           "single_process": {
               "phase_s": c5["stage_seconds"]["phase"],
               "clustering_solver_thread_s": c5["clustering_solver_cpu_s"],
               "threads": c5["config"].threads}}
    log("chains config5s (2 processes x 4 threads, one card): "
        + json.dumps(out))
    return out


PHASES = ("env", "kernels", "golden", "config4s", "config3c", "mixed",
          "perchain", "host", "beam", "banded", "bench", "config5s",
          "sharded")
# phases that run only when named (not in "all")
EXTRA_PHASES = ("config2", "config5")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="all",
                    help=f"comma list of {','.join(PHASES + EXTRA_PHASES)} "
                         "for a partial run (prints no result line)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    phases = (set(PHASES) if args.phases == "all"
              else set(args.phases.split(",")))
    unknown = phases - set(PHASES + EXTRA_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    partial = phases != set(PHASES)
    if "sharded" in phases:
        # the sharded runs are held to these runs' outputs
        phases |= {"config3c", "config5s"}
    if phases & {"perchain", "host"}:
        # the per-chain and host runs phase these runs' inputs again
        phases |= {"config4s", "config3c", "mixed"}

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from ahsoka_tpu_torch.device import card_line, resolve_device

    dev = resolve_device("cuda")
    phase_environment(dev)
    kern = phase_kernels(dev) if "kernels" in phases else None
    if "golden" in phases:
        phase_golden(dev)
        no_reference_modules("the golden runs")
    e2e = e2e_runs(dev, phases)
    if "config5s" in phases:
        no_reference_modules("config5s")
    perchain = phase_perchain(dev, e2e) if "perchain" in phases else None
    host = phase_host(dev, e2e) if "host" in phases else None
    if phases & {"perchain", "host"}:
        no_reference_modules("the per-chain and host runs")
    beam = phase_beam(dev) if "beam" in phases else None
    banded = phase_banded(dev) if "banded" in phases else None
    benches = phase_bench(dev) if "bench" in phases else None
    if benches:
        no_reference_modules("the benches")
    sharded = None
    if "sharded" in phases:
        sharded = {"mesh_config3c": phase_sharded_mesh(dev, e2e["config3c"]),
                   "chains_config5s": phase_sharded_chains(e2e["config5s"])}
        no_reference_modules("the sharded runs")
    if "config2" in phases:
        phase_config2(dev)
        no_reference_modules("config2")
    if "config5" in phases:
        phase_config5(dev)
        no_reference_modules("config5")
    if partial:
        log("partial run: no result line")
        return 0

    from ahsoka_tpu_torch.scripts.roofline import bound

    no_reference_modules("the whole smoke")
    kernels = []
    for row, (name, src, rep, run, case) in KERNEL_META.items():
        ms, plain_ms = kern["timing"][case][name]
        bound_ms, bound_by = bound(name, *CASE_SHAPES[case])
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": rep, "tpu_kernel": row,
                 "launches": e2e[run]["launches"][name],
                 "launches_perchain": perchain[run]["launches"][name],
                 "max_abs_err": kern["err"][name], "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": bound_by, "library_ms": None,
                 "library_note": NO_LIBRARY_CALL}
        if name == "dpk_backtrace":
            entry["tile_bytes"] = backtrace_tile_bytes(*CASE_SHAPES[case])
        kernels.append(entry)
    log(json.dumps({"dpk_forward_clusters": kern["clusters"]}))
    c5 = e2e["config5s"]
    log(json.dumps({"beam": beam}))
    log(json.dumps({"banded": banded}))
    log(json.dumps({"config5s": {
        k: c5[k] for k in ("launches", "beam_groups", "wall",
                           "dp_kernel_device_ms", "clustering_solver_cpu_s",
                           "stage_seconds")}}))
    log(f"chip_smoke: all phases in {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"sharded": sharded}))
    log(json.dumps({"perchain": perchain}))
    log(json.dumps({"host": host}))
    log(json.dumps({"bench": benches}))
    log(card_line(dev))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
