#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (ahsoka_tpu_torch) on one GPU.

    python3 chip_smoke.py                          # all phases, one CUDA card
    python3 chip_smoke.py --phases env,kernels     # build + kernel checks only

Runs from the repository root with no install and no jax:

1. environment: torch/CUDA/nvcc versions, the card's name and power limit,
   the TF32 settings, and the build of the CUDA kernels from
   ``ahsoka_tpu_torch/csrc`` (timed);
2. each diploid DP kernel against its plain PyTorch version on the card,
   on seeded random DP inputs at config4's DP shape (C=1000, P=56),
   ragged chain counts (C=1, C=37), a config2-length chain (C=1,
   P=10,000) and an all-ties case: backpointers, final costs and states
   must be exactly equal; median times with CUDA events;
3. the golden diploid fixture through the port's ``run_only_bubbles`` and
   ``run_phase`` on the card, byte-equal to ``tests/data``;
4. config4 (chr20 scale: 1000 chains x 50 bubbles, 1M GAF records) end to
   end on the card with the bench settings (no readset debug files,
   coverage cap 64): every chain phased with no failure, both kernels
   launched by the run, paths identical to re-threading the run's DP
   inputs with the plain versions on the CPU, planted-truth switch error
   below 0.01.

Any failure raises and exits non-zero.  The last line is the result:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
before it stand the card's ``nvidia-smi`` name/power-limit line and a
``{"kernels": [...]}`` line with each kernel's launches in the config4
run, its error against the plain version and both times.
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
KERNEL_META = {
    "dp2_forward": ("ahsoka_tpu_torch/csrc/minplus_diploid.cu",
                    "ahsoka_tpu/ops/minplus_diploid.py:56"),
    "dp2_backtrace": ("ahsoka_tpu_torch/csrc/minplus_diploid.cu",
                      "ahsoka_tpu/ops/minplus_diploid.py:188"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    return out.splitlines()[0]


# ---------------------------------------------------------------- phase 1
def phase_environment(dev) -> None:
    import torch

    from ahsoka_tpu_torch.device import fp32_settings
    from ahsoka_tpu_torch.ops import _build

    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True).stdout
    log("nvcc: " + " | ".join(l for l in nvcc.splitlines() if l.strip())[-120:])
    log(f"gpu: {nvidia_smi_line()}")
    log(f"tf32 settings: {json.dumps(fp32_settings())}")
    t0 = time.perf_counter()
    _build.load("minplus_diploid")
    log(f"kernel build: minplus_diploid nvcc "
        f"{_build.build_seconds['minplus_diploid']:.2f} s (load "
        f"{time.perf_counter() - t0:.2f} s)")


# ---------------------------------------------------------------- phase 2
def random_dp_batch(C: int, P: int, seed: int, num_clusters: int = 5):
    """Seeded numpy DP inputs shaped like tests/test_dp.py
    random_dp_inputs, stacked over C chains: candidates [C, P, 4],
    num_candidates [C, P], coverage [C, P, 4], consensus [C, P, 4],
    genotypes [C, P, 2]."""
    import numpy as np

    rng = np.random.default_rng(seed)
    M = 4
    cand = np.full((C, P, M), -1, dtype=np.int32)
    m = rng.integers(1, M + 1, size=(C, P))
    # distinct sorted ids per position: first m of a random permutation
    perm = np.argsort(rng.random((C, P, num_clusters)), axis=2)[:, :, :M]
    perm = np.sort(perm, axis=2).astype(np.int32)
    slot = np.arange(M)[None, None, :]
    cand = np.where(slot < m[:, :, None], perm, -1).astype(np.int32)
    cov = (rng.random((C, P, M)) + 0.05) * (slot < m[:, :, None])
    cov = (cov / cov.sum(axis=2, keepdims=True)).astype(np.float32)
    cons = (rng.integers(0, 2, size=(C, P, M))
            * (slot < m[:, :, None])).astype(np.int32)
    geno = np.zeros((C, P, 2), dtype=np.float32)
    geno[:, :, 0] = geno[:, :, 1] = 1.0
    return cand, m.astype(np.int32), cov, cons, geno


def _node_costs(arrays, dev):
    from ahsoka_tpu.thread.states import (full_state_counts,
                                          full_state_validity)
    from ahsoka_tpu_torch.state import to_torch
    from ahsoka_tpu_torch.thread.dp_torch import node_costs_all

    cand, nc, cov, cons, geno = to_torch(*arrays, device=dev)
    node = node_costs_all(cand, nc, cov, cons, geno, full_state_counts(2),
                          full_state_validity(2), ploidy=2, num_alleles=2,
                          cov_w=1.0, geno_w=1.0).contiguous()
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


def phase_kernels(dev) -> dict:
    """Kernel vs plain on the card, exact equality at every shape."""
    import numpy as np
    import torch

    from ahsoka_tpu_torch.ops.minplus_diploid import (
        backtrace_diploid, backtrace_diploid_ref, minplus_forward_diploid,
        minplus_forward_diploid_ref)

    kw = dict(switch_cost=SWITCH, affine_cost=AFFINE)
    cases = [("config4", 1000, 56, 20), ("ragged1", 1, 56, 5),
             ("ragged37", 37, 56, 5), ("config2_chain", 1, 10000, 3),
             ("all_ties", 300, 24, 5)]
    timing = {}
    err = {"dp2_forward": 0.0, "dp2_backtrace": 0.0}
    for name, C, P, reps in cases:
        arrays = random_dp_batch(C, P, seed=C * 7919 + P)
        if name == "all_ties":
            # every chain and position: the same two candidates and
            # uniform coverage -> many equal-cost paths and states
            cand, nc, cov, cons, geno = arrays
            cand[:] = -1
            cand[:, :, :2] = [0, 1]
            nc[:] = 2
            cov[:] = 0.0
            cov[:, :, :2] = 0.5
            cons[:] = 0
            arrays = (cand, nc, cov, cons, geno)
        cand, node = _node_costs(arrays, dev)
        if name == "all_ties":
            node = torch.where(node < 1e29, torch.zeros_like(node), node)
        fin_k, bp_k = minplus_forward_diploid(cand, node, **kw)
        fin_r, bp_r = minplus_forward_diploid_ref(cand, node, **kw)
        torch.cuda.synchronize()
        fs = torch.argmin(fin_k, dim=1).to(torch.int32)
        st_k = backtrace_diploid(bp_k, fs)
        st_r = backtrace_diploid_ref(bp_k, fs)
        torch.cuda.synchronize()
        same = (torch.equal(fin_k, fin_r) and torch.equal(bp_k, bp_r)
                and torch.equal(st_k, st_r))
        err["dp2_forward"] = max(err["dp2_forward"],
                                 float((fin_k - fin_r).abs().max()),
                                 float((bp_k - bp_r).abs().max()))
        err["dp2_backtrace"] = max(err["dp2_backtrace"],
                                   float((st_k - st_r).abs().max()))
        if name == "config4":
            # the plain version on the CPU agrees too
            fin_c, bp_c = minplus_forward_diploid_ref(cand.cpu(),
                                                      node.cpu(), **kw)
            same = same and torch.equal(fin_c, fin_k.cpu()) \
                and torch.equal(bp_c, bp_k.cpu())
        if name == "all_ties":
            # torch.argmin on the card keeps the first minimum
            tied = fin_k == fin_k.min(dim=1, keepdim=True).values
            first = tied.to(torch.int32).argmax(dim=1).to(torch.int32)
            same = same and torch.equal(fs, first) \
                and bool((tied.sum(dim=1) > 1).any())
        if not same:
            raise AssertionError(f"kernel != plain at {name} (C={C}, P={P})")
        t = {
            "dp2_forward": (_median_ms(lambda: minplus_forward_diploid(
                cand, node, **kw), reps),
                _median_ms(lambda: minplus_forward_diploid_ref(
                    cand, node, **kw), max(1, reps // 4) if P > 1000
                    else reps)),
            "dp2_backtrace": (_median_ms(lambda: backtrace_diploid(
                bp_k, fs), reps),
                _median_ms(lambda: backtrace_diploid_ref(bp_k, fs),
                           max(1, reps // 4) if P > 1000 else reps)),
        }
        timing[name] = t
        log(f"kernel parity {name} C={C} P={P}: exact; "
            + "; ".join(f"{k} {v[0]:.4f} ms vs plain {v[1]:.3f} ms"
                        for k, v in t.items()))
    # int32 scatter-amin on the card (projection's scatter-min by name)
    idx = torch.tensor([0, 2, 0, 1, 2, 2], device=dev)
    src = torch.tensor([5, 7, 3, 9, 2, 8], dtype=torch.int32, device=dev)
    out = torch.full((3,), 2 ** 31 - 1, dtype=torch.int32, device=dev)
    out.scatter_reduce_(0, idx, src, reduce="amin", include_self=True)
    if out.cpu().tolist() != [3, 9, 2]:
        raise AssertionError(f"int32 scatter_reduce amin wrong: {out}")
    log("int32 scatter_reduce_(amin) on the card: ok")
    return {"timing": timing, "err": err}


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


# ---------------------------------------------------------------- phase 4
def phase_e2e(dev, config_name: str) -> dict:
    from ahsoka_tpu_torch import host
    from ahsoka_tpu_torch.device import synchronize
    from ahsoka_tpu_torch.pipeline import run_phase
    from ahsoka_tpu_torch.thread import dp_kernels
    from ahsoka_tpu_torch.thread.dp_torch import thread_chains_batched

    spec = host.CONFIGS[config_name]
    work = os.path.join(WORK, config_name)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    gfa, gaf, truth = (os.path.join(work, f"{config_name}.{x}")
                       for x in ("gfa", "gaf", "truth"))
    t0 = time.perf_counter()
    host.write_synthetic(gfa, gaf, spec, truth_path=truth)
    log(f"{config_name}: {spec.num_chains} chains x "
        f"{spec.bubbles_per_chain} bubbles, {spec.total_reads} GAF "
        f"records generated in {time.perf_counter() - t0:.1f} s")
    cfg = host.PhasingConfig(debug_readset_files=False, max_coverage=64,
                             threads=min(os.cpu_count() or 1, 8))
    outstem = os.path.join(work, "run")

    dp_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    art = run_phase(gfa, gaf, outstem, cfg, device=dev, keep_going=False)
    synchronize(dev)
    wall = time.perf_counter() - t0
    launches = dp_kernels.launch_counts()
    log(f"{config_name} run_phase on the card: {wall:.2f} s; kernel "
        f"launches {json.dumps(launches)}")

    with open(f"{outstem}-metrics.json") as fh:
        m = json.load(fh)
    if m["chains_phased"] != spec.num_chains or m["chains_failed"]:
        raise AssertionError(f"{m['chains_phased']}/{spec.num_chains} "
                             f"chains phased, {m['chains_failed']} failed")

    t0 = time.perf_counter()
    th = art.threading
    cpu_paths = thread_chains_batched(th["dps"], cfg,
                                      chain_configs=th["configs"],
                                      device="cpu")
    if cpu_paths != th["paths"]:
        bad = sum(a != b for a, b in zip(cpu_paths, th["paths"]))
        raise AssertionError(f"{bad} chains thread differently on the "
                             "CPU plain path")
    log(f"re-threaded {len(cpu_paths)} chains with the plain versions on "
        f"the CPU in {time.perf_counter() - t0:.2f} s: paths identical")

    acc = host.score_phased_output(outstem, truth)
    stages = {k: v for k, v in m["stage_seconds"].items()
              if k != "substages"}
    log(f"stage_seconds {json.dumps(stages)}")
    log(f"substages {json.dumps(m['stage_seconds'].get('substages', {}))}")
    log(f"accuracy vs planted truth {json.dumps(acc)}")
    if not acc.get("switch_err_vs_truth", 1.0) < 0.01:
        raise AssertionError(f"switch error {acc} not below 0.01")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 "main path")
    return {"launches": launches, "wall": wall}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="all",
                    help="comma list of env,kernels,golden,e2e for a "
                         "partial run (prints no result line)")
    args = ap.parse_args(argv)
    phases = ({"env", "kernels", "golden", "e2e"} if args.phases == "all"
              else set(args.phases.split(",")))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from ahsoka_tpu_torch.device import resolve_device

    dev = resolve_device("cuda")
    phase_environment(dev)
    kern = phase_kernels(dev) if "kernels" in phases else None
    if "golden" in phases:
        phase_golden(dev)
    e2e = phase_e2e(dev, "config4") if "e2e" in phases else None
    if kern is None or e2e is None or "golden" not in phases:
        log("partial run: no result line")
        return 0

    from ahsoka_tpu_torch.host import loaded_jax_modules
    jax_mods = loaded_jax_modules(sys.modules)
    if jax_mods:
        raise AssertionError(f"jax or a jax module was imported: "
                             f"{jax_mods[:5]}")

    t4 = kern["timing"]["config4"]
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": rep, "launches": e2e["launches"][name],
                "max_abs_err": kern["err"][name], "ms": t4[name][0],
                "plain_ms": t4[name][1]}
               for name, (src, rep) in KERNEL_META.items()]
    log(nvidia_smi_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
