"""Multi-process runs of the port's phase pipeline, compared byte for byte
with one process (the port's counterpart of ``scripts/multiproc_sim.py``).

    python -m ahsoka_tpu_torch.dist.sim [--nproc 2] [--device cuda|cpu]
    python -m ahsoka_tpu_torch.dist.sim --mode chains --sweep 1 2 [4] \
        [--shape small|config5s] [--threads N]

``--mode mesh`` (default): an 8-device layout, ``data_shards =
chain_shards = 8``.  One process over 8 local devices writes the golden
outputs; then ``--nproc`` processes of ``8 / nproc`` local devices each
form a torch.distributed group (gloo on the CPU, NCCL on CUDA, where
rank r takes card r) and run the sharded projection, scoring and DP over
the global mesh with real cross-process collectives.  Every process
writes complete outputs, each compared with the golden.  The device is
``cuda`` unless ``--device cpu`` is given; with fewer visible cards than
``--nproc`` the mesh mode on ``cuda`` raises before it starts a child.

``--mode chains``: ``--process-sharding chains`` at each process count
of ``--sweep``; the chains go round-robin over the ranks (gloo, barriers
only, so the ranks may share one card), every owner writes its chain
files into one shared output stem and rank 0 merges the aggregate.  The
merged outputs of each count are compared with the first count's.
``--shape config5s`` is the whole-genome mixed-ploidy shape at 1/10
scale (``utils/synth.py``), with a ploidy map from its planted truth and
beam width 2048.

Each rank reports its phase seconds, chains owned and failed, the DP
kernels' launches, its ``clustering.solver`` thread-seconds and its peak
device memory.  The last line of the output is a JSON summary with
``byte_equal``, ``nproc``, ``files_compared`` and per-rank
``chains_owned`` and ``chains_failed``.  CPU children run torch on one
thread.  Every child has a time limit (``--timeout``); on a failure or a
timeout every child is killed.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import time
from typing import List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MESH_DEVICES = 8                   # global device count of the mesh layout
BEAM_WIDTH = 2048


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_child(args) -> int:
    import torch

    from ahsoka_tpu_torch.config import PhasingConfig
    from ahsoka_tpu_torch.dist.mesh import (group_backend,
                                            initialize_distributed)
    from ahsoka_tpu_torch.pipeline import run_phase
    from ahsoka_tpu_torch.thread import dp_kernels
    from ahsoka_tpu_torch.thread.dp_beam import thread_beam

    chains = args.mode == "chains"
    device = args.device
    if device == "cpu":
        torch.set_num_threads(1)
    elif not chains and args.nproc > 1:
        device = f"cuda:{args.pid % torch.cuda.device_count()}"
    if args.nproc > 1:
        initialize_distributed(coordinator=f"localhost:{args.port}",
                               num_processes=args.nproc,
                               process_id=args.pid,
                               backend=group_backend(device, chains))
    pmap = None
    if args.ploidy_map:
        with open(args.ploidy_map) as fh:
            pmap = {int(c): int(k) for c, k in json.load(fh).items()}
    max_k = max([2] + list((pmap or {}).values()))
    common = dict(debug_readset_files=False, threads=args.threads)
    if chains:
        cfg = PhasingConfig(process_chain_sharding=True, max_coverage=64,
                            ploidy_map=pmap,
                            dp_beam_width=(BEAM_WIDTH if max_k >= 6 else 0),
                            genotype_prior=("balanced" if max_k > 2
                                            else "reference"), **common)
        devices = None
    else:
        cfg = PhasingConfig(data_shards=MESH_DEVICES,
                            chain_shards=MESH_DEVICES, **common)
        devices = [device] * args.local_devices
    dp_kernels.reset_launch_counts()
    thread_beam.launches = 0
    if device.startswith("cuda"):
        torch.cuda.reset_peak_memory_stats()
    run_phase(args.gfa, args.gaf, args.outstem, cfg, device=device,
              devices=devices)
    report = {"launches": dict(dp_kernels.launch_counts(),
                               beam=thread_beam.launches),
              "peak_device_bytes": (torch.cuda.max_memory_allocated()
                                    if device.startswith("cuda") else None)}
    with open(f"{args.outstem}-sim.rank{args.pid}.json", "w") as fh:
        json.dump(report, fh)
    if args.nproc > 1:
        torch.distributed.destroy_process_group()
    return 0


def _spawn(pid: int, nproc: int, port: int, gfa: str, gaf: str,
           outstem: str, mode: str, local_devices: int, device: str,
           threads: int, ploidy_map: Optional[str] = None
           ) -> subprocess.Popen:
    cmd = [sys.executable, "-m", "ahsoka_tpu_torch.dist.sim", "--child",
           "--pid", str(pid), "--nproc", str(nproc), "--port", str(port),
           "--local-devices", str(local_devices), "--mode", mode,
           "--device", device, "--threads", str(threads), "--gfa", gfa,
           "--gaf", gaf, "--outstem", outstem]
    if ploidy_map:
        cmd += ["--ploidy-map", ploidy_map]
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def run_group(specs: List[dict], nproc: int, timeout: float) -> float:
    """Spawn one child per spec (``_spawn`` keywords but pid/nproc/port),
    wait for all; raise with the failed child's stderr, killing the rest.
    Returns the group's wall seconds."""
    port = free_port()
    t0 = time.perf_counter()
    procs = [_spawn(pid, nproc, port, **spec)
             for pid, spec in enumerate(specs)]
    try:
        deadline = time.perf_counter() + timeout
        for pid, p in enumerate(procs):
            _out, err = p.communicate(
                timeout=max(1.0, deadline - time.perf_counter()))
            if p.returncode != 0:
                raise RuntimeError(f"rank {pid} of {nproc} failed "
                                   f"(rc {p.returncode}):\n{err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return time.perf_counter() - t0


def output_names(stem: str) -> List[str]:
    """Suffixes of a run's result files: the aggregate, the bubbleinfo
    and every chain file."""
    d, base = os.path.split(stem)
    chain = sorted(f[len(base):] for f in os.listdir(d)
                   if f.startswith(base + "-chain")
                   and f.endswith("-result.txt"))
    return ["-result.txt", "-bubbleinfo.txt"] + chain


def compare_outputs(golden: str, stem: str) -> List[tuple]:
    """(suffix, "missing" | "differs") of every result file of
    ``golden`` that ``stem`` lacks or writes differently."""
    bad = []
    for suffix in output_names(golden):
        cand = stem + suffix
        if not os.path.exists(cand):
            bad.append((suffix, "missing"))
            continue
        with open(golden + suffix, "rb") as a, open(cand, "rb") as b:
            if a.read() != b.read():
                bad.append((suffix, "differs"))
    return bad


def rank_report(outstem: str, rank: int, shared_stem: bool = True) -> dict:
    """A rank's numbers from its metrics and child report.  In the chain
    layout the ranks share one stem (rank r > 0 writes
    -metrics.rank<r>.json); in the mesh layout each has its own."""
    path = (f"{outstem}-metrics.rank{rank}.json" if shared_stem and rank
            else f"{outstem}-metrics.json")
    with open(path) as fh:
        m = json.load(fh)
    with open(f"{outstem}-sim.rank{rank}.json") as fh:
        sim = json.load(fh)
    stages = m["stage_seconds"]
    return {"rank": rank, "phase_s": stages["phase"],
            "parse_gaf_s": stages["parse_gaf"],
            "dp_device_window_s": stages.get("dp_device_window"),
            "clustering_solver_thread_s": stages.get(
                "substages", {}).get("clustering.solver"),
            "chains_owned": sum(1 for c in m["chains"]
                                if c.get("reason")
                                != "owned by another process"),
            "chains_failed": m["chains_failed"],
            "launches": sim["launches"],
            "peak_device_bytes": sim["peak_device_bytes"]}


def shaped_inputs(workdir: str, shape: str):
    """(gfa, gaf, truth, ploidy-map path or None) of a chains-mode shape,
    generated once into ``workdir``."""
    from ahsoka_tpu_torch.utils.synth import CONFIGS, SynthSpec, \
        write_synthetic

    spec = (CONFIGS["config5s"] if shape == "config5s" else
            SynthSpec(num_chains=12, bubbles_per_chain=20, reads_per_hap=50,
                      span=3, error_rate=0.02, seed=7))
    gfa, gaf, truth = (os.path.join(workdir, f"{shape}.{x}")
                       for x in ("gfa", "gaf", "truth"))
    if not all(os.path.exists(p) for p in (gfa, gaf, truth)):
        write_synthetic(gfa, gaf, spec, truth_path=truth)
    if shape != "config5s":
        return gfa, gaf, truth, None
    pmap_path = os.path.join(workdir, f"{shape}.pmap.json")
    if not os.path.exists(pmap_path):
        write_ploidy_map(gfa, truth, pmap_path)
    return gfa, gaf, truth, pmap_path


def write_ploidy_map(gfa: str, truth: str, path: str) -> dict:
    """The planted truth's per-chain ploidies as a --ploidy-map JSON."""
    from ahsoka_tpu_torch.config import PhasingConfig
    from ahsoka_tpu_torch.graph.alleles import enumerate_allele_paths
    from ahsoka_tpu_torch.pipeline import load_graph_and_bubbles
    from ahsoka_tpu_torch.utils.accuracy import ploidy_map_from_truth

    art = load_graph_and_bubbles(gfa, PhasingConfig())
    pmap = ploidy_map_from_truth(
        enumerate_allele_paths(art.graph, art.index), truth)
    with open(path, "w") as fh:
        json.dump({str(c): int(k) for c, k in pmap.items()}, fh)
    return pmap


def run_chains(gfa: str, gaf: str, outdir: str, nproc: int, device: str,
               threads: int, ploidy_map: Optional[str] = None,
               timeout: float = 1800.0) -> dict:
    """One chains-mode run at ``nproc`` processes into ``outdir``/run:
    its wall seconds and every rank's report."""
    shutil.rmtree(outdir, ignore_errors=True)
    os.makedirs(outdir)
    outstem = os.path.join(outdir, "run")
    wall = run_group([dict(gfa=gfa, gaf=gaf, outstem=outstem, mode="chains",
                           local_devices=1, device=device, threads=threads,
                           ploidy_map=ploidy_map)] * nproc, nproc, timeout)
    return {"nproc": nproc, "wall_s": wall, "outstem": outstem,
            "per_rank": [rank_report(outstem, r) for r in range(nproc)]}


def run_chains_sweep(args) -> int:
    from ahsoka_tpu_torch.utils.accuracy import score_phased_output

    os.makedirs(args.workdir, exist_ok=True)
    gfa, gaf, truth, pmap = shaped_inputs(args.workdir, args.shape)
    golden = None
    rows = []
    for nproc in args.sweep:
        row = run_chains(gfa, gaf, os.path.join(args.workdir, f"np{nproc}"),
                         nproc, args.device, args.threads, pmap,
                         args.timeout)
        outstem = row.pop("outstem")
        if golden is None:
            golden = outstem
        mismatches = compare_outputs(golden, outstem)
        row.update(byte_equal=not mismatches, mismatches=mismatches[:5],
                   files_compared=len(output_names(golden)),
                   max_phase_s=max(r["phase_s"] for r in row["per_rank"]),
                   accuracy=score_phased_output(outstem, truth))
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"mode": "chains", "shape": args.shape,
                      "nproc": max(args.sweep),
                      "byte_equal": all(r["byte_equal"] for r in rows),
                      "files_compared": sum(r["files_compared"]
                                            for r in rows),
                      "sweep": rows}))
    return 0 if all(r["byte_equal"] for r in rows) else 1


def run_mesh(args) -> int:
    from ahsoka_tpu_torch.utils.synth import SynthSpec, write_synthetic

    workdir = args.workdir
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    gfa, gaf = os.path.join(workdir, "g.gfa"), os.path.join(workdir, "r.gaf")
    write_synthetic(gfa, gaf, SynthSpec(num_chains=4, bubbles_per_chain=8,
                                        reads_per_hap=12, span=3,
                                        error_rate=0.05, seed=11))
    # one GAF copy per process: each writes the identities file beside it
    gafs = []
    for tag in ["single"] + [f"proc{i}" for i in range(args.nproc)]:
        path = os.path.join(workdir, f"r_{tag}.gaf")
        shutil.copy(gaf, path)
        gafs.append(path)
    common = dict(gfa=gfa, mode="mesh", device=args.device,
                  threads=args.threads)
    single = os.path.join(workdir, "single")
    t_single = run_group([dict(common, gaf=gafs[0], outstem=single,
                               local_devices=MESH_DEVICES)], 1,
                         args.timeout)
    stems = [os.path.join(workdir, f"proc{i}") for i in range(args.nproc)]
    t_multi = run_group([dict(common, gaf=gafs[1 + i], outstem=stems[i],
                              local_devices=MESH_DEVICES // args.nproc)
                         for i in range(args.nproc)], args.nproc,
                        args.timeout)
    mismatches = [(suffix, i) for i, stem in enumerate(stems)
                  for suffix, _why in compare_outputs(single, stem)]
    per_rank = [rank_report(stem, i, shared_stem=False)
                for i, stem in enumerate(stems)]
    summary = {
        "mode": "mesh", "nproc": args.nproc,
        "global_devices": MESH_DEVICES,
        "files_compared": len(output_names(single)) * args.nproc,
        "byte_equal": not mismatches, "mismatches": mismatches,
        "single": rank_report(single, 0), "per_rank": per_rank,
        "wall_seconds": {"single": t_single, "multi": t_multi}}
    print(json.dumps(summary))
    return 0 if not mismatches else 1


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--pid", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--local-devices", type=int, default=MESH_DEVICES,
                    help=argparse.SUPPRESS)
    ap.add_argument("--gfa", help=argparse.SUPPRESS)
    ap.add_argument("--gaf", help=argparse.SUPPRESS)
    ap.add_argument("--outstem", help=argparse.SUPPRESS)
    ap.add_argument("--ploidy-map", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--mode", choices=["mesh", "chains"], default="mesh")
    ap.add_argument("--nproc", type=int, default=2,
                    help="mesh mode: processes sharing the 8-device mesh")
    ap.add_argument("--sweep", type=int, nargs="+", default=None,
                    help="chains mode: process counts (default 1 2)")
    ap.add_argument("--shape", choices=["small", "config5s"],
                    default="small")
    ap.add_argument("--device", choices=["cpu", "cuda"], default="cuda",
                    help="cuda (default: the mesh layout takes one card a "
                         "process) or cpu")
    ap.add_argument("--threads", type=int, default=1,
                    help="host worker threads of each process")
    ap.add_argument("--timeout", type=float, default=1800.0,
                    help="seconds a group of processes may take")
    ap.add_argument("--workdir",
                    default=os.path.join(REPO, "build", "dist_sim"))
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.child:
        return run_child(args)
    if args.mode == "chains":
        args.sweep = args.sweep or [1, 2]
        return run_chains_sweep(args)
    if MESH_DEVICES % args.nproc:
        ap.error(f"--nproc must divide {MESH_DEVICES}")
    if args.device == "cuda":
        import torch

        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < args.nproc:
            # NCCL takes one card a rank; never drop to the CPU
            raise RuntimeError(
                f"mesh mode on cuda needs a card for each of --nproc "
                f"{args.nproc} processes, and {cards} are visible; pass "
                "--device cpu to run the layout on the CPU")
    return run_mesh(args)


if __name__ == "__main__":
    sys.exit(main())
