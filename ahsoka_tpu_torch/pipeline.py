"""Pipeline orchestration of the port (counterpart of ahsoka_tpu/pipeline.py).

    parse GFA -> find bubbles -> [only-bubbles: write -bubbleinfo.txt, stop]
              -> parse GAF -> enumerate allele paths -> batched phasing
              -> result files + -metrics.json

Parsing, bubbles, allele paths and the bubbleinfo/identities side files
are the JAX package's host stages, shared by import (they never touch
jax).  Phasing runs ``ahsoka_tpu_torch.phase.phase_all_chains_batched``
on a torch device.
"""

from __future__ import annotations

import json
import time
from typing import Optional

import torch

from ahsoka_tpu.config import PhasingConfig
from ahsoka_tpu.pipeline import (PipelineArtifacts, load_graph_and_bubbles,
                                 prepare_phase_inputs, run_only_bubbles)
from ahsoka_tpu.utils.logging import get_logger
from ahsoka_tpu_torch.device import resolve_device

log = get_logger(__name__)

__all__ = ["PipelineArtifacts", "load_graph_and_bubbles",
           "prepare_phase_inputs", "run_only_bubbles", "run_phase"]


def run_phase(gfa_path: str, gaf_path: str, outstem: str,
              config: PhasingConfig = PhasingConfig(), device="cuda",
              resume: bool = False, keep_going: bool = False,
              profile_dir: Optional[str] = None,
              columnar: Optional[bool] = None) -> PipelineArtifacts:
    """The full ``phase`` subcommand on ``device`` (default ``cuda``;
    raises when no card is available).  ``profile_dir`` writes a
    torch.profiler trace of the phasing stage (Chrome trace JSON)."""
    from ahsoka_tpu.utils.malloc_tune import retain_freed_heap
    from ahsoka_tpu_torch.phase import (check_supported,
                                        phase_all_chains_batched)

    dev = resolve_device(device)
    # validate before the (possibly minutes-long) input parse
    if config.backend != "jax":
        raise NotImplementedError(
            f"backend={config.backend!r}: the port runs the device "
            "pipeline only; the host oracle is ahsoka_tpu's "
            "backend='host'")
    if not config.batch_dp:
        raise NotImplementedError(
            "batch_dp=False (the per-chain sequential driver) is not "
            "ported; the batched driver gives the same outputs")
    check_supported(config)
    retain_freed_heap()
    if columnar is None:
        columnar = not config.debug_readset_files
    art = prepare_phase_inputs(gfa_path, gaf_path, outstem, config,
                               columnar=columnar)
    t0 = time.perf_counter()
    prof = None
    if profile_dir:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    try:
        results = phase_all_chains_batched(art, outstem, config,
                                           resume=resume,
                                           keep_going=keep_going,
                                           device=dev)
    finally:
        if prof is not None:
            import os
            prof.__exit__(None, None, None)
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(profile_dir,
                                                  "trace.json"))
    art.stage_seconds["phase"] = time.perf_counter() - t0
    log.info("Step 5: Phasing processed")
    _write_metrics(outstem, art, results, config, dev)
    return art


def _write_metrics(outstem: str, art: PipelineArtifacts, results,
                   config: PhasingConfig, dev: torch.device) -> None:
    """``-metrics.json`` in the JAX package's schema (metrics_version 3),
    plus the torch device it ran on."""
    phase_s = art.stage_seconds.get("phase", 0.0) or 1e-9
    e2e_s = phase_s + art.stage_seconds.get("parse_gaf", 0.0)
    total_reads = sum(r.num_reads for r in results)
    total_cells = sum(r.dp_cells for r in results)
    num_records = art.alignments.num_records if art.alignments else 0
    dp_window = art.stage_seconds.get("dp_device_window")
    metrics = {
        "metrics_version": 3,
        "rate_excludes_device_warmup": True,
        "stage_seconds": art.stage_seconds,
        "ploidy": config.ploidy,
        "backend": "torch",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "num_chains": len(results),
        "chains_phased": sum(1 for r in results if not r.skipped),
        "chains_skipped": sum(1 for r in results if r.skipped),
        "chains_failed": sum(1 for r in results if r.error),
        "gaf_records": num_records,
        "total_filtered_reads": total_reads,
        "total_dp_cells": total_cells,
        "reads_per_s": num_records / e2e_s,
        "reads_per_s_phase_only": num_records / phase_s,
        "dp_cells_per_s_e2e": total_cells / phase_s,
        "dp_cells_per_s_device_window": (
            total_cells / dp_window if dp_window else None),
        "chains": [
            {"chain_id": r.chain_id, "bubbles": r.num_bubbles,
             "reads": r.num_reads, "clusters": r.num_clusters,
             "positions": r.num_positions, "seconds": round(r.seconds, 4),
             "stage_seconds": {k: round(v, 4)
                               for k, v in r.stage_seconds.items()},
             "skipped": r.skipped, "reason": r.reason, "error": r.error,
             "resumed": r.resumed}
            for r in results],
    }
    with open(f"{outstem}-metrics.json", "w") as fh:
        json.dump(metrics, fh, indent=1)
