"""Pipeline orchestration of the port (counterpart of ahsoka_tpu/pipeline.py).

    parse GFA -> find bubbles -> [only-bubbles: write -bubbleinfo.txt, stop]
              -> parse GAF -> enumerate allele paths -> phasing
              -> result files + -metrics.json

Parsing, bubbles, allele paths and the bubbleinfo/identities side files
are host stages (this package's copies of the JAX package's, byte-equal
in output).  Phasing runs ``ahsoka_tpu_torch.phase.phase_all_chains_batched``
on a torch device (and, in the sharded layouts, a list of them), or
``phase_all_chains`` chain by chain for ``batch_dp=False`` and for the
host backend (``backend="host"``, the numpy oracle).  In the
chain layout over several processes (``process_chain_sharding``) rank 0
alone writes the shared side files, and every other rank its metrics as
``-metrics.rank<r>.json``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Tuple

import torch

from ahsoka_tpu_torch.config import PhasingConfig
from ahsoka_tpu_torch.device import resolve_device
from ahsoka_tpu_torch.dist.mesh import local_devices, own_card, world
from ahsoka_tpu_torch.emit.bubbleinfo import write_bubbleinfo_file
from ahsoka_tpu_torch.graph.alleles import (AllelePathTable,
                                            enumerate_allele_paths)
from ahsoka_tpu_torch.graph.bubbles import find_bubbles
from ahsoka_tpu_torch.graph.structures import BubbleIndex
from ahsoka_tpu_torch.io.gaf import (AlignmentTable, identities_sidefile_path,
                                     read_gaf)
from ahsoka_tpu_torch.io.gfa import GfaGraph, parse_gfa
from ahsoka_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


@dataclasses.dataclass
class PipelineArtifacts:
    graph: GfaGraph
    index: BubbleIndex
    alignments: Optional[AlignmentTable] = None
    allele_paths: Optional[AllelePathTable] = None
    size_sorting: Optional[List[Tuple[int, int]]] = None
    stage_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)
    # columnar alignment tables (the device pipeline's fast path; object
    # tables above remain the oracle, and the input of debug readset files)
    gaf_columns: Optional[object] = None
    chain_buckets: Optional[Dict[int, object]] = None

    def chain_alignment_count(self, chain_id: int) -> int:
        if self.chain_buckets is not None:
            b = self.chain_buckets.get(chain_id)
            return 0 if b is None else len(b.record_idx)
        return len(self.alignments.chain_alignments(chain_id))


def load_graph_and_bubbles(gfa_path: str, config: PhasingConfig,
                           artifacts: Optional[PipelineArtifacts] = None
                           ) -> PipelineArtifacts:
    t0 = time.perf_counter()
    graph = parse_gfa(gfa_path)
    t1 = time.perf_counter()
    log.info("Step 1: Graph with %d nodes read", graph.num_nodes())
    index = find_bubbles(graph,
                         compat_std_ordering=config.compat_std_ordering)
    t2 = time.perf_counter()
    log.info("Step 2: Bubbles read; number of bubble chains: %d",
             len(index.chains))
    art = PipelineArtifacts(graph=graph, index=index)
    art.stage_seconds["parse_gfa"] = t1 - t0
    art.stage_seconds["find_bubbles"] = t2 - t1
    return art


def run_only_bubbles(gfa_path: str, outstem: str,
                     config: PhasingConfig = PhasingConfig()) -> str:
    """The ``only-bubbles`` subcommand (src/polyassembly.cpp:112-114)."""
    art = load_graph_and_bubbles(gfa_path, config)
    return write_bubbleinfo_file(art.index, outstem)


def _secondary_process(config: PhasingConfig) -> bool:
    """True on the ranks above 0 of a chain-sharded multi-process run
    (``ahsoka_tpu/pipeline.py:77-98``): the shared side files
    (bubbleinfo, identities, the aggregate) are written by rank 0 alone,
    since identical concurrent writers would race on the shared
    filesystem."""
    if not getattr(config, "process_chain_sharding", False):
        return False
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        # a library caller that skipped the CLI's initialize_distributed:
        # this process cannot see its siblings, so the rank-0-only side
        # files cannot engage; say so rather than race silently
        log.warning(
            "process_chain_sharding is set but no torch.distributed "
            "process group was initialized; treating this as a single-"
            "process run (rank-0-only side-file writing inactive). Call "
            "ahsoka_tpu_torch.dist.mesh.initialize_distributed (or use the "
            "CLI's --coordinator/--num-processes flags) before run_phase "
            "for multi-process layouts.")
        return False
    nproc, rank = world()
    return nproc > 1 and rank > 0


def prepare_phase_inputs(gfa_path: str, gaf_path: str, outstem: str,
                         config: PhasingConfig,
                         columnar: bool = False) -> PipelineArtifacts:
    """Stages 1-4: graph, bubbles, alignments, allele paths, chain order.

    ``columnar=True`` parses the GAF into flat column arrays (native
    parser) and buckets by chain with vectorised numpy — no per-record
    objects; run_phase uses it unless readset debug files are asked for."""
    art = load_graph_and_bubbles(gfa_path, config)
    secondary = _secondary_process(config)
    if not secondary:
        write_bubbleinfo_file(art.index, outstem)

    t0 = time.perf_counter()
    if columnar:
        from ahsoka_tpu_torch.io._native_io import parse_gaf_native
        from ahsoka_tpu_torch.io.columns import (bucket_by_chain,
                                           columns_from_native)

        raw = parse_gaf_native(gaf_path)
        cols = columns_from_native(raw) if raw is not None else None
        if cols is not None:
            art.gaf_columns = cols
            art.chain_buckets = bucket_by_chain(
                cols, art.index,
                compat_duplicate_bucketing=
                config.compat_duplicate_bucketing)
            art.alignments = AlignmentTable(num_records=cols.num_records)
            # identities side file from the same raw native arrays
            if not secondary:
                _write_identities_from_native(gaf_path, raw=raw)
        else:
            log.warning("native GAF parser unavailable; falling back to "
                        "the object parser")
            columnar = False
    if not columnar:
        with open(identities_sidefile_path(gaf_path) if not secondary
                  else os.devnull, "w") as idf:
            art.alignments = read_gaf(
                gaf_path, art.index, identities_out=idf,
                compat_duplicate_bucketing=
                config.compat_duplicate_bucketing)
    t1 = time.perf_counter()
    n_buckets = (sum(len(b.record_idx)
                     for b in art.chain_buckets.values())
                 if art.chain_buckets is not None else
                 sum(len(v) for v in art.alignments.by_chain.values()))
    log.info("Step 3: Alignments read; number of alignment buckets: %d",
             n_buckets)

    art.allele_paths = enumerate_allele_paths(art.graph, art.index)
    t2 = time.perf_counter()
    log.info("Step 4: Chain paths computed; number of chain paths: %d",
             len(art.allele_paths))

    # process largest chains first; ties broken by larger chain id — the
    # deterministic order produced by sorting (size, chain_id) pairs
    # descending (src/polyassembly.cpp:136-140)
    art.size_sorting = sorted(
        ((len(bubbles), chain_id)
         for chain_id, bubbles in art.allele_paths.items()),
        reverse=True)
    art.stage_seconds["parse_gaf"] = t1 - t0
    art.stage_seconds["allele_paths"] = t2 - t1
    return art


def _write_identities_from_native(gaf_path: str, raw=None) -> None:
    """Identities side file (src/alignmentreader.cpp:73-75,151-156) from
    the native parser's flat arrays.  Vectorised: segment names are
    comma-joined once in a single numpy pass (the naive per-record loop
    cost ~40s on a 1M-record GAF), then each line is cheap byte slicing.
    """
    import numpy as np

    from ahsoka_tpu_torch.io._native_io import parse_gaf_native

    cols = raw if raw is not None else parse_gaf_native(gaf_path)
    if cols is None:
        return
    nb, no = bytes(cols["name_bytes"]), cols["name_offsets"]
    sb, so = cols["seg_bytes"], np.asarray(cols["seg_offsets"],
                                           dtype=np.int64)
    bb, bo = bytes(cols["blocklen_bytes"]), cols["blocklen_offsets"]
    po = cols["path_offsets"]
    idents = cols["identities"]
    n_segs = len(so) - 1
    # one pass: seg blob with a ',' appended after every segment, so a
    # record's "s1,s2,...," field is a single slice
    joined = np.empty(len(sb) + n_segs, dtype=np.uint8)
    new_off = so + np.arange(len(so), dtype=np.int64)  # +1 comma per seg
    comma_pos = new_off[1:] - 1
    mask = np.ones(len(joined), dtype=bool)
    mask[comma_pos] = False
    joined[mask] = np.frombuffer(sb, dtype=np.uint8)
    joined[comma_pos] = ord(",")
    joined_b = joined.tobytes()
    ident_str = np.char.mod("%g", np.asarray(idents))
    with open(identities_sidefile_path(gaf_path), "wb") as fh:
        write = fh.write
        for r in range(cols["num_records"]):
            write(nb[no[r]:no[r + 1]])
            write(b"\t")
            write(ident_str[r].encode())
            write(b"\t")
            # slice spans segments po[r]..po[r+1], trailing comma included
            # (reference field format)
            write(joined_b[new_off[po[r]]:new_off[po[r + 1]]])
            write(b"\t")
            write(bb[bo[r]:bo[r + 1]])
            write(b"\n")



def run_phase(gfa_path: str, gaf_path: str, outstem: str,
              config: PhasingConfig = PhasingConfig(), device="cuda",
              resume: bool = False, keep_going: bool = False,
              profile_dir: Optional[str] = None,
              columnar: Optional[bool] = None,
              devices=None) -> PipelineArtifacts:
    """The full ``phase`` subcommand on ``device`` (default ``cuda``;
    raises when no card is available).  ``devices`` is this process's
    device list for ``data_shards`` / ``chain_shards`` (default: every
    card for CUDA, or this rank's own card in a process group of more
    than one rank, ``device`` alone for the CPU; it may repeat a device).
    ``config.backend="host"`` or ``config.batch_dp=False`` phase chain by
    chain (``phase.phase_all_chains``); the host backend reads the GAF
    into alignment objects (``columnar`` defaults to False for it).
    ``profile_dir`` writes a torch.profiler trace of the phasing stage
    (Chrome trace JSON)."""
    from ahsoka_tpu_torch.utils.malloc_tune import retain_freed_heap
    from ahsoka_tpu_torch.phase import (check_layout, device_warmup,
                                        phase_all_chains,
                                        phase_all_chains_batched)

    # the device resolves first on either backend: a bare run without a
    # card raises, although the host backend then touches no device
    dev = resolve_device(own_card(device))
    devs = [resolve_device(d) for d in local_devices(devices, dev)]
    backend = config.backend
    # validate before the (possibly minutes-long) input parse
    if backend not in ("jax", "host"):
        raise ValueError(f"unknown backend {backend!r} (jax or host)")
    if config.process_chain_sharding and not (backend == "jax"
                                              and config.batch_dp):
        raise ValueError("process_chain_sharding requires the batched "
                         "device pipeline (backend='jax', batch_dp=True)")
    check_layout(config)
    retain_freed_heap()
    if columnar is None:
        # the host readsets are built from alignment objects
        columnar = backend == "jax" and not config.debug_readset_files
    art = prepare_phase_inputs(gfa_path, gaf_path, outstem, config,
                               columnar=columnar)
    if backend == "jax":
        # the context and first round trip, outside the phase timer, on
        # either device-backend driver
        device_warmup(art.stage_seconds, dev)
    t0 = time.perf_counter()
    prof = None
    if profile_dir:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    try:
        if backend == "jax" and config.batch_dp:
            results = phase_all_chains_batched(art, outstem, config,
                                               resume=resume,
                                               keep_going=keep_going,
                                               device=dev, devices=devs)
        else:
            results = phase_all_chains(art, outstem, config,
                                       backend=backend, resume=resume,
                                       keep_going=keep_going, device=dev,
                                       devices=devs)
    finally:
        if prof is not None:
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
    plus the device it ran on: the card's name, or ``cpu`` for the CPU and
    for the host backend.  ``stage_seconds`` holds ``device_warmup`` and
    ``device_rtt_est`` on the device backend, taken before the phase
    timer, so the rates exclude them."""
    host = config.backend == "host"
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
        "backend": "host" if host else "torch",
        "device": (torch.cuda.get_device_name(dev)
                   if dev.type == "cuda" and not host else "cpu"),
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
    path = f"{outstem}-metrics.json"
    if _secondary_process(config):
        # chain-sharded multi-process: each rank reports its own share;
        # rank 0 keeps the canonical file name
        nproc, rank = world()
        path = f"{outstem}-metrics.rank{rank}.json"
        metrics["process_index"] = rank
        metrics["process_count"] = nproc
    with open(path, "w") as fh:
        json.dump(metrics, fh, indent=1)
