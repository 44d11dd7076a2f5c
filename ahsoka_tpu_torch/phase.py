"""Phasing drivers of the port: projection -> matrix -> scoring -> cluster
editing -> threading DP -> emission, chain by chain or batched across
chains.

Counterpart of ``ahsoka_tpu/phase.py``.  Chains are processed largest
first; the aggregate ``-result.txt`` gets a ``chain id`` / ``size of
chain`` header for every chain, skipped ones included.

- ``phase_all_chains_batched`` (the default, ``batch_dp=True``): pass 1
  runs the batched projection pre-pass and builds every chain's allele
  matrix; pass 2 scores the dense chains in batched device calls and runs
  cluster editing; pass 3 threads all chains in batched DP calls and
  emits in the reference's size-sorted order.
- ``phase_all_chains`` (``batch_dp=False``, and ``backend="host"``):
  ``phase_one_chain`` runs each chain through every stage before the
  next starts.  On the device backend each chain's DP is one forward and
  one backtrace launch (``thread_chain_device``); the host backend is the
  exact numpy oracle (host readsets, ``score_pairs``, cluster editing,
  ``build_dp_inputs``, ``dp_host``) and touches no device.

The drivers write the same outputs as the JAX package's.  Device
failures propagate: unlike the JAX package, no stage falls back from the
device to another path.  ``keep_going`` keeps its documented behaviour
(per-chain failures are recorded and the run continues; a failed
batched DP is retried chain by chain, and logged).

Sharded layouts: ``devices`` (this process's torch devices) carries the
mesh to the stages, whose device-count gates decide whether
``data_shards`` / ``chain_shards`` shard them (``dist/``).  Every
collective runs on the calling thread, in the same order on every
rank: a data-sharded run projects every chain in the pre-pass, and the
dense chains score in the batched slices, so the ``--threads`` workers
call none.  ``process_chain_sharding`` splits the chains round-robin
over the ranks of a process group; each rank writes its chains' files and
rank 0 merges the aggregate result between two barriers.

Chains above ``banded_scoring_threshold`` effective reads take banded
scoring (``score/banded.py``) and the native sparse cluster editing.
The native helpers (cluster editing, coverage cap) are built (g++, at
first use, under a file lock) and loaded once on the calling thread
before the worker pool starts; a failed build raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, List, Optional, Tuple

import torch

from ahsoka_tpu_torch.cluster.editing import cluster_editing
from ahsoka_tpu_torch.cluster.postprocess import (build_dp_inputs,
                                                  consensus_lookup)
from ahsoka_tpu_torch.config import PhasingConfig
from ahsoka_tpu_torch.dist.mesh import barrier, world
from ahsoka_tpu_torch.emit.result import emit_chain_result
from ahsoka_tpu_torch.project.readset import (ChainReadsets,
                                              build_chain_readsets)
from ahsoka_tpu_torch.score.pairwise import readset_to_matrix, score_pairs
from ahsoka_tpu_torch.thread.dp_host import assign_rows, thread_chain
from ahsoka_tpu_torch.utils import substage
from ahsoka_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def device_warmup(stage_seconds: Dict[str, float], device) -> None:
    """Create the device's context and make one trivial round trip before
    the phase timer starts (``ahsoka_tpu/phase.py:36-64``), so the first
    device stage is not charged for them.  Records the elapsed time under
    ``device_warmup`` (also when it fails).  A failure raises: the port
    has no fallback."""
    sp = None
    try:
        with substage.span("device_warmup") as sp:
            substage.count("device.round_trips")
            torch.zeros(8, device=device).sum().item()
    finally:
        stage_seconds["device_warmup"] = sp.wall


@dataclasses.dataclass
class ChainPhasingResult:
    chain_id: int
    num_bubbles: int
    skipped: bool
    reason: str = ""
    num_reads: int = 0
    num_clusters: int = 0
    num_positions: int = 0
    haplotype_alleles: Optional[List[List[int]]] = None
    seconds: float = 0.0
    dp_cells: int = 0
    error: str = ""
    resumed: bool = False
    stage_seconds: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    # per-chain driver: (DPInputs, chain config, DP path before the rows
    # are assigned), gathered into the run's ``art.threading``
    threading: Optional[tuple] = None


def phase_one_chain(chain_id: int,
                    bubble_paths: Dict[int, List[List[int]]],
                    alignments, graph, outstem: str, full_output,
                    config: PhasingConfig, backend: str = "host",
                    columns=None, bucket=None, device="cuda",
                    devices=None) -> ChainPhasingResult:
    """One chain through every stage (``ahsoka_tpu/phase.py:85-143``):
    ``backend="jax"`` runs the device stages on ``device`` and threads the
    chain as a batch of one; ``backend="host"`` runs the numpy oracle and
    writes the readset debug files whatever the config says."""
    from ahsoka_tpu_torch.thread.dp_torch import thread_chain_device

    config = chain_config(config, chain_id)
    result = ChainPhasingResult(chain_id=chain_id,
                                num_bubbles=len(bubble_paths), skipped=True)
    if len(bubble_paths) <= 1:
        result.reason = "chain has <= 1 bubble"
        return result
    if columns is not None and backend != "jax":
        raise ValueError("columnar inputs require the device backend")

    if backend == "jax":
        dp = _prepare_chain_dp(chain_id, bubble_paths, alignments, outstem,
                               config, result, columns=columns,
                               bucket=bucket, device=device, devices=devices)
        if dp is None:
            return result
        with substage.span("dp") as s_dp:
            raw = thread_chain_device(dp, config, device=device,
                                      devices=devices)
        result.stage_seconds["threading"] = s_dp.wall
    else:
        with substage.span("readsets"):
            readsets = build_chain_readsets(bubble_paths, alignments, config)
        testset = readsets.partial_filtered
        if len(testset) == 0:
            log.warning("No reads in ReadSet for chain %d!", chain_id)
            result.reason = "empty filtered readset"
            return result
        _write_readset_debug_files(outstem, chain_id, readsets)
        with substage.span("scoring"):
            scores = score_pairs(readset_to_matrix(testset), config)
        with substage.timed("clustering.solver"):
            clusters = cluster_editing(scores, mode=config.ce_mode)
        with substage.span("dp_inputs"):
            dp = build_dp_inputs(testset, clusters, config)
        with substage.span("dp"):
            raw = thread_chain(dp, config)
        result.num_reads = len(testset)
        result.num_clusters = len(clusters)
        result.num_positions = dp.num_positions

    with substage.span("emit"):
        result.haplotype_alleles = emit_chain_result(
            graph=graph, chain_id=chain_id,
            hap_cluster_path=assign_rows(raw, config.ploidy),
            consensus_by_cluster=consensus_lookup(dp),
            dense_positions=[int(p) for p in dp.positions],
            bubble_paths=bubble_paths, ploidy=config.ploidy,
            outstem=outstem, full_output=full_output)
    result.skipped = False
    result.threading = (dp, config, raw)
    return result


def chain_config(config: PhasingConfig, chain_id: int) -> PhasingConfig:
    """The effective config for one chain: config.ploidy_map overrides
    the global ploidy per engine chain id (mixed-ploidy samples, BASELINE
    config 5).  Returns ``config`` unchanged when no override applies."""
    pm = getattr(config, "ploidy_map", None)
    if not pm:
        return config
    k = int(pm.get(chain_id, config.ploidy))
    if k == config.ploidy:
        return config
    return dataclasses.replace(config, ploidy=k, ploidy_map=None)


def _chain_collapse(matrix, config):
    """Identical-read collapsing decision for one chain: returns a
    CollapsedReads when enabled, the chain is large enough, and rows
    actually repeat (project/collapse.py), else None.  Both downstream
    paths use it: groups fitting the dense threshold score as a
    weighted [G, G] matrix; larger group sets go through banded scoring
    over the distinct rows (multiplicity-weighted stats + m_u*m_v edge
    weights)."""
    cm = None
    if config.ce_collapse_identical \
            and matrix.num_reads >= config.ce_collapse_min_reads:
        from ahsoka_tpu_torch.project.collapse import collapse_reads
        with substage.span("collapse"):
            cm = collapse_reads(matrix)
        # redundancy gate (config.ce_collapse_max_ratio): collapse only
        # where duplicate rows at least halve the instance — the regime
        # where the contracted trace tracks the exact one; low-redundancy
        # (noisy) chains run exact uncollapsed (the regime study's one
        # contract violation lived at G/R = 0.53)
        ratio = getattr(config, "ce_collapse_max_ratio", 0.5)
        if cm.num_groups > ratio * matrix.num_reads:
            cm = None
    substage.count("rows.before_collapse", matrix.num_reads)
    substage.count("rows.after_collapse",
                   matrix.num_reads if cm is None else cm.num_groups)
    if cm is not None:
        substage.count("chains.collapsed")
    return cm


_COLLAPSE_UNSET = object()

# batched projection pre-pass limits (whole-genome memory discipline):
# chains above the bubble cap run their own streaming per-chain path;
# the rest batch in slices so only one slice's padded inputs are live
_PRE_PASS_MAX_BUBBLES = 512
_PRE_PASS_SLICE = 256


def check_layout(config: PhasingConfig) -> None:
    """Refuse the chain layout combined with data or chain shards above 1
    at more than one process (``ahsoka_tpu/phase.py:464-472``)."""
    if config.process_chain_sharding and world()[0] > 1 \
            and (config.data_shards > 1 or config.chain_shards > 1):
        raise ValueError(
            "process_chain_sharding keeps device calls process-local; "
            "data_shards/chain_shards must be 1 (use the mesh layout for "
            "cross-process collectives)")


def _chain_matrix_stage(chain_id, bubble_paths, alignments, outstem,
                        config, result, columns=None, bucket=None,
                        precomputed=None, device="cuda", devices=None):
    """Chain pipeline through the allele matrix (projection + matrix
    assembly + coverage cap).  Returns the AlleleMatrix, or None with
    result.reason set."""
    from ahsoka_tpu_torch.project.device import (
        assemble_readsets, containment_key_tables, prepare_chain_inputs,
        prepare_chain_inputs_from_columns)
    from ahsoka_tpu_torch.project.matrix import (chain_matrix_from_keys,
                                                 partial_sweep_from_stats)

    marks = result.stage_seconds
    t = time.perf_counter()
    if precomputed is not None:
        inputs, (full_k, part_k, gate_k) = precomputed
        marks["prepare"] = time.perf_counter() - t
    else:
        if columns is not None:
            if bucket is None or len(bucket.record_idx) == 0:
                log.warning("No reads in ReadSet for chain %d!", chain_id)
                result.reason = "empty filtered readset"
                return None
            inputs = prepare_chain_inputs_from_columns(bubble_paths,
                                                       columns, bucket)
        else:
            inputs = prepare_chain_inputs(bubble_paths, alignments)
        if inputs.num_alignments == 0 or inputs.num_paths == 0:
            log.warning("No reads in ReadSet for chain %d!", chain_id)
            result.reason = "empty filtered readset"
            return None
        marks["prepare"] = time.perf_counter() - t
        t = time.perf_counter()
        full_k, part_k, gate_k = containment_key_tables(
            inputs, config, device=device, devices=devices)
        marks["projection"] = time.perf_counter() - t
    t = time.perf_counter()
    with substage.timed("matrix.sweep"):
        sweep = partial_sweep_from_stats(inputs, full_k, config)
    with substage.timed("matrix.assemble"):
        cm = chain_matrix_from_keys(inputs, part_k, gate_k, sweep, config)
    matrix = cm.matrix
    if not matrix.read_names:
        marks["matrix"] = time.perf_counter() - t
        log.warning("No reads in ReadSet for chain %d!", chain_id)
        result.reason = "empty filtered readset"
        return None
    if config.debug_readset_files:
        readsets = assemble_readsets(inputs, full_k, part_k, gate_k,
                                     config)
        _write_readset_debug_files(outstem, chain_id, readsets)
    if config.max_coverage is not None:
        from ahsoka_tpu_torch.project.subsample import subsample_matrix
        before = matrix.num_reads
        with substage.timed("matrix.covcap"):
            matrix, _ = subsample_matrix(matrix, config.max_coverage)
        if matrix.num_reads < before:
            log.info("chain %d: coverage cap kept %d/%d reads",
                     chain_id, matrix.num_reads, before)
    marks["matrix"] = time.perf_counter() - t
    return matrix


def _chain_cluster_dp_stage(matrix, config, result, scores=None,
                            collapse=_COLLAPSE_UNSET, device="cuda",
                            devices=None):
    """Allele matrix -> DP inputs (dense or, above
    ``banded_scoring_threshold`` effective rows, banded scoring; cluster
    editing, plain or over collapsed identical rows).  ``scores``
    short-circuits the dense scoring when the batched pre-pass already
    computed it."""
    from ahsoka_tpu_torch.cluster.editing import assignment_from_clusters
    from ahsoka_tpu_torch.cluster.postprocess import \
        build_dp_inputs_from_matrix
    from ahsoka_tpu_torch.score.device import score_pairs_device

    marks = result.stage_seconds
    if collapse is _COLLAPSE_UNSET:
        t = time.perf_counter()
        collapse = _chain_collapse(matrix, config)
        marks["collapse"] = time.perf_counter() - t
    effective_rows = (collapse.num_groups if collapse is not None
                      else matrix.num_reads)
    banded = effective_rows > config.banded_scoring_threshold
    substage.count("chains.banded" if banded else "chains.dense")
    if banded:
        # large chain: banded scoring -> sparse edges -> native sparse
        # solver; with a collapse the band runs over the distinct rows
        # and edges weigh m_u * m_v * s(u, v)
        from ahsoka_tpu_torch.cluster._native_ce import \
            cluster_editing_sparse
        from ahsoka_tpu_torch.score.banded import score_pairs_banded

        with substage.span("banded_scoring") as s_band:
            if collapse is not None:
                from ahsoka_tpu_torch.project.collapse import expand_clusters
                eu, ev, ew = score_pairs_banded(collapse.matrix, config,
                                                mult=collapse.mult,
                                                device=device)
                ew = ew * collapse.mult[eu] * collapse.mult[ev]
                n_nodes = collapse.num_groups
            else:
                eu, ev, ew = score_pairs_banded(matrix, config,
                                                device=device)
                n_nodes = matrix.num_reads
        marks["scoring"] = s_band.wall
        log.info("banded scoring: %d rows -> %d edges in %.1fs",
                 n_nodes, len(ew), marks["scoring"])
        t = time.perf_counter()
        with substage.timed("clustering.solver"):
            clusters = cluster_editing_sparse(n_nodes, eu, ev, ew,
                                              mode=config.ce_mode)
        if collapse is not None:
            with substage.timed("clustering.expand"):
                clusters = expand_clusters(clusters, collapse.inverse)
        marks["clustering"] = time.perf_counter() - t
    elif collapse is not None:
        from ahsoka_tpu_torch.project.collapse import expand_clusters
        import numpy as np

        t = time.perf_counter()
        if scores is None:
            with substage.span("scoring"):
                scores = score_pairs_device(collapse.matrix, config,
                                            mult=collapse.mult,
                                            device=device, devices=devices)
        # weighted group graph: edge weight m_u * m_v * s(u, v)
        w = scores * np.outer(collapse.mult, collapse.mult)
        np.fill_diagonal(w, 0.0)
        marks["scoring"] = marks.get("scoring", 0.0) \
            + (time.perf_counter() - t)
        t = time.perf_counter()
        with substage.timed("clustering.solver"):
            group_clusters = cluster_editing(w, mode=config.ce_mode)
        with substage.timed("clustering.expand"):
            clusters = expand_clusters(group_clusters, collapse.inverse)
        marks["clustering"] = time.perf_counter() - t
    else:
        t = time.perf_counter()
        if scores is None:
            with substage.span("scoring"):
                scores = score_pairs_device(matrix, config, device=device,
                                            devices=devices)
        marks["scoring"] = marks.get("scoring", 0.0) \
            + (time.perf_counter() - t)
        t = time.perf_counter()
        with substage.timed("clustering.solver"):
            clusters = cluster_editing(scores, mode=config.ce_mode)
        marks["clustering"] = time.perf_counter() - t
    with substage.span("dp_inputs"):
        cluster_of = assignment_from_clusters(clusters, matrix.num_reads)
        dp = build_dp_inputs_from_matrix(matrix.alleles, matrix.positions,
                                         cluster_of, config)
    result.num_reads = matrix.num_reads
    result.num_clusters = len(clusters)
    result.num_positions = dp.num_positions
    return dp


def _prepare_chain_dp(chain_id, bubble_paths, alignments, outstem, config,
                      result, columns=None, bucket=None, device="cuda",
                      devices=None):
    """The device backend's chain pipeline up to the DP inputs
    (projection, matrix assembly, scoring, clustering).  Returns DPInputs,
    or None with result.reason set."""
    with substage.span("matrix"):
        matrix = _chain_matrix_stage(chain_id, bubble_paths, alignments,
                                     outstem, config, result,
                                     columns=columns, bucket=bucket,
                                     device=device, devices=devices)
    if matrix is None:
        return None
    return _chain_cluster_dp_stage(matrix, config, result, device=device,
                                   devices=devices)


def phase_all_chains(art, outstem: str, config: PhasingConfig,
                     backend: str = "host", resume: bool = False,
                     keep_going: bool = False, device="cuda", devices=None
                     ) -> List[ChainPhasingResult]:
    """Phase every chain, largest first, one at a time
    (``ahsoka_tpu/phase.py:357-417``).

    ``resume=True`` skips chains whose per-chain result file already
    exists; ``keep_going=True`` records a chain's failure and goes on.
    On the device backend ``dp_device_window`` is the sum of the chains'
    threading seconds.  ``art.threading`` gets the run's DP inputs,
    configs and paths, as from the batched driver."""
    from ahsoka_tpu_torch.thread.states import max_states

    _load_native_helpers(config)
    columns = getattr(art, "gaf_columns", None)
    results: List[ChainPhasingResult] = []
    threading = {"dps": [], "configs": [], "paths": []}
    with open(f"{outstem}-result.txt", "w") as full_output:
        for size, chain_id in art.size_sorting:
            full_output.write(f"chain id: {chain_id}\n")
            full_output.write(f"size of chain: {size}\n")
            chain_file = f"{outstem}-chain{chain_id}-result.txt"
            if resume and os.path.exists(chain_file):
                res = ChainPhasingResult(chain_id=chain_id,
                                         num_bubbles=size, skipped=False,
                                         resumed=True)
                with open(chain_file) as fh:
                    for i, line in enumerate(fh):
                        full_output.write(f"haplotype {i}:\n")
                        full_output.write(line)
                results.append(res)
                continue
            t0 = time.perf_counter()
            bucket = (art.chain_buckets.get(chain_id)
                      if getattr(art, "chain_buckets", None) is not None
                      else None)
            try:
                res = phase_one_chain(
                    chain_id=chain_id,
                    bubble_paths=art.allele_paths[chain_id],
                    alignments=(art.alignments.chain_alignments(chain_id)
                                if columns is None else None),
                    graph=art.graph, outstem=outstem,
                    full_output=full_output, config=config,
                    backend=backend, columns=columns, bucket=bucket,
                    device=device, devices=devices)
            except Exception as exc:
                if not keep_going:
                    raise
                log.error("chain %d failed: %s", chain_id, exc)
                res = ChainPhasingResult(chain_id=chain_id,
                                         num_bubbles=size, skipped=True,
                                         reason="error", error=str(exc))
            res.seconds = time.perf_counter() - t0
            if not res.skipped:
                ccfg = chain_config(config, chain_id)
                S = max_states(ccfg.ploidy)
                res.dp_cells = max(res.num_positions - 1, 0) \
                    * _dp_frontier_width(ccfg, S) * S
            if res.threading is not None:
                for key, value in zip(("dps", "configs", "paths"),
                                      res.threading):
                    threading[key].append(value)
            results.append(res)
    if backend == "jax":
        art.stage_seconds["dp_device_window"] = sum(
            r.stage_seconds.get("threading", 0.0) for r in results)
    art.threading = threading
    return results


def _load_native_helpers(config: PhasingConfig) -> None:
    """Build (g++, at first use) and load the native cluster editing and
    coverage-cap libraries on this thread, before any worker starts, so
    a failed build raises here rather than inside a worker."""
    from ahsoka_tpu_torch.cluster import _native_ce
    from ahsoka_tpu_torch.project import _native_covcap

    _native_ce._load()
    if config.max_coverage is not None:
        _native_covcap._load()


def _dp_frontier_width(config: PhasingConfig, S: int) -> int:
    from ahsoka_tpu_torch.thread.dp_torch import _beam_width_for
    return _beam_width_for(config, S) or S


def _projection_pre_pass(art, work, config, columns, device, devices
                         ) -> Dict[int, tuple]:
    """Batched projection for every pre-pass chain (<= 512 bubbles; every
    chain when the projection is data-sharded, so that its collectives
    stay on this thread), in slices of 256 chains so one slice's padded
    inputs are live at a time.  Returns {chain_id: (inputs, key
    tables)}."""
    from ahsoka_tpu_torch.project.device import (
        containment_key_tables_many, data_mesh, prepare_chain_inputs,
        prepare_chain_inputs_from_columns)

    pre: Dict[int, tuple] = {}
    sharded = data_mesh(config, devices, device) is not None
    cap = float("inf") if sharded else _PRE_PASS_MAX_BUBBLES
    todo = [chain_id for _size, chain_id in work
            if 1 < len(art.allele_paths[chain_id]) <= cap]
    for s0 in range(0, len(todo), _PRE_PASS_SLICE):
        cand = []
        for chain_id in todo[s0:s0 + _PRE_PASS_SLICE]:
            bubble_paths = art.allele_paths[chain_id]
            # a chain whose host prep fails here takes the per-chain path
            # in pass 1, where its error is recorded (keep_going) or raised
            try:
                if columns is not None:
                    bucket = (art.chain_buckets.get(chain_id)
                              if art.chain_buckets is not None else None)
                    if bucket is None or len(bucket.record_idx) == 0:
                        continue
                    inputs = prepare_chain_inputs_from_columns(
                        bubble_paths, columns, bucket)
                else:
                    inputs = prepare_chain_inputs(
                        bubble_paths, art.alignments.chain_alignments(chain_id))
            except Exception:          # noqa: BLE001
                continue
            if inputs.num_alignments == 0 or inputs.num_paths == 0:
                continue
            cand.append((chain_id, inputs))
        if not cand:
            continue
        tables = containment_key_tables_many([inp for _, inp in cand],
                                             config, device=device,
                                             devices=devices)
        for (cid, inp), tab in zip(cand, tables):
            if not config.debug_readset_files:
                # the kernel consumed the one-hots; the matrix stage
                # reads only ids/identities/names
                inp.path_onehot_full = None
                inp.path_onehot_inner = None
            pre[cid] = (inp, tab)
    substage.count("chains.pre_pass", len(pre))
    return pre


def phase_all_chains_batched(art, outstem: str, config: PhasingConfig,
                             resume: bool = False, keep_going: bool = False,
                             device="cuda", devices=None
                             ) -> List[ChainPhasingResult]:
    """Batched driver: pass 1 runs every chain up to its allele matrix,
    pass 2 scores and clusters, pass 3 threads all chains batched and
    emits in size-sorted order.  ``device`` is the torch device of the
    projection, scoring and DP stages; ``devices`` this process's devices
    for the sharded layouts (default: every card for CUDA, ``device``
    alone for the CPU)."""
    from ahsoka_tpu_torch.thread.dp_host import assign_rows
    from ahsoka_tpu_torch.thread.states import max_states
    from ahsoka_tpu_torch.score.device import score_pairs_device_many
    from ahsoka_tpu_torch.thread.dp_torch import (thread_chain_device,
                                                  thread_chains_batched)

    check_layout(config)
    _load_native_helpers(config)
    columns = getattr(art, "gaf_columns", None)
    # multi-process chain sharding: chains go round-robin over the ranks
    # in size-sorted order (ahsoka_tpu/phase.py:458-472)
    nproc, rank = world() if config.process_chain_sharding else (1, 0)

    # resume decisions are serial and cheap; output order is the
    # deterministic size_sorting order
    work: List[Tuple[int, int]] = []        # (size, chain_id)
    slots: List = []                        # records in size_sorting order
    for idx, (size, chain_id) in enumerate(art.size_sorting):
        if nproc > 1 and idx % nproc != rank:
            res = ChainPhasingResult(chain_id=chain_id, num_bubbles=size,
                                     skipped=True,
                                     reason="owned by another process")
            slots.append(("remote", res, None))
            continue
        chain_file = f"{outstem}-chain{chain_id}-result.txt"
        if resume and os.path.exists(chain_file):
            res = ChainPhasingResult(chain_id=chain_id, num_bubbles=size,
                                     skipped=False, resumed=True)
            slots.append(("resumed", res, chain_file))
        else:
            if nproc > 1 and os.path.exists(chain_file):
                # the aggregate is rebuilt from chain files: a stale one
                # would resurrect a chain this run skips or fails
                os.remove(chain_file)
            slots.append(len(work))         # placeholder index
            work.append((size, chain_id))

    pre: Dict[int, tuple] = {}
    if work:
        with substage.span("pre_pass"):
            pre = _projection_pre_pass(art, work, config, columns, device,
                                       devices)

    def matrix_one(size, chain_id):
        """Pass-1 body: chain -> ("skipped", res, None) or
        ("matrix", res, (chain_id, bubble_paths, matrix, cm, ccfg))."""
        res = ChainPhasingResult(chain_id=chain_id, num_bubbles=size,
                                 skipped=True)
        ccfg = chain_config(config, chain_id)
        t0 = time.perf_counter()
        bubble_paths = art.allele_paths[chain_id]
        if len(bubble_paths) <= 1:
            res.reason = "chain has <= 1 bubble"
            res.seconds = time.perf_counter() - t0
            return ("skipped", res, None)
        bucket = (art.chain_buckets.get(chain_id)
                  if getattr(art, "chain_buckets", None) is not None
                  else None)
        try:
            with substage.span("matrix"):
                matrix = _chain_matrix_stage(
                    chain_id, bubble_paths,
                    (art.alignments.chain_alignments(chain_id)
                     if columns is None else None),
                    outstem, ccfg, res, columns=columns, bucket=bucket,
                    precomputed=pre.get(chain_id), device=device,
                    devices=devices)
        except Exception as exc:
            if not keep_going:
                raise
            log.error("chain %d failed: %s", chain_id, exc)
            res.reason, res.error = "error", str(exc)
            res.seconds = time.perf_counter() - t0
            return ("skipped", res, None)
        res.seconds = time.perf_counter() - t0
        if matrix is None:
            return ("skipped", res, None)
        t1 = time.perf_counter()
        try:
            cm = _chain_collapse(matrix, ccfg)
        except Exception as exc:
            if not keep_going:
                raise
            # an uncollapsed chain is slower, not wrong
            log.error("chain %d collapse failed (%s); continuing "
                      "uncollapsed", chain_id, exc)
            cm = None
        res.stage_seconds["collapse"] = time.perf_counter() - t1
        res.seconds += res.stage_seconds["collapse"]
        return ("matrix", res, (chain_id, bubble_paths, matrix, cm, ccfg))

    def cluster_one(entry, scores=None):
        """Pass-2 body: ("matrix", ...) -> ("skipped"/"compute", ...)."""
        kind, res, payload = entry
        if kind != "matrix":
            return entry
        chain_id, bubble_paths, matrix, cm, ccfg = payload
        t0 = time.perf_counter()
        try:
            dp = _chain_cluster_dp_stage(matrix, ccfg, res, scores=scores,
                                         collapse=cm, device=device,
                                         devices=devices)
        except Exception as exc:
            if not keep_going:
                raise
            log.error("chain %d failed: %s", chain_id, exc)
            res.reason, res.error = "error", str(exc)
            res.seconds += time.perf_counter() - t0
            return ("skipped", res, None)
        res.seconds += time.perf_counter() - t0
        if dp is None:
            return ("skipped", res, None)
        return ("compute", res, (chain_id, bubble_paths, dp, ccfg))

    def _pool_map(name, fn, items):
        """``fn`` over ``items`` on the worker pool, under span ``name``."""
        with substage.span(name) as pool_span:
            if config.threads > 1 and len(items) > 1:
                from concurrent.futures import ThreadPoolExecutor

                def task(it):
                    with substage.within(pool_span):
                        return fn(it)
                with ThreadPoolExecutor(max_workers=config.threads) as pool:
                    return list(pool.map(task, items))
            return [fn(it) for it in items]

    prepared = _pool_map("matrix_pool", lambda w: matrix_one(*w), work)

    def _effective(payload):
        _cid, _bp, matrix, cm, _ccfg = payload
        return cm.num_groups if cm is not None else matrix.num_reads

    # batched dense scoring on this thread, consumed slice by slice under
    # a host-byte budget for the fetched [G, G] float64 matrices
    dense_idx = [i for i, (kind, _res, payload) in enumerate(prepared)
                 if kind == "matrix"
                 and _effective(payload) <= config.banded_scoring_threshold]
    slices: List[List[int]] = []
    if dense_idx:
        budget = max(int(config.score_fetch_budget_bytes), 1 << 20)
        cur: List[int] = []
        cur_bytes = 0
        for i in dense_idx:
            nbytes = 8 * _effective(prepared[i][2]) ** 2
            if cur and cur_bytes + nbytes > budget:
                slices.append(cur)
                cur, cur_bytes = [], 0
            cur.append(i)
            cur_bytes += nbytes
        if cur:
            slices.append(cur)

    clustered = set()
    for sl in slices:
        substage.count("scoring.slices")
        with substage.span("score_slice"):
            mats, mults = [], []
            for i in sl:
                _cid, _bp, matrix, cm, _ccfg = prepared[i][2]
                mats.append(cm.matrix if cm is not None else matrix)
                mults.append(cm.mult if cm is not None else None)
            many = score_pairs_device_many(mats, config, mults=mults,
                                           device=device, devices=devices)
            score_map = dict(zip(sl, many))
            del many, mats
        done = _pool_map(
            "cluster_pool",
            lambda i: cluster_one(prepared[i], scores=score_map.pop(i)), sl)
        for i, entry in zip(sl, done):
            prepared[i] = entry
        clustered.update(sl)

    rest = [i for i in range(len(prepared)) if i not in clustered]
    done = _pool_map("cluster_rest", lambda i: cluster_one(prepared[i]),
                     rest)
    for i, entry in zip(rest, done):
        prepared[i] = entry

    records = []          # (kind, result, payload)
    dps = []
    dp_cfgs = []          # per-dp effective config (ploidy overrides)
    for slot in slots:
        if not isinstance(slot, int):
            records.append(slot)
            continue
        kind, res, payload = prepared[slot]
        if kind != "compute":
            records.append((kind, res, payload))
            continue
        chain_id, bubble_paths, dp, ccfg = payload
        records.append(("compute", res, (chain_id, bubble_paths, dp,
                                         ccfg, len(dps))))
        dps.append(dp)
        dp_cfgs.append(ccfg)

    with substage.span("dp") as s_dp:
        try:
            paths = thread_chains_batched(dps, config, chain_configs=dp_cfgs,
                                          device=device, devices=devices)
        except Exception as exc:
            # keep_going: retry chain by chain so one sick chain cannot
            # abort the run; without it the failure propagates
            if not keep_going:
                raise
            log.error("batched threading DP failed (%s: %s); retrying "
                      "per chain", type(exc).__name__, exc)
            paths = []
            for dp, dcfg in zip(dps, dp_cfgs):
                try:
                    paths.append(thread_chain_device(
                        dp, dcfg, device=device, devices=devices))
                except Exception as exc2:
                    log.error("per-chain threading failed: %s", exc2)
                    paths.append(None)
    dp_seconds = s_dp.wall
    art.stage_seconds["dp_device_window"] = dp_seconds
    # the run's DP inputs and paths, for re-threading checks
    art.threading = {"dps": dps, "configs": dp_cfgs, "paths": paths}

    results: List[ChainPhasingResult] = []
    # with several ranks each writes its chain files and rank 0 merges the
    # aggregate below
    agg = (open(f"{outstem}-result.txt", "w") if nproc == 1
           else contextlib.nullcontext(None))
    with substage.span("emit"), agg as full_output:
        for kind, res, payload in records:
            if full_output is not None:
                full_output.write(f"chain id: {res.chain_id}\n")
                full_output.write(f"size of chain: {res.num_bubbles}\n")
            if kind == "resumed":
                if full_output is not None:
                    with open(payload) as fh:
                        for i, line in enumerate(fh):
                            full_output.write(f"haplotype {i}:\n")
                            full_output.write(line)
            elif kind == "compute" and paths[payload[4]] is None:
                res.reason, res.error = "error", "threading failed"
            elif kind == "compute":
                chain_id, bubble_paths, dp, ccfg, dp_idx = payload
                t1 = time.perf_counter()
                path = assign_rows(paths[dp_idx], ccfg.ploidy)
                res.haplotype_alleles = emit_chain_result(
                    graph=art.graph, chain_id=chain_id,
                    hap_cluster_path=path,
                    consensus_by_cluster=consensus_lookup(dp),
                    dense_positions=[int(p) for p in dp.positions],
                    bubble_paths=bubble_paths, ploidy=ccfg.ploidy,
                    outstem=outstem, full_output=full_output)
                res.skipped = False
                S = max_states(ccfg.ploidy)
                res.dp_cells = max(res.num_positions - 1, 0) \
                    * _dp_frontier_width(ccfg, S) * S
                res.seconds += (time.perf_counter() - t1
                                + dp_seconds / max(len(dps), 1))
            results.append(res)
    if nproc > 1:
        # every owner has written its chain files (shared filesystem);
        # rank 0 assembles the aggregate in size-sorted order
        barrier()
        if rank == 0:
            merge_aggregate_result(outstem, art.size_sorting)
        barrier()
    return results


def merge_aggregate_result(outstem: str, size_sorting) -> None:
    """Rebuild the aggregate -result.txt from the per-chain result files
    (``ahsoka_tpu/phase.py:829-845``): headers for every chain, haplotype
    sections for the phased ones, byte for byte the single-process
    layout."""
    with open(f"{outstem}-result.txt", "w") as out:
        for size, chain_id in size_sorting:
            out.write(f"chain id: {chain_id}\n")
            out.write(f"size of chain: {size}\n")
            chain_file = f"{outstem}-chain{chain_id}-result.txt"
            if os.path.exists(chain_file):
                with open(chain_file) as fh:
                    for i, line in enumerate(fh):
                        out.write(f"haplotype {i}:\n")
                        out.write(line)


def _write_readset_debug_files(outstem: str, chain_id: int,
                               readsets: ChainReadsets) -> None:
    """The reference's per-chain readset dumps
    (src/alignmentstoreadset.cpp:284-304); our debug format."""
    with open(f"{outstem}-chain{chain_id}-readset.txt", "w") as fh:
        fh.write(f"readsets for chain {chain_id}: {len(readsets.full)}\n")
        fh.write(readsets.full.to_debug_string() + "\n")
        fh.write(f"testset size: {len(readsets.full_filtered)}\n")
        fh.write(readsets.full_filtered.to_debug_string() + "\n")
        fh.write(f"partial testset size: "
                 f"{len(readsets.partial_filtered)}\n")
        fh.write(readsets.partial_filtered.to_debug_string() + "\n")
    with open(f"{outstem}-chain{chain_id}-readset_final.txt", "w") as fh:
        fh.write(f"readset size: {len(readsets.partial_filtered)}\n")
        fh.write(readsets.partial_filtered.to_debug_string() + "\n")
