"""Sharded stage functions of the port: each runs the unsharded stage's
torch code (and, in the DP, its CUDA kernels) once per local shard of a
``Mesh``, on the shard's device, then merges with a collective.

Counterpart of ``ahsoka_tpu/dist/step.py:39-184``:

- **Projection** (``sharded_containment_keys``): alignments padded to
  ``shards * chunk`` split into equal slices; each shard runs
  ``containment_keys_core`` on its slice with the slice's global
  alignment offset, so every packed key names the same alignment as in
  the unsharded run, and the three int32 key tables merge with
  ``min_merge`` from NO_MATCH.  Min does not depend on order, so the
  merge is exact.  (The JAX package packs shard-local alignment indices
  there, which differ from the unsharded keys once alignments reach a
  second shard.)
- **Scoring** (``sharded_score_pairs``): each shard scores the
  ``[R/D, R]`` row block at its global offset with per-position
  statistics from the full matrix, and ``gather_rows`` joins the blocks.
- **Threading DP** (``sharded_thread_states``): a group's chains split
  with ``torch.tensor_split`` (uneven and empty shards allowed; empty ones
  launch nothing); each shard runs ``thread_states`` on its chains, which
  on CUDA launches the forward and backtrace kernels once per shard, and
  ``gather_rows`` joins the states in chain order.  The TPU kernels'
  128- and 1024-chain padding has no counterpart: the CUDA kernels take
  any chain count.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from ahsoka_tpu_torch.dist.mesh import Mesh, Shard, gather_rows, min_merge
from ahsoka_tpu_torch.state import to_torch


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def shard_alignments(mesh: Mesh, nodes: np.ndarray, name_id: np.ndarray,
                     ident: np.ndarray, chunk: int, num_names: int
                     ) -> List[Tuple[Shard, Tuple[torch.Tensor, ...], int]]:
    """Pad a chain's alignment arrays to ``mesh.size * chunk`` (nodes -1,
    name id ``num_names``, identity 0: ``project/device.py:959-966`` of
    the JAX package) and upload this rank's slices: [(shard, (nodes,
    name_id, ident) with a leading batch axis of one, global offset)]."""
    total = _round_up(nodes.shape[0], mesh.size * chunk)
    extra = total - nodes.shape[0]
    if extra:
        nodes = np.pad(nodes, ((0, extra), (0, 0)), constant_values=-1)
        name_id = np.pad(name_id, (0, extra), constant_values=num_names)
        ident = np.pad(ident, (0, extra))
    per = total // mesh.size
    out = []
    for shard in mesh.local_shards():
        lo = shard.index * per
        tensors = to_torch(nodes[None, lo:lo + per],
                           name_id[None, lo:lo + per],
                           ident[None, lo:lo + per], device=shard.device)
        out.append((shard, tensors, lo))
    return out


def sharded_containment_keys(
        mesh: Mesh, path_tables: Callable[[torch.device], Sequence],
        alignments, gate_value: float, *, num_bubbles: int, num_names: int,
        chunk: int, alleles_per_bubble: int = 0) -> torch.Tensor:
    """[1, 3, B, N] int32 key tables on ``mesh.home``, min-merged over
    every shard.  ``path_tables(device)`` gives the six path tensors
    (pf, pi, plf, pli, pb, pkb) with a leading batch axis on a device;
    ``alignments`` is ``shard_alignments``'s list."""
    from ahsoka_tpu_torch.project.device import (NO_MATCH,
                                                 containment_keys_core)

    parts = []
    for shard, (nodes, name_id, ident), offset in alignments:
        parts.append(containment_keys_core(
            *path_tables(shard.device), nodes, name_id, ident, gate_value,
            num_bubbles=num_bubbles, num_names=num_names, chunk=chunk,
            alleles_per_bubble=alleles_per_bubble, aln_offset=offset))
    identity = torch.full((1, 3, num_bubbles, num_names), int(NO_MATCH),
                          dtype=torch.int32, device=mesh.home)
    return min_merge(parts, identity)


def sharded_score_pairs(mesh: Mesh, alleles: np.ndarray, scalar: float, *,
                        num_alleles: int, ploidy: int, min_overlap: int,
                        mode: str) -> torch.Tensor:
    """The [R_pad, R_pad] float32 pair scores of one chain's padded
    [R_pad, P_pad] allele matrix (R_pad a multiple of the mesh size), row
    blocks computed per shard, gathered on ``mesh.home``."""
    from ahsoka_tpu_torch.device import set_true_fp32
    from ahsoka_tpu_torch.score.device import (_score_rows_core,
                                               _score_rows_core_wh)

    core = _score_rows_core_wh if mode == "whatshap" else _score_rows_core
    R_pad = alleles.shape[0]
    rows = R_pad // mesh.size
    uploaded = {}
    parts = []
    for shard in mesh.local_shards():
        dev = shard.device
        if dev.type == "cuda":
            set_true_fp32()
        if dev not in uploaded:
            uploaded[dev] = to_torch(alleles[None],
                                     np.asarray([scalar], dtype=np.float32),
                                     device=dev)
        full, s = uploaded[dev]
        row0 = shard.index * rows
        parts.append(core(full[:, row0:row0 + rows], full, s, row0,
                          num_alleles=num_alleles, ploidy=ploidy,
                          min_overlap=min_overlap)[0])
    return gather_rows(parts, torch.empty((0, R_pad), dtype=torch.float32,
                                          device=mesh.home))


def sharded_thread_states(mesh: Mesh, arrays: Sequence[np.ndarray], config,
                          *, ploidy: int, num_alleles: int) -> torch.Tensor:
    """One DP group's [C, P_pad] int32 states on ``mesh.home``: the packed
    group arrays (candidates, num_candidates, coverage, consensus,
    genotypes; ``thread.dp_torch._pack_group``) split over the mesh's
    shards by chains."""
    from ahsoka_tpu_torch.thread.dp_torch import thread_states

    C, P_pad = arrays[0].shape[:2]
    bounds = [(int(p[0]), int(p[-1]) + 1) if len(p) else None
              for p in torch.tensor_split(torch.arange(C), mesh.size)]
    parts = []
    for shard in mesh.local_shards():
        if bounds[shard.index] is None:
            continue
        lo, hi = bounds[shard.index]
        tensors = to_torch(*(a[lo:hi] for a in arrays), device=shard.device)
        parts.append(thread_states(*tensors, config, ploidy=ploidy,
                                   num_alleles=num_alleles))
    return gather_rows(parts, torch.empty((0, P_pad), dtype=torch.int32,
                                          device=mesh.home))
