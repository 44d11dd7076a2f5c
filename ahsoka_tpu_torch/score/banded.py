"""Banded pairwise scoring -> sparse edge list, in PyTorch.

Counterpart of ``ahsoka_tpu/score/banded.py``.  Reads of a chain matrix
are ordered by first covered position, so a pair can score nonzero only
where the two reads' position ranges overlap: a ragged band around the
diagonal.  The band is scored block pair by block pair on the device and
comes back as the sparse upper-triangle edge list (u, v, w) that the
native sparse cluster editing takes; the [R, R] matrix is never built.

Same block scores as the JAX package (``_block_scores`` for "fresh",
``_block_scores_wh`` for the default "whatshap" mode) in true float32
(``device.set_true_fp32``: no TF32, the JAX package's
``Precision.HIGHEST``), the same block-pair enumeration over the band,
and the same edge selection: strictly upper within diagonal blocks, rows
and columns below R, exact zeros dropped.  Edges come out group by
group, then (pair, i, j) ascending (``torch.nonzero``'s row-major order,
the order of the JAX compaction).  One sum differs: whatshap's per-pair
``pd_sum`` is exact (float64) where the JAX package sums float32 in its
matmul's order, so the card and the CPU agree; the edge lists equal the
JAX package's where its float32 sums are exact, and on large chains the
JAX package keeps a few edges of |w| ~ 1e-5 whose exact score is 0.

Not ported: the transport code of the remote TPU link (the packed edge
buffer, its capacity guess and second fetch, ``_compact_mask_scatter``).
A CUDA error propagates; nothing re-runs on the CPU.
"""

from __future__ import annotations

import threading
from typing import Tuple

import numpy as np
import torch

from ahsoka_tpu_torch.config import PhasingConfig
from ahsoka_tpu_torch.score.pairwise import (_EPS_CLIP, AlleleMatrix,
                                       estimate_error_rate, position_weights)
from ahsoka_tpu_torch.utils import substage
from ahsoka_tpu_torch.utils.logging import get_logger
from ahsoka_tpu_torch.device import set_true_fp32
from ahsoka_tpu_torch.score.device import _bmm_t
from ahsoka_tpu_torch.state import to_torch

log = get_logger(__name__)

# device bytes of one group of block pairs (its operands and [block,
# block] temporaries); chains are scored in up to 8 worker threads at once
_GROUP_BYTES = 1 << 30

_count_lock = threading.Lock()


def _block_scores(rows, cols, w_agree, w_dis, *, num_alleles: int,
                  min_overlap: int):
    """rows [G, BR, P], cols [G, BC, P] int16 alleles -> [G, BR, BC]
    scores, zero where overlap < min_overlap ("fresh" mode)."""
    rmask = (rows >= 0).to(torch.float32)
    cmask = (cols >= 0).to(torch.float32)
    scores = _bmm_t(rmask * w_dis, cmask)
    diff_w = w_agree - w_dis
    for a in range(num_alleles):
        scores = scores + _bmm_t((rows == a).to(torch.float32) * diff_w,
                                 (cols == a).to(torch.float32))
    overlap = _bmm_t(rmask, cmask)
    return torch.where(overlap < min_overlap, 0.0, scores)


def _block_scores_wh(rows, cols, pd, p_s, *, num_alleles: int,
                     min_overlap: int):
    """WhatsHap-mode blocks: the binomial LLR from overlap, agreement and
    the per-position different-haplotype disagreement probability ``pd``
    [P] (``score/whatshap.py``), scalar ``p_s``."""
    rmask = (rows >= 0).to(torch.float32)
    cmask = (cols >= 0).to(torch.float32)
    overlap = _bmm_t(rmask, cmask)
    agree = torch.zeros_like(overlap)
    for a in range(num_alleles):
        agree = agree + _bmm_t((rows == a).to(torch.float32),
                               (cols == a).to(torch.float32))
    # the float64 sum of float32 terms is exact in any order: one
    # rounding, the same on every device (the score's slope in p_d
    # reaches agree / 1e-4 near the clip, so a last-bit difference in a
    # float32 sum would show)
    pd_sum = _bmm_t((rmask * pd).double(), cmask.double()).float()
    ov = torch.clamp(overlap, min=1.0)
    p_d = torch.clamp(torch.maximum(pd_sum / ov, p_s), max=1.0 - _EPS_CLIP)
    d = overlap - agree
    scores = (d * torch.log(p_s / p_d)
              + agree * torch.log((1.0 - p_s) / (1.0 - p_d)))
    return torch.where(overlap < min_overlap, 0.0, scores)


def _group_edges(alleles_dev, r0s, c0s, R: int, block: int, score):
    """Score one group of block pairs and select its edges on the device
    (``_pack_block_edges``' selection) -> (u, v, w) numpy arrays."""
    dev = alleles_dev.device
    r0 = torch.as_tensor(r0s, dtype=torch.int64, device=dev)
    c0 = torch.as_tensor(c0s, dtype=torch.int64, device=dev)
    offs = torch.arange(block, dtype=torch.int64, device=dev)
    ri, ci = r0[:, None] + offs, c0[:, None] + offs             # [G, block]
    stack = score(alleles_dev[ri], alleles_dev[ci])             # [G, B, B]
    mask = ((stack != 0.0) & (ri < R)[:, :, None]
            & (ci < R)[:, None, :])
    upper = offs[:, None] < offs[None, :]
    mask &= upper | (r0 != c0)[:, None, None]
    g, i, j = torch.nonzero(mask, as_tuple=True)
    out = ((r0[g] + i).cpu().numpy(), (c0[g] + j).cpu().numpy(),
           stack[g, i, j].cpu().numpy())
    # the selection's count and the three copies
    substage.count("device.round_trips", 4)
    substage.count("device.fetch_bytes", sum(a.nbytes for a in out))
    return out


def score_pairs_banded(matrix: AlleleMatrix, config: PhasingConfig,
                       block: int = 1024, error_rate=None, mult=None,
                       device="cuda"
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sparse upper-triangle edges (u int64, v int64, w float64) with
    w != 0, scored on ``device``.

    Rows must be ordered by first covered position (the pipeline's
    matrices and collapsed matrices are).  ``mult`` weights the
    per-position statistics by row multiplicity; the block scores stay
    per representative row and the caller scales edges by m_u * m_v.
    ``score_pairs_banded.launches`` counts the calls on a CUDA device."""
    dev = torch.device(device)
    alleles = matrix.alleles
    R, P = alleles.shape
    whatshap = config.score_mode == "whatshap"
    substage.count("scoring.p_s_host")
    with substage.timed("scoring.host_stats"):
        if whatshap:
            from ahsoka_tpu_torch.score.whatshap import chain_p_s, position_pd
            # p_s pairs rows quadratically: estimate it on a row sample;
            # pd is linear in R and uses the full matrix
            sm, smult = _row_sample(matrix, mult=mult)
            p_s = chain_p_s(sm, config, error_rate, mult=smult)
            stats = (position_pd(matrix, config, p_s, mult=mult), p_s)
        else:
            eps = error_rate if error_rate is not None else (
                estimate_error_rate_banded(matrix, config, mult=mult)
                if config.estimate_error_rate else config.error_rate)
            stats = position_weights(matrix, config, eps, mult=mult)[:2]

    r_nz, p_nz, v_nz = matrix.covered_coo()     # row-major
    row_start = np.searchsorted(r_nz, np.arange(R))
    row_end = np.searchsorted(r_nz, np.arange(R), side="right")
    has = row_end > row_start
    firsts = np.where(has, p_nz[np.minimum(row_start,
                                           max(len(p_nz) - 1, 0))], P)
    lasts = np.where(has, p_nz[np.maximum(row_end - 1, 0)], -1)
    num_alleles = max(int(v_nz.max(initial=-1)) + 1, 2)

    if dev.type == "cuda":
        set_true_fp32()
    # the row-padded matrix, built once on the device from its COO;
    # padding rows are uncovered (-1), score 0 and never become edges
    R_pad = ((R + block - 1) // block) * block
    with substage.timed("scoring.upload"):
        r_t, p_t, v_t = to_torch(r_nz, p_nz, v_nz.astype(np.int16),
                                 device=dev)
        alleles_dev = torch.full((R_pad, P), -1, dtype=torch.int16,
                                 device=dev)
        alleles_dev[r_t.long(), p_t.long()] = v_t
        a1, a2 = (torch.as_tensor(np.asarray(x, dtype=np.float32),
                                  device=dev) for x in stats)
        substage.count("device.upload_bytes",
                       4 * sum(np.size(x) for x in stats))

    # the band's block pairs: the columns that can overlap a row block
    # are those whose first position is <= the block's last one
    pairs = []                         # (r0, c0)
    for bi in range((R + block - 1) // block):
        r0, r1 = bi * block, min((bi + 1) * block, R)
        max_last = int(lasts[r0:r1].max(initial=-1))
        j_end = max(int(np.searchsorted(firsts, max_last, side="right")),
                    r1)
        pairs.extend((r0, c0) for c0 in range(r0, min(j_end, R), block))
    # per pair: int16 rows and columns, float32 masks and one-hots,
    # float64 pd operands (~40 B per block row and position), and the
    # [block, block] float32 temporaries
    per_pair = 4 * block * (10 * P + 8 * block)
    group = max(1, min((96 << 20) // (block * block * 4),
                       _GROUP_BYTES // per_pair))
    log.info("banded scoring: %d reads, %d block pairs in groups of %d",
             R, len(pairs), group)

    kw = dict(num_alleles=num_alleles, min_overlap=config.min_overlap)
    if whatshap:
        def score(rows, cols):
            return _block_scores_wh(rows, cols, a1, a2, **kw)
    else:
        def score(rows, cols):
            return _block_scores(rows, cols, a1, a2, **kw)

    us, vs, ws = [], [], []
    for lo in range(0, len(pairs), group):
        batch = np.asarray(pairs[lo:lo + group], dtype=np.int64)
        with substage.timed("scoring.device"):
            u, v, w = _group_edges(alleles_dev, batch[:, 0], batch[:, 1],
                                   R, block, score)
        us.append(u)
        vs.append(v)
        ws.append(w)
    if dev.type == "cuda":
        with _count_lock:
            score_pairs_banded.launches += 1
    if not us:
        z = np.zeros(0)
        return z.astype(np.int64), z.astype(np.int64), z
    return (np.concatenate(us), np.concatenate(vs),
            np.concatenate(ws).astype(np.float64))


score_pairs_banded.launches = 0


def _row_sample(matrix: AlleleMatrix, sample: int = 2048, mult=None):
    """Evenly spaced row subset for quadratic-cost estimators.
    Returns (matrix, mult) with mult sampled consistently (or None)."""
    if matrix.num_reads <= sample:
        return matrix, mult
    idx = np.linspace(0, matrix.num_reads - 1, sample).astype(int)
    sm = AlleleMatrix(alleles=matrix.alleles[idx],
                      positions=matrix.positions,
                      read_names=[matrix.read_names[i] for i in idx])
    return sm, (mult[idx] if mult is not None else None)


def estimate_error_rate_banded(matrix: AlleleMatrix,
                               config: PhasingConfig,
                               sample: int = 2048, mult=None) -> float:
    """eps estimation on a row sample (the dense estimator builds [R, R])."""
    sm, smult = _row_sample(matrix, sample, mult=mult)
    return estimate_error_rate(sm, config, mult=smult)
