"""Dense pairwise read scoring in PyTorch.

Counterpart of ``ahsoka_tpu/score/device.py``: the [R, R] pair matrix of
a chain comes from float32 matmuls over the reads x positions one-hots,
with per-position statistics computed on the device from the allele
matrix.  Both scoring modes are ported with their row-multiplicity
weights (collapsed matrices): ``_score_core_wh`` (the default,
WhatsHap's published scoring) and ``_score_core``.  Chains are batched
per (padded shape, allele count, weighted) group on a written-out chain
axis.  With ``data_shards`` > 1 and enough devices, a chain's pair
matrix is scored in row blocks over a mesh (``_score_rows_core[_wh]``,
``dist/step.sharded_score_pairs``); every unsharded call is the block of
all rows.

The JAX package computes these matmuls at ``Precision.HIGHEST``; the
port runs them in true float32 (``device.set_true_fp32``: no TF32), and
returns float64 like the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ahsoka_tpu_torch.config import PhasingConfig
from ahsoka_tpu_torch.dist.mesh import DATA_AXIS, gated_mesh, local_devices
from ahsoka_tpu_torch.dist.step import sharded_score_pairs
from ahsoka_tpu_torch.score.pairwise import (_EPS_CLIP, AlleleMatrix,
                                       estimate_error_rate)
from ahsoka_tpu_torch.utils import substage
from ahsoka_tpu_torch.device import set_true_fp32
from ahsoka_tpu_torch.state import to_torch


def _bmm_t(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[C, R, P] x [C, R', P] -> [C, R, R'] (a @ b^T per chain)."""
    return torch.matmul(a, b.transpose(1, 2))


def _allele_counts(onehots, mult):
    """[C, P, A] per-position allele counts (row-weighted by ``mult``
    [C, R] when given; counts are integers, exact in float32)."""
    if mult is None:
        return torch.stack([oh.sum(dim=1) for oh in onehots], dim=2)
    return torch.stack([(oh * mult[:, :, None]).sum(dim=1)
                        for oh in onehots], dim=2)


def _masks(alleles, num_alleles: int):
    """(covered mask, one-hot per allele) of int alleles, float32."""
    return ((alleles >= 0).to(torch.float32),
            [(alleles == a).to(torch.float32) for a in range(num_alleles)])


def _row_eye(rows: int, full: int, row0: int, device) -> torch.Tensor:
    """[rows, full] diagonal of the row block starting at global row
    ``row0``."""
    r = torch.arange(rows, device=device)[:, None] + row0
    return r == torch.arange(full, device=device)[None, :]


def _finish(scores, overlap, min_overlap: int, row0: int):
    scores = torch.where(overlap < min_overlap, torch.zeros_like(scores),
                         scores)
    eye = _row_eye(scores.shape[1], scores.shape[2], row0, scores.device)
    return torch.where(eye, torch.zeros_like(scores), scores)


def _score_rows_core(rows, full, eps, row0, *, num_alleles: int,
                     ploidy: int, min_overlap: int, mult=None):
    """"fresh" mode (score/device.py:129-168) for the [C, Rb, R] row block
    whose global rows start at ``row0``: [C, Rb, P] and [C, R, P] int
    alleles (-1 uncovered and padding), eps [C] -> float32.  The
    per-position statistics come from the full matrix (row-weighted by
    ``mult`` [C, R] when given), so the rows of a block are the rows of
    the whole matrix; ``_score_core`` is the block of every row."""
    mask_f, oh_f = _masks(full, num_alleles)
    mask_r, oh_r = (mask_f, oh_f) if rows is full \
        else _masks(rows, num_alleles)
    eps = eps[:, None]
    d_same = torch.clamp(2.0 * eps * (1.0 - eps), _EPS_CLIP,
                         0.5 - _EPS_CLIP)                     # [C, 1]
    counts = _allele_counts(oh_f, mult)                       # [C, P, A]
    totals = torch.clamp(counts.sum(dim=2), min=1.0)
    freqs = counts / totals[:, :, None]
    k = ploidy
    het = (1.0 - (freqs ** 2).sum(dim=2)) * (k / max(k - 1, 1))
    het = torch.clamp(het, _EPS_CLIP, 1.0 - _EPS_CLIP)
    d_diff = torch.clamp(het * (1.0 - d_same) + (1.0 - het) * d_same,
                         _EPS_CLIP, 1.0 - _EPS_CLIP)
    w_agree = torch.log((1.0 - d_same) / (1.0 - d_diff))      # [C, P]
    w_dis = torch.log(d_same / d_diff)
    scores = _bmm_t(mask_r * w_dis[:, None, :], mask_f)
    diff_w = (w_agree - w_dis)[:, None, :]
    for o_r, o_f in zip(oh_r, oh_f):
        scores = scores + _bmm_t(o_r * diff_w, o_f)
    overlap = _bmm_t(mask_r, mask_f)
    return _finish(scores, overlap, min_overlap, row0)


def _score_rows_core_wh(rows, full, p_s, row0, *, num_alleles: int,
                        ploidy: int, min_overlap: int, mult=None):
    """WhatsHap scoring (score/device.py:171-217) for the [C, Rb, R] row
    block at global row ``row0``; the contract of ``_score_rows_core``,
    with the estimated p_s [C] as the scalar."""
    mask_f, oh_f = _masks(full, num_alleles)
    mask_r, oh_r = (mask_f, oh_f) if rows is full \
        else _masks(rows, num_alleles)
    counts = _allele_counts(oh_f, mult)                       # [C, P, A]

    # greedy ML allocation of `ploidy` haplotype slots to alleles; argmax
    # keeps the first maximum, like jnp.argmax
    c = torch.zeros_like(counts)
    neg_inf = torch.tensor(-float("inf"), dtype=counts.dtype,
                           device=counts.device)
    for _ in range(ploidy):
        grown = counts * torch.log1p(1.0 / torch.clamp(c, min=1.0))
        eligible0 = (c == 0) & (counts > 0)
        gain = torch.where(eligible0.any(dim=2, keepdim=True),
                           torch.where(eligible0, counts, neg_inf), grown)
        best = torch.argmax(gain, dim=2)
        c = c + torch.nn.functional.one_hot(
            best, num_alleles).to(counts.dtype)
    if ploidy >= 2:
        same = (c * (c - 1.0)).sum(dim=2) / (ploidy * (ploidy - 1.0))
        differ = torch.clamp(1.0 - same, 0.0, 1.0)            # [C, P]
    else:
        differ = torch.zeros(counts.shape[:2], dtype=torch.float32,
                             device=counts.device)
    ps = p_s[:, None]
    pd = differ * (1.0 - ps) + (1.0 - differ) * ps

    overlap = _bmm_t(mask_r, mask_f)
    agree = torch.zeros_like(overlap)
    for o_r, o_f in zip(oh_r, oh_f):
        agree = agree + _bmm_t(o_r, o_f)
    pd_sum = _bmm_t(mask_r * pd[:, None, :], mask_f)

    ps = p_s[:, None, None]
    ov = torch.clamp(overlap, min=1.0)
    p_d = torch.clamp(torch.maximum(pd_sum / ov, ps), max=1.0 - _EPS_CLIP)
    d = overlap - agree
    scores = (d * torch.log(ps / p_d)
              + agree * torch.log((1.0 - ps) / (1.0 - p_d)))
    return _finish(scores, overlap, min_overlap, row0)


def _score_core(alleles, eps, *, num_alleles: int, ploidy: int,
                min_overlap: int, mult=None):
    """[C, R, P] int alleles (-1 uncovered and padding), eps [C] ->
    [C, R, R] float32 ("fresh" mode, score/device.py:26-69)."""
    return _score_rows_core(alleles, alleles, eps, 0,
                            num_alleles=num_alleles, ploidy=ploidy,
                            min_overlap=min_overlap, mult=mult)


def _score_core_wh(alleles, p_s, *, num_alleles: int, ploidy: int,
                   min_overlap: int, mult=None):
    """[C, R, P] int alleles (-1 uncovered and padding), p_s [C] ->
    [C, R, R] float32 (WhatsHap scoring, score/device.py:72-126)."""
    return _score_rows_core_wh(alleles, alleles, p_s, 0,
                               num_alleles=num_alleles, ploidy=ploidy,
                               min_overlap=min_overlap, mult=mult)


def _padded_alleles(matrix: AlleleMatrix) -> np.ndarray:
    """int16 [R_pad, P_pad], -1 for uncovered and padding; power-of-two
    buckets so chains of similar size batch together."""
    R, P = matrix.alleles.shape
    R_pad = 64
    while R_pad < R:
        R_pad *= 2
    P_pad = 128
    while P_pad < P:
        P_pad *= 2
    alleles = np.full((R_pad, P_pad), -1, dtype=np.int16)
    alleles[:R, :P] = matrix.alleles
    return alleles


def _padded_mult(mult: np.ndarray, R_pad: int) -> np.ndarray:
    out = np.zeros(R_pad, dtype=np.float32)
    out[:len(mult)] = mult
    return out


def _chain_eps(matrix: AlleleMatrix, config: PhasingConfig,
               error_rate=None) -> float:
    if error_rate is not None:
        return error_rate
    return (estimate_error_rate(matrix, config)
            if config.estimate_error_rate else config.error_rate)


def _chain_scalar(matrix: AlleleMatrix, config: PhasingConfig,
                  error_rate=None, mult=None) -> float:
    """The per-chain scalar the active mode takes: eps for "fresh", the
    estimated p_s for "whatshap" (both host-estimated, numpy)."""
    if config.score_mode == "whatshap":
        from ahsoka_tpu_torch.score.whatshap import chain_p_s
        return chain_p_s(matrix, config, error_rate, mult=mult)
    if mult is not None and error_rate is None \
            and config.estimate_error_rate:
        return estimate_error_rate(matrix, config, mult=mult)
    return _chain_eps(matrix, config, error_rate)


def _core(config: PhasingConfig):
    return _score_core_wh if config.score_mode == "whatshap" else _score_core


def _row_mesh(config: PhasingConfig, R_pad: int, mult, devices,
              dev: torch.device):
    """The row-sharded scoring's mesh, or None when the JAX package's
    gate (score/device.py:318-328) falls back: too few devices, R_pad not
    a multiple of the shard count, or row weights (collapsed matrices
    score unsharded)."""
    shards = max(int(getattr(config, "data_shards", 1)), 1)
    reason = None
    if mult is not None:
        reason = "row-weighted (collapsed) matrix"
    elif R_pad % shards:
        reason = f"{R_pad} padded rows"
    return gated_mesh(shards, DATA_AXIS, local_devices(devices, dev), dev,
                      "scoring", reason=reason)


def score_pairs_device(matrix: AlleleMatrix, config: PhasingConfig,
                       error_rate=None, mult=None, device="cuda",
                       devices=None) -> np.ndarray:
    """One chain's [R, R] float64 pair scores (batch of one).  With
    ``config.data_shards`` > 1 and the gate passed, the pair matrix's row
    blocks are scored over the mesh (``dist.step.sharded_score_pairs``)."""
    dev = torch.device(device)
    scalar = _chain_scalar(matrix, config, error_rate, mult=mult)
    padded = _padded_alleles(matrix)
    R = matrix.alleles.shape[0]
    mesh = _row_mesh(config, padded.shape[0], mult, devices, dev)
    if mesh is not None:
        out = sharded_score_pairs(mesh, padded, scalar,
                                  num_alleles=max(matrix.num_alleles, 2),
                                  ploidy=config.ploidy,
                                  min_overlap=config.min_overlap,
                                  mode=config.score_mode)
        return out[:R, :R].cpu().numpy().astype(np.float64)
    return _score_batch([padded], [scalar],
                        None if mult is None else [mult], [R],
                        max(matrix.num_alleles, 2), config, dev)[0]


def _score_batch(padded, scalars, mults, rows, num_alleles: int,
                 config: PhasingConfig, dev: torch.device):
    R_pad = padded[0].shape[0]
    if dev.type == "cuda":
        set_true_fp32()
    stacked = np.stack(padded)
    arrays = [stacked, np.asarray(scalars, dtype=np.float32)]
    if mults is not None:
        arrays.append(np.stack([_padded_mult(m, R_pad) for m in mults]))
    tensors = to_torch(*arrays, device=dev)
    alleles, eps_t = tensors[:2]
    mult_t = tensors[2] if mults is not None else None
    out = _core(config)(alleles, eps_t, num_alleles=num_alleles,
                        ploidy=config.ploidy,
                        min_overlap=config.min_overlap, mult=mult_t)
    R_max = max(rows)
    host = out[:, :R_max, :R_max].cpu().numpy()
    return [host[j, :R, :R].astype(np.float64) for j, R in enumerate(rows)]


# device working-set budget of one batched scoring call
_BATCH_DEVICE_BYTES = 1 << 30


def score_pairs_device_many(matrices, config: PhasingConfig, mults=None,
                            device="cuda", devices=None):
    """Score MANY chains in few device calls: grouped by padded shape,
    allele count and weighting, one batched call per group (split by a
    device working-set budget).  Same values as per-chain
    ``score_pairs_device``.  ``mults`` is an optional per-chain list of
    row-multiplicity vectors (None entries = unweighted).  Row-sharded
    scoring keeps the per-chain path (its shards own the device axis;
    score/device.py:363-370 of the JAX package)."""
    dev = torch.device(device)
    if mults is None:
        mults = [None] * len(matrices)
    if gated_mesh(getattr(config, "data_shards", 1), DATA_AXIS,
                  local_devices(devices, dev), dev, "scoring") is not None:
        return [score_pairs_device(m, config, mult=mu, device=dev,
                                   devices=devices)
                for m, mu in zip(matrices, mults)]
    with substage.timed("scoring.pack"):
        padded = [_padded_alleles(m) for m in matrices]
    with substage.timed("scoring.host_stats"):
        eps = [_chain_scalar(m, config, mult=mu)
               for m, mu in zip(matrices, mults)]
    groups: dict = {}
    for idx, (a, m) in enumerate(zip(padded, matrices)):
        groups.setdefault((a.shape, max(m.num_alleles, 2),
                           mults[idx] is not None), []).append(idx)
    results = [None] * len(matrices)
    for ((R_pad, P_pad), num_alleles, weighted), idxs in groups.items():
        per_chain = (4 * R_pad * P_pad * (num_alleles + 3)
                     + 4 * 8 * R_pad * R_pad)
        cap = max(1, _BATCH_DEVICE_BYTES // per_chain)
        for lo in range(0, len(idxs), cap):
            batch = idxs[lo:lo + cap]
            with substage.timed("scoring.device"):
                outs = _score_batch(
                    [padded[i] for i in batch], [eps[i] for i in batch],
                    [mults[i] for i in batch] if weighted else None,
                    [matrices[i].alleles.shape[0] for i in batch],
                    num_alleles, config, dev)
            for i, o in zip(batch, outs):
                results[i] = o
    return results
