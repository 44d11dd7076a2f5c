"""The pair scores of a banded chain's edges, plain and in float64.

Above ``banded_scoring_threshold`` effective rows the program scores
only the band of overlapping pairs (``ahsoka_tpu_torch/score/banded.py``)
and hands the sparse edge list (u, v, w) to its native sparse solver.
Its published statistics differ from the dense scoring's in one place:
p_s is estimated on an evenly spaced sample of at most 2,048 rows (the
estimator pairs rows quadratically), p_d per position on every row.
``band_edges`` enumerates the same band itself and works out the
WhatsHap score of each pair from those statistics (``whatshap.py``),
its overlap, agreement and p_d sums as float64 GEMMs over row blocks
against every row, on ``device`` (a card where there is one).  It
imports nothing of the program.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .config import PhasingConfig
from .dp_beam import _no_tf32
from .pairwise import AlleleMatrix
from .whatshap import chain_p_s, finish_scores, position_pd, tf32

# rows of one block: its [block, R] float64 products stay small
_BLOCK = 1024


def row_sample(matrix: AlleleMatrix, sample: int = 2048,
               mult: Optional[np.ndarray] = None
               ) -> Tuple[AlleleMatrix, Optional[np.ndarray]]:
    """At most ``sample`` evenly spaced rows (and their multiplicities)."""
    if matrix.num_reads <= sample:
        return matrix, mult
    idx = np.linspace(0, matrix.num_reads - 1, sample).astype(int)
    sm = AlleleMatrix(alleles=matrix.alleles[idx],
                      positions=matrix.positions,
                      read_names=[matrix.read_names[i] for i in idx])
    return sm, (mult[idx] if mult is not None else None)


def band_edges(matrix: AlleleMatrix, config: PhasingConfig,
               mult: Optional[np.ndarray] = None, device=None,
               gemm: str = "float64"
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The band of ``matrix``'s rows (a collapsed chain's distinct rows,
    with ``mult``) as the edge list (u, v, w): every pair u < v that
    overlaps on ``min_overlap`` positions or more and scores nonzero,
    ascending by (u, v), its score in float64.  ``gemm="tf32"`` sums each
    pair's p_d from TF32 operands in float32
    (``whatshap.score_pairs_whatshap``'s control precision)."""
    import torch

    dev = torch.device("cpu") if device is None else torch.device(device)
    sm, smult = row_sample(matrix, mult=mult)
    p_s = chain_p_s(sm, config, mult=smult)
    pd = position_pd(matrix, config, p_s, mult=mult)
    R = matrix.num_reads
    num_alleles = max(matrix.num_alleles, 2)
    us, vs, ws = [], [], []
    with _no_tf32(torch), torch.no_grad():
        a = torch.as_tensor(matrix.alleles.astype(np.int64), device=dev)
        mask = (a >= 0).to(torch.float64)
        planes = [(a == al).to(torch.float64) for al in range(num_alleles)]
        pdm = mask * torch.as_tensor(pd, dtype=torch.float64, device=dev)
        cols = mask
        if gemm == "tf32":
            pdm = torch.as_tensor(tf32(pdm.cpu().numpy()), device=dev)
            cols = mask.to(torch.float32)
        elif gemm != "float64":
            raise ValueError(f"unknown gemm precision {gemm!r}")
        col = torch.arange(R, device=dev)
        for r0 in range(0, R, _BLOCK):
            blk = slice(r0, min(r0 + _BLOCK, R))
            overlap = mask[blk] @ mask.T
            upper = col[None, :] > col[blk, None]
            u, v = torch.nonzero(upper & (overlap >= config.min_overlap),
                                 as_tuple=True)
            pd_sum = (pdm[blk] @ cols.T)[u, v].to(torch.float64)
            agree = torch.zeros_like(pd_sum)
            for oh in planes:
                agree += (oh[blk] @ oh.T)[u, v]
            w = finish_scores(overlap[u, v].cpu().numpy(),
                              agree.cpu().numpy(), pd_sum.cpu().numpy(),
                              p_s, config.min_overlap)
            keep = w != 0.0
            us.append(u.cpu().numpy()[keep] + r0)
            vs.append(v.cpu().numpy()[keep])
            ws.append(w[keep])
    if not us:
        z = np.zeros(0)
        return z.astype(np.int64), z.astype(np.int64), z
    return (np.concatenate(us).astype(np.int64),
            np.concatenate(vs).astype(np.int64), np.concatenate(ws))
