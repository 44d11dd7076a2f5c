"""Least time an NVIDIA H100 could take for the threading DP's kernels.

Frozen copy of ``work`` and ``least_seconds`` (with the peaks) of
``ahsoka_tpu_torch/scripts/roofline.py``, so that a change to the
program cannot move the yardstick.  Peaks of one H100 SXM (NVIDIA's data
sheet, dense): HBM 3.35 TB/s, 67 TFLOP/s float32 on the CUDA cores,
1,979 TOP/s int8 on the tensor cores; they assume the 700 W limit.

Counts per pass at ploidy k on C chains of P positions (M = 2k slots,
S = C(3k-1, k) states, A = 2 alleles): the forward reads candidates [M]
int32 and node costs [S] f32 and writes backpointers [S] int32 a
position, and final costs [S] and the int8 counts table once; an fp32
add and compare a (source, destination) cell and the M k 0/1 products
of its intersection at the int8 rate.  The backtrace reads the P - 1
backpointers its path follows and writes the P states.
"""

from __future__ import annotations

from math import comb

HBM_BYTES_S, FP32_OPS_S, INT8_OPS_S = 3.35e12, 67e12, 1979e12
NUM_ALLELES = 2
FORWARD_KERNELS = ("dpk_forward", "dpk_forward_warp")
BACKTRACE_KERNELS = ("dpk_backtrace",)


def work(kernel: str, k: int, C: int, P: int):
    """(bytes, fp32 operations, int8 operations) of one pass at ploidy k
    on C chains of P positions."""
    M, S, A = 2 * k, comb(3 * k - 1, k), NUM_ALLELES
    if kernel == "node_costs":
        nbytes = 4 * C * P * (3 * M + 1 + A) + S * M + (M + 1) * S \
            + 4 * C * P * S
        return nbytes, C * P * S * (3 * M + 2 * M * A + 3 * A + 4), 0
    if kernel.endswith("backtrace"):
        return 4 * C * (2 * P), 0, 0
    if kernel not in FORWARD_KERNELS:
        raise ValueError(f"unknown pass {kernel!r}")
    cells = C * max(P - 1, 0) * S * S
    nbytes = 4 * C * P * (M + 2 * S) + 4 * C * S + S * M
    return nbytes, 2 * cells, 2 * cells * M * k


def least_seconds(nbytes: float, fp32_ops: float, int8_ops: float):
    """(least seconds the card could take, "bytes" or "operations")."""
    byte_s = nbytes / HBM_BYTES_S
    op_s = fp32_ops / FP32_OPS_S + int8_ops / INT8_OPS_S
    return max(byte_s, op_s), ("bytes" if byte_s >= op_s else "operations")


def chain_dp_least_seconds(k: int, P: int) -> float:
    """Least seconds of one chain's forward and backtrace (C = 1): the
    work its own P positions need, not a padded group's."""
    fwd = "dpk_forward_warp" if k <= 2 else "dpk_forward"
    return sum(least_seconds(*work(p, k, 1, P))[0]
               for p in (fwd, "dpk_backtrace"))
