"""General-ploidy threading-DP kernels: CUDA on the card, plain PyTorch on
the CPU.

Counterpart of ``ahsoka_tpu/ops/minplus_stream.py`` (and of the
VMEM-resident ``ahsoka_tpu/ops/minplus.py``, which computes the same
function).  The TPU versions lay 128 chains over the lanes and pad the
position axis to a multiple of their VMEM block; neither is part of this
interface.  For any chain count C and position count P, at ploidy k with
M = 2k candidate slots and S = C(3k-1, k) states:

    minplus_forward_streamed(candidates [C, P, M] int32,
                             node_costs [C, P, S] float32,
                             counts_table [S, M], *, ploidy, switch_cost,
                             affine_cost)
        -> final_costs [C, S] float32, backptrs [C, P, S] int32 (bp[:, 0] = 0)
    backtrace_streamed(backptrs [C, P, S] int32, final_state [C] int32)
        -> states [C, P] int32

Exactly P positions run: the XLA scan's semantics (``dp_forward_core``),
without the constant-cost block-padding positions the streamed Pallas
wrapper appends.  A CUDA tensor launches the hand-written kernel of
``csrc/minplus_stream.cu`` (built at first use) or raises; a CPU tensor
takes the plain version (``ops/minplus.py``).  Nothing falls back from one
to the other.  Each wrapper counts its kernel launches in
``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ahsoka_tpu_torch.ops import _build
from ahsoka_tpu_torch.ops.minplus import backtrace_ref, minplus_forward_ref
from ahsoka_tpu_torch.ops.minplus_diploid import (_check, _check_launch,
                                                  _route)

_LIB = "minplus_stream"
MAX_PLOIDY = 5                   # the build instantiates M = 2, 4, ..., 10


def _lib() -> ctypes.CDLL:
    lib = _build.load(_LIB)
    if not getattr(lib, "_ahsoka_typed", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.ahsoka_dpk_forward.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci,
                                           ci, cf, cf, vp]
        lib.ahsoka_dpk_forward.restype = ci
        lib.ahsoka_dpk_backtrace.argtypes = [vp, vp, vp, ci, ci, ci, vp]
        lib.ahsoka_dpk_backtrace.restype = ci
        lib.ahsoka_cuda_error_string.argtypes = [ci]
        lib.ahsoka_cuda_error_string.restype = ctypes.c_char_p
        lib._ahsoka_typed = True
    return lib


def packed_counts(counts_table) -> np.ndarray:
    """[S, M] slot counts -> [S, ceil(M/4)] int32 words, four counts to a
    word as little-endian bytes (the kernel's shared-memory table)."""
    counts = np.asarray(counts_table)
    S, M = counts.shape
    if counts.min(initial=0) < 0 or counts.max(initial=0) > 255:
        raise ValueError("slot counts must lie in 0..255")
    W = (M + 3) // 4
    as_bytes = np.zeros((S, 4 * W), dtype=np.uint8)
    as_bytes[:, :M] = counts
    return as_bytes.view("<i4")


def minplus_forward_streamed(candidates: torch.Tensor,
                             node_costs: torch.Tensor, counts_table, *,
                             ploidy: int, switch_cost: float,
                             affine_cost: float):
    """General-ploidy min-plus forward pass over a chain batch (see the
    module doc)."""
    M = 2 * ploidy
    _check(candidates, "candidates", torch.int32, 3, M)
    _check(node_costs, "node_costs", torch.float32, 3)
    if candidates.shape[:2] != node_costs.shape[:2]:
        raise ValueError(f"candidates {tuple(candidates.shape)} and "
                         f"node_costs {tuple(node_costs.shape)} disagree")
    counts = np.asarray(counts_table.cpu() if torch.is_tensor(counts_table)
                        else counts_table)
    S = node_costs.shape[2]
    if counts.shape != (S, M):
        raise ValueError(f"counts table {counts.shape} does not match "
                         f"S={S}, M={M}")
    if _route(candidates, node_costs) == "cpu":
        return minplus_forward_ref(candidates, node_costs, counts,
                                   ploidy=ploidy, switch_cost=switch_cost,
                                   affine_cost=affine_cost)
    if not 1 <= ploidy <= MAX_PLOIDY:
        raise ValueError(f"the CUDA kernel takes ploidy 1..{MAX_PLOIDY}, "
                         f"got {ploidy}")
    C, P, _ = candidates.shape
    dev = candidates.device
    if C == 0 or P == 0:
        return (torch.zeros((C, S), dtype=torch.float32, device=dev),
                torch.zeros((C, P, S), dtype=torch.int32, device=dev))
    lib = _lib()
    with torch.cuda.device(dev):
        table = torch.from_numpy(packed_counts(counts)).to(dev)
        bp = torch.empty((C, P, S), dtype=torch.int32, device=dev)
        fin = torch.empty((C, S), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ahsoka_dpk_forward(
            candidates.data_ptr(), node_costs.data_ptr(), table.data_ptr(),
            bp.data_ptr(), fin.data_ptr(), C, P, S, M, ploidy,
            float(switch_cost), float(affine_cost), stream)
        _check_launch(lib, err, "dpk_forward")
        minplus_forward_streamed.launches += 1
        return fin, bp


minplus_forward_streamed.launches = 0


def backtrace_streamed(backptrs: torch.Tensor,
                       final_state: torch.Tensor) -> torch.Tensor:
    """states [C, P] from backpointers and the final state of each chain."""
    _check(backptrs, "backptrs", torch.int32, 3)
    _check(final_state, "final_state", torch.int32, 1)
    if final_state.shape[0] != backptrs.shape[0]:
        raise ValueError(f"final_state {tuple(final_state.shape)} does not "
                         f"match backptrs {tuple(backptrs.shape)}")
    if _route(backptrs, final_state) == "cpu":
        return backtrace_ref(backptrs, final_state)
    C, P, S = backptrs.shape
    dev = backptrs.device
    if C == 0 or P == 0:
        return torch.zeros((C, P), dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        states = torch.empty((C, P), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ahsoka_dpk_backtrace(backptrs.data_ptr(),
                                       final_state.data_ptr(),
                                       states.data_ptr(), C, P, S, stream)
        _check_launch(lib, err, "dpk_backtrace")
        backtrace_streamed.launches += 1
        return states


backtrace_streamed.launches = 0
