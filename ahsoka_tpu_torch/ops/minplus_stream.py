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
``<wrapper>.launches``, and ``KERNEL_LAUNCHES`` counts them by CUDA
kernel: ``dpk_forward_warp`` (ploidy <= SMALL_PLOIDY: one warp a chain),
``dpk_forward`` (ploidy 3-5) and ``dpk_backtrace`` (every ploidy).  The
diploid wrappers (``ops/minplus_diploid.py``) launch the same kernels.

The host half of the CUDA forward lives here: the int8 0/1 plane table
its tensor cores multiply (``ge_planes``) and the CTAs a chain spreads
over (``choose_cluster``, ``cluster_size``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ahsoka_tpu_torch.ops import _build
from ahsoka_tpu_torch.ops.minplus import backtrace_ref, minplus_forward_ref
from ahsoka_tpu_torch.utils import substage

_LIB = "minplus_stream"
MAX_PLOIDY = 5                   # the build instantiates k = 1..5
CLUSTER_SIZES = (1, 2, 4, 8, 16)  # CTAs a chain may spread over
MIN_CTA_CELLS = 4096             # (source, destination) cells a CTA keeps
SMALL_PLOIDY = 2                 # k <= 2: one warp a chain, CUDA cores
WARP_TILE = 128                  # k <= 2: positions a staged tile (at most;
                                 # smaller when many chains share an SM)
# CUDA launches of each kernel of csrc/minplus_stream.cu
KERNEL_LAUNCHES = {"dpk_forward_warp": 0, "dpk_forward": 0,
                   "dpk_backtrace": 0}


def _lib() -> ctypes.CDLL:
    lib = _build.load(_LIB)
    if not getattr(lib, "_ahsoka_typed", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.ahsoka_dpk_forward.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci,
                                           ci, ci, ci, cf, cf, vp]
        lib.ahsoka_dpk_forward.restype = ci
        lib.ahsoka_dpk_max_clusters.argtypes = [ci, ci, ci,
                                                ctypes.POINTER(ci)]
        lib.ahsoka_dpk_max_clusters.restype = ci
        lib.ahsoka_dpk_backtrace.argtypes = [vp, vp, vp, ci, ci, ci, vp]
        lib.ahsoka_dpk_backtrace.restype = ci
        lib.ahsoka_cuda_error_string.argtypes = [ci]
        lib.ahsoka_cuda_error_string.restype = ctypes.c_char_p
        lib._ahsoka_typed = True
    return lib


def _check_launch(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.ahsoka_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def _check(t: torch.Tensor, name: str, dtype, ndim: int, last=None):
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got "
                         f"{tuple(t.shape)}")
    if last is not None and t.shape[-1] != last:
        raise ValueError(f"{name} needs last dim {last}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _route(*tensors) -> str:
    """'cpu' or 'cuda' for a set of tensors on one device; raises for
    mixed or other devices."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type


def packed_counts(counts_table) -> np.ndarray:
    """[S, M] slot counts -> [S, ceil(M/4)] int32 words, four counts to a
    word as little-endian bytes (the kernel's table for building B)."""
    counts = np.asarray(counts_table)
    S, M = counts.shape
    if counts.min(initial=0) < 0 or counts.max(initial=0) > 255:
        raise ValueError("slot counts must lie in 0..255")
    W = (M + 3) // 4
    as_bytes = np.zeros((S, 4 * W), dtype=np.uint8)
    as_bytes[:, :M] = counts
    return as_bytes.view("<i4")


def plane_bytes(ploidy: int) -> int:
    """Bytes a row of the int8 plane table holds: M*k (slot, threshold)
    pairs padded to the mma depth of 32."""
    return 32 if 2 * ploidy * ploidy <= 32 else 64


def ge_planes(values, ploidy: int) -> np.ndarray:
    """[N, M] slot values in 0..k -> [N, K] int8 0/1 planes with
    ``ge_planes(a) @ ge_planes(b).T == sum_m min(a[:, m], b[:, m])``
    exactly, since min(x, y) = sum_{u=1..k} [x >= u] [y >= u] for
    0 <= x, y <= k.

    Byte kk of a row is the plane of slot mp and threshold u where,
    with i = kk // 16, q = kk % 16 // 4, b = kk % 4, sigma = 4i + b and
    NB = ceil(M / 4): u = sigma // NB + 1 and mp = 4 * (sigma % NB) + q
    (zero where u > k or mp >= M).  That is the order in which a lane of
    mma.m16n8k32 holds its A and B bytes: the kernel's lane q builds the
    bytes of slots q, q+4, q+8 and no others."""
    vals = np.asarray(values)
    if vals.ndim != 2 or vals.shape[1] != 2 * ploidy:
        raise ValueError(f"values {vals.shape} need {2 * ploidy} slots")
    if vals.size and (vals.min() < 0 or vals.max() > ploidy):
        raise ValueError(f"slot values must lie in 0..{ploidy}")
    M, K = 2 * ploidy, plane_bytes(ploidy)
    nb = (M + 3) // 4
    out = np.zeros((vals.shape[0], K), dtype=np.int8)
    for kk in range(K):
        sigma = 4 * (kk // 16) + kk % 4
        u, mp = sigma // nb + 1, 4 * (sigma % nb) + kk % 16 // 4
        if u <= ploidy and mp < M:
            out[:, kk] = vals[:, mp] >= u
    return out


def choose_cluster(C: int, S: int, num_sms: int,
                   max_active: Callable[[int], int]) -> int:
    """CTAs per chain: the largest G in CLUSTER_SIZES such that the C
    clusters of G CTAs fill at most the card's ``num_sms`` SMs, all run at
    once (``max_active(G)`` clusters fit on the card), and each CTA keeps
    at least MIN_CTA_CELLS (source, destination) cells of a position:
    below that a position's fixed latency (barriers, reductions, a few
    microseconds) outweighs what a further split saves.  1 for many-chain
    groups."""
    best = 1
    for g in CLUSTER_SIZES[1:]:
        if S * -(-S // g) < MIN_CTA_CELLS or C * g > num_sms:
            break
        if C <= max_active(g):
            best = g
    return best


@functools.lru_cache(maxsize=None)
def _max_clusters(device_index: int, M: int, S: int, G: int) -> int:
    lib = _lib()
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = lib.ahsoka_dpk_max_clusters(M, S, G, ctypes.byref(out))
    _check_launch(lib, err, f"dpk_forward occupancy (G={G})")
    return out.value


def cluster_size(C: int, S: int, ploidy: int, device) -> int:
    """The CTAs per chain the CUDA forward kernel runs with on ``device``
    (1 at ploidy <= SMALL_PLOIDY, else ``choose_cluster`` with the card's
    SM count and cluster occupancy)."""
    if ploidy <= SMALL_PLOIDY:
        return 1
    dev = torch.device(device)
    return choose_cluster(
        C, S, torch.cuda.get_device_properties(dev).multi_processor_count,
        lambda g: _max_clusters(dev.index or 0, 2 * ploidy, S, g))


_TABLES: Dict[Tuple[str, int, bytes], Tuple[torch.Tensor, torch.Tensor]] = {}


def _device_tables(counts: np.ndarray, ploidy: int, dev: torch.device):
    """(int8 planes [S, K], packed counts [S, W]) on ``dev``, uploaded
    once per device and table."""
    key = (str(dev), ploidy, counts.tobytes())
    if key not in _TABLES:
        _TABLES[key] = (torch.from_numpy(ge_planes(counts, ploidy)).to(dev),
                        torch.from_numpy(packed_counts(counts)).to(dev))
    return _TABLES[key]


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
    if torch.is_tensor(counts_table):
        counts = counts_table.cpu().numpy()
        substage.count("device.round_trips")
        substage.count("device.fetch_bytes", counts.nbytes)
    else:
        counts = np.asarray(counts_table)
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
    G = cluster_size(C, S, ploidy, candidates.device) if C and P else 1
    return _forward(candidates, node_costs, counts, ploidy, G, switch_cost,
                    affine_cost, caller=minplus_forward_streamed)


def _forward(candidates: torch.Tensor, node_costs: torch.Tensor,
             counts: np.ndarray, ploidy: int, G: int, switch_cost: float,
             affine_cost: float, caller=None):
    """The CUDA forward kernel at G CTAs a chain (one of CLUSTER_SIZES; 1
    at ploidy <= SMALL_PLOIDY, where ``dpk_forward_warp`` runs), on
    checked CUDA tensors and the [S, M] counts table.  A launch counts in
    KERNEL_LAUNCHES and in ``caller.launches`` (the public wrapper)."""
    if G not in (CLUSTER_SIZES if ploidy > SMALL_PLOIDY else (1,)):
        raise ValueError(f"ploidy {ploidy} cannot run {G} CTAs a chain")
    if not (candidates.is_cuda and node_costs.is_cuda):
        raise ValueError("the CUDA forward kernel takes CUDA tensors")
    C, P, M = candidates.shape
    S = node_costs.shape[2]
    dev = candidates.device
    if C == 0 or P == 0:
        return (torch.zeros((C, S), dtype=torch.float32, device=dev),
                torch.zeros((C, P, S), dtype=torch.int32, device=dev))
    lib = _lib()
    with torch.cuda.device(dev):
        planes, packed = _device_tables(counts, ploidy, dev)
        bp = torch.empty((C, P, S), dtype=torch.int32, device=dev)
        fin = torch.empty((C, S), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ahsoka_dpk_forward(
            candidates.data_ptr(), node_costs.data_ptr(), planes.data_ptr(),
            packed.data_ptr(), bp.data_ptr(), fin.data_ptr(), C, P, S, M, G,
            float(switch_cost), float(affine_cost), stream)
        kernel = ("dpk_forward_warp" if ploidy <= SMALL_PLOIDY
                  else "dpk_forward")
        _check_launch(lib, err, f"{kernel} (G={G})")
        KERNEL_LAUNCHES[kernel] += 1
        substage.count("dp.kernel_launches")
        if caller is not None:
            caller.launches += 1
        return fin, bp


minplus_forward_streamed.launches = 0


def check_backtrace_args(backptrs: torch.Tensor, final_state: torch.Tensor,
                         S=None) -> str:
    """Check a backtrace's arguments; 'cpu' or 'cuda'."""
    _check(backptrs, "backptrs", torch.int32, 3, S)
    _check(final_state, "final_state", torch.int32, 1)
    if final_state.shape[0] != backptrs.shape[0]:
        raise ValueError(f"final_state {tuple(final_state.shape)} does not "
                         f"match backptrs {tuple(backptrs.shape)}")
    return _route(backptrs, final_state)


def backtrace_streamed(backptrs: torch.Tensor,
                       final_state: torch.Tensor) -> torch.Tensor:
    """states [C, P] from backpointers and the final state of each chain."""
    if check_backtrace_args(backptrs, final_state) == "cpu":
        return backtrace_ref(backptrs, final_state)
    return _backtrace(backptrs, final_state, caller=backtrace_streamed)


backtrace_streamed.launches = 0


def _backtrace(backptrs: torch.Tensor, final_state: torch.Tensor,
               caller) -> torch.Tensor:
    """The CUDA backtrace kernel on checked CUDA tensors (any S); a launch
    counts in KERNEL_LAUNCHES and in ``caller.launches``."""
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
        KERNEL_LAUNCHES["dpk_backtrace"] += 1
        substage.count("dp.kernel_launches")
        caller.launches += 1
        return states
