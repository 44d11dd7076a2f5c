"""Diploid threading-DP kernels: CUDA on the card, plain PyTorch on the CPU.

Counterpart of ``ahsoka_tpu/ops/minplus_diploid.py``.  The TPU version
lays 1024 chains over an [8, 128] vreg ("superblock") and streams
position blocks through VMEM; that layout is a TPU artefact and is not
part of this interface.  Here the public layout is the JAX package's
``[C, P, X]``, for any chain count C and any position count P:

    minplus_forward_diploid(candidates [C, P, 4] int32,
                            node_costs [C, P, 10] float32)
        -> final_costs [C, 10] float32, backptrs [C, P, 10] int32 (bp[:, 0] = 0)
    backtrace_diploid(backptrs [C, P, 10] int32, final_state [C] int32)
        -> states [C, P] int32

A CUDA tensor launches the hand-written kernel of
``csrc/minplus_diploid.cu`` (built at first use) or raises; a CPU tensor
takes the plain version (``*_ref``).  Nothing falls back from one to the
other.  Each wrapper counts its kernel launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from ahsoka_tpu_torch.thread.states import full_state_counts
from ahsoka_tpu_torch.ops import _build
from ahsoka_tpu_torch.ops.minplus import backtrace_ref, minplus_forward_ref

_M = 4                            # 2 * ploidy candidate slots
_S = 10                           # C(4 + 2 - 1, 2) diploid states
_LIB = "minplus_diploid"


def _lib() -> ctypes.CDLL:
    lib = _build.load(_LIB)
    if not getattr(lib, "_ahsoka_typed", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.ahsoka_dp2_forward.argtypes = [vp, vp, vp, vp, ci, ci, cf, cf,
                                           vp]
        lib.ahsoka_dp2_forward.restype = ci
        lib.ahsoka_dp2_backtrace.argtypes = [vp, vp, vp, ci, ci, vp]
        lib.ahsoka_dp2_backtrace.restype = ci
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


def minplus_forward_diploid_ref(candidates: torch.Tensor,
                                node_costs: torch.Tensor, *,
                                switch_cost: float, affine_cost: float):
    """Plain PyTorch diploid forward (the general multiset recurrence at
    ploidy 2)."""
    return minplus_forward_ref(candidates, node_costs, full_state_counts(2),
                               ploidy=2, switch_cost=switch_cost,
                               affine_cost=affine_cost)


def backtrace_diploid_ref(backptrs: torch.Tensor,
                          final_state: torch.Tensor) -> torch.Tensor:
    return backtrace_ref(backptrs, final_state)


def minplus_forward_diploid(candidates: torch.Tensor,
                            node_costs: torch.Tensor, *,
                            switch_cost: float, affine_cost: float):
    """Diploid min-plus forward pass over a chain batch (see module doc)."""
    _check(candidates, "candidates", torch.int32, 3, _M)
    _check(node_costs, "node_costs", torch.float32, 3, _S)
    if candidates.shape[:2] != node_costs.shape[:2]:
        raise ValueError(f"candidates {tuple(candidates.shape)} and "
                         f"node_costs {tuple(node_costs.shape)} disagree")
    if _route(candidates, node_costs) == "cpu":
        return minplus_forward_diploid_ref(
            candidates, node_costs, switch_cost=switch_cost,
            affine_cost=affine_cost)
    C, P, _ = candidates.shape
    dev = candidates.device
    if C == 0 or P == 0:
        return (torch.zeros((C, _S), dtype=torch.float32, device=dev),
                torch.zeros((C, P, _S), dtype=torch.int32, device=dev))
    lib = _lib()
    with torch.cuda.device(dev):
        cand_t = candidates.permute(1, 2, 0).contiguous()    # [P, 4, C]
        node_t = node_costs.permute(1, 2, 0).contiguous()    # [P, 10, C]
        bp_t = torch.empty((P, _S, C), dtype=torch.int32, device=dev)
        fin_t = torch.empty((_S, C), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ahsoka_dp2_forward(
            cand_t.data_ptr(), node_t.data_ptr(), bp_t.data_ptr(),
            fin_t.data_ptr(), C, P, float(switch_cost), float(affine_cost),
            stream)
        _check_launch(lib, err, "dp2_forward")
        minplus_forward_diploid.launches += 1
        return (fin_t.t().contiguous(),
                bp_t.permute(2, 0, 1).contiguous())


minplus_forward_diploid.launches = 0


def backtrace_diploid(backptrs: torch.Tensor,
                      final_state: torch.Tensor) -> torch.Tensor:
    """states [C, P] from backpointers and the final state of each chain."""
    _check(backptrs, "backptrs", torch.int32, 3, _S)
    _check(final_state, "final_state", torch.int32, 1)
    if final_state.shape[0] != backptrs.shape[0]:
        raise ValueError(f"final_state {tuple(final_state.shape)} does not "
                         f"match backptrs {tuple(backptrs.shape)}")
    if _route(backptrs, final_state) == "cpu":
        return backtrace_diploid_ref(backptrs, final_state)
    C, P, _ = backptrs.shape
    dev = backptrs.device
    if C == 0 or P == 0:
        return torch.zeros((C, P), dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        bp_t = backptrs.permute(1, 2, 0).contiguous()        # [P, 10, C]
        st_t = torch.empty((P, C), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ahsoka_dp2_backtrace(bp_t.data_ptr(),
                                       final_state.data_ptr(),
                                       st_t.data_ptr(), C, P, stream)
        _check_launch(lib, err, "dp2_backtrace")
        backtrace_diploid.launches += 1
        return st_t.t().contiguous()


backtrace_diploid.launches = 0
