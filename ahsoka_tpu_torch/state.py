"""numpy state -> the port's tensors.

The engine has no learned weights.  Everything both packages compute on
is numpy: ``PhasingConfig`` scalars, ``DPInputs`` (candidates, coverage,
consensus, genotypes), ``ChainDeviceInputs`` (path one-hots, alignment
node tables), ``AlleleMatrix`` (int16 alleles) and the DP state tables
``full_state_counts`` / ``full_state_validity``.  ``to_torch`` is the
only conversion there is: there is no weight converter to look for.

The dtype policy is the one ``jnp.asarray`` applies with 64-bit types
disabled, so that the same numpy input reaches both packages as the same
values:

    bool -> bool          int8 / int16 / int32 -> unchanged
    int64 / uint -> int32 float16 / float32 / float64 -> float32

e.g. int32 candidates, float32 coverage and genotypes (genotypes are
converted by the caller with ``astype(np.float32)`` as in the JAX
package), int16 alleles, int8 path one-hots.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_KEEP = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
}


def _torch_dtype(dtype) -> torch.dtype:
    dtype = np.dtype(dtype)
    if dtype in _KEEP:
        return _KEEP[dtype]
    if dtype.kind in "iu":
        return torch.int32
    if dtype.kind == "f":
        return torch.float32
    raise TypeError(f"no tensor dtype for numpy {dtype}")


def to_torch(*arrays, device) -> Tuple[torch.Tensor, ...]:
    """Each numpy array (or scalar) -> a contiguous tensor on ``device``
    with the dtype policy above.  Returns a tuple, one tensor per input."""
    out = []
    for a in arrays:
        a = np.asarray(a)
        dt = _torch_dtype(a.dtype)
        t = torch.from_numpy(np.ascontiguousarray(a))
        out.append(t.to(device=device, dtype=dt, non_blocking=False))
    return tuple(out)
