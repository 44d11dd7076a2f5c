"""Reference-compatibility helpers (deterministic ordering quirks)."""

from ahsoka_tpu_torch.compat.stdmap import (  # noqa: F401
    StdUnorderedMapOrder,
    native_iteration_order,
    std_iteration_order,
)
