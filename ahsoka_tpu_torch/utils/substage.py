"""Sub-stage wall-clock attribution for the batched device pre-passes.

Without it, config4's scoring stage (133.6 s against a few seconds of
device FLOPs on a TPU) was one opaque number.  The batched pre-passes now attribute their wall to named sub-stages through
this collector; phase_all_chains_batched drains it into
``stage_seconds["substages"]`` so -metrics.json self-carries the split:

- ``scoring.host_stats``  — per-chain p_s / eps estimation (numpy)
- ``scoring.pack``        — padding + host stacking
- ``scoring.device``      — kernel dispatch + device->host fetch
- ``projection.pack`` / ``projection.device`` — same for projection

Thread-safe: timed() sections run inside the --threads host worker pool
(banded scoring, COO fetches), and the get-then-set accumulation is not
atomic under the GIL — a lock guards every read-modify-write.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict

_MARKS: Dict[str, float] = {}
_LOCK = threading.Lock()


def add(key: str, seconds: float) -> None:
    with _LOCK:
        _MARKS[key] = _MARKS.get(key, 0.0) + seconds


@contextmanager
def timed(key: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        add(key, time.perf_counter() - t0)


def drain() -> Dict[str, float]:
    """Return accumulated marks and reset the collector."""
    with _LOCK:
        out = {k: round(v, 4) for k, v in _MARKS.items()}
        _MARKS.clear()
    return out
