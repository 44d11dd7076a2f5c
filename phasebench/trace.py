"""Read the profiler's trace of a traced window (Chrome trace JSON)."""

from __future__ import annotations

import json
import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from phasebench import stats

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
WINDOW = "phasebench.window"
JOB = "phasebench.job"


def base_name(name: str) -> str:
    """A kernel's name without its return type, namespaces, template and
    argument lists: ``(anonymous namespace)::dpk_forward(int const*, ...)``
    is ``dpk_forward``."""
    n = name.strip()
    if n.startswith("void "):
        n = n[len("void "):]
    n = n.replace("(anonymous namespace)::", "")
    return re.split(r"[(<]", n, maxsplit=1)[0].split("::")[-1].strip()


class Trace:
    """Device intervals, kernel times by name and host events of the
    traced window, in seconds of the trace's clock."""

    def __init__(self, path: str):
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
        self.device: List[Tuple[float, float]] = []
        self.kernel_s: Dict[str, float] = defaultdict(float)
        self.host: List[Tuple[float, float, str]] = []
        lo = hi = None
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat, ts, dur = ev.get("cat"), ev.get("ts"), ev.get("dur", 0)
            if ts is None:
                continue
            s, e = float(ts) * 1e-6, (float(ts) + float(dur)) * 1e-6
            if cat in DEVICE_CATS:
                self.device.append((s, e))
                if cat == "kernel":
                    self.kernel_s[base_name(ev.get("name", ""))] += e - s
            elif cat in HOST_CATS:
                name = ev.get("name", "")
                if name == WINDOW:
                    lo, hi = s, e
                else:
                    self.host.append((s, e, name))
        if lo is None:
            raise RuntimeError(f"no {WINDOW} range in the trace")
        self.lo, self.hi = lo, hi
        self.device = stats.clip(self.device, lo, hi)

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    @property
    def busy_s(self) -> float:
        return stats.covered(self.device)

    def device_ops(self, n: int = 10) -> List[list]:
        top = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:n]
        return [[name, sec] for name, sec in top]

    def _label(self, s: float, e: float) -> str:
        """The host event that overlaps the gap most (the shortest on a
        tie); the job's own range only where nothing inside it does."""
        best: Optional[Tuple[float, float, str]] = None
        for hs, he, name in self.host:
            ov = min(he, e) - max(hs, s)
            if ov <= 0:
                continue
            key = (name != JOB, ov, -(he - hs))
            if best is None or key > best[0]:
                best = (key, name)
        return best[1] if best else "no host event"

    def idle_gaps(self, n: int = 10) -> List[list]:
        gaps = sorted(stats.gaps(self.device, self.lo, self.hi),
                      key=lambda g: g[0] - g[1])[:n]
        return [[self._label(s, e), e - s] for s, e in gaps]
