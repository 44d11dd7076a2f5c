"""Digests of a phasing run's result files, and the JAX package's
reference digests of the end-to-end configurations.

``run_digests(outstem)`` hashes the files a run writes beside its outstem
(the aggregate ``-result.txt``, ``-bubbleinfo.txt`` and every
``-chain<id>-result.txt``, the set of ``dist/sim.output_names``), so two
runs on different machines can be compared without moving the files.
``ahsoka_tpu_torch/data/jax_reference.json`` holds these digests for
the JAX package's CPU runs of the configurations named there, written by
``tools/jax_reference.py``; ``load_reference`` reads it.  No torch here.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Dict, List, Optional

REFERENCE_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data",
    "jax_reference.json")

# the configurations with a reference entry, in the order they are run
REFERENCE_CONFIGS = ("config4s", "config3c", "mixed", "config5s", "config2")


def reference_spec(name: str):
    """The ``SynthSpec`` of a reference configuration."""
    from ahsoka_tpu_torch.utils.synth import CONFIGS, MIXED

    return MIXED if name == "mixed" else CONFIGS[name]


def file_digest(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for block in iter(lambda: fh.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def run_digests(outstem: str) -> dict:
    """{"result": sha256, "bubbleinfo": sha256, "chains": {chain id (str):
    sha256}} of the run at ``outstem``; a missing aggregate file raises."""
    d, base = os.path.split(outstem)
    head, tail = f"{base}-chain", "-result.txt"
    chains = {}
    for name in os.listdir(d or "."):
        cid = name[len(head):-len(tail)]
        if name.startswith(head) and name.endswith(tail) and cid.isdigit():
            chains[cid] = file_digest(os.path.join(d, name))
    return {"result": file_digest(f"{outstem}-result.txt"),
            "bubbleinfo": file_digest(f"{outstem}-bubbleinfo.txt"),
            "chains": dict(sorted(chains.items(), key=lambda kv: int(kv[0])))}


def compare_digests(ref: dict, got: dict) -> dict:
    """How ``got`` differs from ``ref``: {"files": the aggregate files
    ("result", "bubbleinfo") whose digests differ, "chains": the chain ids
    (int, ascending) whose file differs or is missing from ``got``,
    "extra": chain ids ``got`` has and ``ref`` lacks}."""
    files = [k for k in ("result", "bubbleinfo") if ref[k] != got.get(k)]
    theirs = got.get("chains", {})
    chains = sorted(int(c) for c, h in ref["chains"].items()
                    if theirs.get(c) != h)
    extra = sorted(int(c) for c in theirs if c not in ref["chains"])
    return {"files": files, "chains": chains, "extra": extra}


def config_fields(config) -> Dict[str, object]:
    """The fields of a ``PhasingConfig`` (either package's) that differ
    from their defaults, without ``ploidy_map`` (kept apart, its keys are
    ints) and ``threads`` (the results do not depend on it)."""
    out = {}
    for f in dataclasses.fields(config):
        if f.name in ("ploidy_map", "threads"):
            continue
        default = (f.default if f.default is not dataclasses.MISSING
                   else f.default_factory()
                   if f.default_factory is not dataclasses.MISSING
                   else None)
        value = getattr(config, f.name)
        if value != default:
            out[f.name] = list(value) if isinstance(value, tuple) else value
    return out


def ploidy_map_json(pmap: Optional[dict]) -> Optional[Dict[str, int]]:
    if pmap is None:
        return None
    return {str(c): int(k) for c, k in sorted(pmap.items())}


def spec_fields(spec) -> dict:
    """A ``SynthSpec`` as JSON (tuples become lists)."""
    return json.loads(json.dumps(dataclasses.asdict(spec)))


def load_reference(path: str = REFERENCE_PATH) -> dict:
    with open(path) as fh:
        return json.load(fh)


def allowed_chains(entry: dict) -> List[int]:
    return sorted(int(a["chain"]) for a in entry.get("allowed", []))
