#!/usr/bin/env python3
"""The JAX package's per-chain reference digests of the end-to-end
configurations, written on the CPU for the port to be held to.

    python tools/jax_reference.py --configs config4s config3c mixed config5s config2
    python tools/jax_reference.py --configs mixed --port     # the port vs the file

For each named configuration (``utils/digest.REFERENCE_CONFIGS``) it
generates the inputs with the port's ``utils/synth.py`` into
``build/jax_reference/<config>/`` and checks that the JAX package's copy
of the generator writes the same bytes.  A mixed-ploidy configuration
gets its ploidy map from the planted truth.  It then phases them with
the JAX package on the CPU at the bench settings of the chip smoke's
end-to-end runs (the port's ``scripts/bench_e2e.bench_settings``: no
readset debug files, coverage cap 64, the balanced prior above ploidy 2,
beam width 2048 where a chain has ploidy 6) on ``--threads`` host
threads, and writes
the configuration's entry of ``ahsoka_tpu_torch/data/jax_reference.json``:
the spec, the settings that differ from ``PhasingConfig``'s defaults,
the ploidy map, ``run_digests`` of the result files, the accuracy
against the planted truth, the versions, the thread count and the
minutes the run took.  Entries of other configurations, and an entry's
``allowed`` list, are kept.

``--port`` phases the same inputs with the port on the CPU instead
(``device="cpu"``) and prints, per configuration, the chains whose file
differs from the entry's (``digest.compare_digests``); it writes nothing
but its outputs under ``build/jax_reference/<config>/port-*``.

Regenerate the file only when ``utils/synth.py`` or the bench settings
change.  The JAX package must run on the CPU here: the tool sets
``jax_platforms`` to ``cpu`` before anything of it is imported.
"""

from __future__ import annotations

import argparse
import dataclasses
import filecmp
import json
import os
import platform
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ahsoka_tpu_torch.scripts.bench_e2e import bench_settings  # noqa: E402
from ahsoka_tpu_torch.utils import digest  # noqa: E402

WORK = os.path.join(ROOT, "build", "jax_reference")


def inputs(name: str, work: str):
    """(gfa, gaf, truth, ploidy map or None) of ``name``, written by the
    port's generator and checked against the JAX package's."""
    from ahsoka_tpu.utils import synth as jsynth

    from ahsoka_tpu_torch.utils.synth import write_synthetic

    spec = digest.reference_spec(name)
    os.makedirs(work, exist_ok=True)
    paths = [os.path.join(work, f"{name}.{x}") for x in ("gfa", "gaf",
                                                          "truth")]
    if not all(os.path.exists(p) for p in paths):
        write_synthetic(*paths[:2], spec, truth_path=paths[2])
    jpaths = [p + ".jax" for p in paths]
    jsynth.write_synthetic(*jpaths[:2], jsynth.SynthSpec(
        **dataclasses.asdict(spec)), truth_path=jpaths[2])
    for p, q in zip(paths, jpaths):
        if not filecmp.cmp(p, q, shallow=False):
            raise AssertionError(f"{name}: the JAX package's generator "
                                 f"writes another {os.path.basename(p)}")
        os.remove(q)
    pmap = None
    if len({k for _, k in spec.plan()}) > 1:
        from ahsoka_tpu.config import PhasingConfig
        from ahsoka_tpu.graph.alleles import enumerate_allele_paths
        from ahsoka_tpu.pipeline import load_graph_and_bubbles
        from ahsoka_tpu.utils.accuracy import ploidy_map_from_truth

        art = load_graph_and_bubbles(paths[0], PhasingConfig())
        pmap = ploidy_map_from_truth(
            enumerate_allele_paths(art.graph, art.index), paths[2])
    return (*paths, pmap)


def jax_entry(name: str, threads: int) -> dict:
    """Phase ``name`` with the JAX package on the CPU -> its entry."""
    import jax
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    from ahsoka_tpu.config import PhasingConfig
    from ahsoka_tpu.pipeline import run_phase
    from ahsoka_tpu.utils.accuracy import score_phased_output

    work = os.path.join(WORK, name)
    gfa, gaf, truth, pmap = inputs(name, work)
    spec = digest.reference_spec(name)
    cfg = PhasingConfig(**bench_settings(spec.ploidy, pmap, threads))
    outstem = os.path.join(work, "jax")
    t0 = time.perf_counter()
    run_phase(gfa, gaf, outstem, config=cfg)
    minutes = (time.perf_counter() - t0) / 60
    return {"spec": digest.spec_fields(spec), "seed": spec.seed,
            "config": digest.config_fields(cfg),
            "ploidy_map": digest.ploidy_map_json(pmap),
            "digests": digest.run_digests(outstem),
            "accuracy_vs_planted_truth": score_phased_output(outstem, truth),
            "versions": {"jax": jax.__version__, "numpy": np.__version__,
                         "python": platform.python_version()},
            "threads": threads, "jax_cpu_minutes": round(minutes, 2)}


def port_check(name: str, entry: dict, threads: int) -> dict:
    """Phase ``name`` with the port on the CPU -> how its files differ
    from ``entry``."""
    from ahsoka_tpu_torch.config import PhasingConfig
    from ahsoka_tpu_torch.pipeline import run_phase

    work = os.path.join(WORK, name)
    gfa, gaf, _truth = (os.path.join(work, f"{name}.{x}")
                        for x in ("gfa", "gaf", "truth"))
    if not os.path.exists(gaf):
        raise FileNotFoundError(f"{gaf}: run the tool without --port first")
    pmap = entry["ploidy_map"]
    pmap = pmap and {int(c): k for c, k in pmap.items()}
    spec = digest.reference_spec(name)
    cfg = PhasingConfig(**bench_settings(spec.ploidy, pmap, threads))
    if digest.config_fields(cfg) != entry["config"]:
        raise AssertionError(f"{name}: the port's settings "
                             f"{digest.config_fields(cfg)} differ from the "
                             f"entry's {entry['config']}")
    outstem = os.path.join(work, "port")
    t0 = time.perf_counter()
    run_phase(gfa, gaf, outstem, cfg, device="cpu")
    diff = digest.compare_digests(entry["digests"],
                                  digest.run_digests(outstem))
    return {"config": name, "chains": len(entry["digests"]["chains"]),
            "differ": diff, "allowed": digest.allowed_chains(entry),
            "port_cpu_minutes": round((time.perf_counter() - t0) / 60, 2)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", nargs="+", default=digest.REFERENCE_CONFIGS,
                    choices=digest.REFERENCE_CONFIGS)
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--out", default=digest.REFERENCE_PATH)
    ap.add_argument("--port", action="store_true",
                    help="phase with the port on the CPU and compare with "
                         "the file instead of writing it")
    args = ap.parse_args(argv)
    ref = digest.load_reference(args.out) if os.path.exists(args.out) else {}
    if args.port:
        import torch

        # the ``--threads`` workers phase chains in parallel; intra-op
        # threads on top of them oversubscribe the cores (as in the tests)
        torch.set_num_threads(1)
        for name in args.configs:
            print(json.dumps(port_check(name, ref[name], args.threads)),
                  flush=True)
        return 0
    for name in args.configs:
        entry = jax_entry(name, args.threads)
        if "allowed" in ref.get(name, {}):
            entry["allowed"] = ref[name]["allowed"]
        ref[name] = entry
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(ref, fh, indent=1, sort_keys=True)
            fh.write("\n")
        print(json.dumps({"config": name, "chains": len(
            entry["digests"]["chains"]), "minutes": entry["jax_cpu_minutes"],
            "accuracy": entry["accuracy_vs_planted_truth"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
