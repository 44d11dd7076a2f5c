#!/usr/bin/env python3
"""Where a position of the forward kernels' time goes, on one CUDA card.

    python3 tools/dpk_forward_ablation.py [--out FILE]

Builds ``ahsoka_tpu_torch/csrc/minplus_stream.cu`` as it is (``base``)
and in variants that switch parts of the per-position work off by text
edits of a copy of the source (one nvcc each, in parallel, into
``build/dpk_ablation/``), then times each with CUDA events at shapes of
``chip_smoke.py`` with the cluster size pinned.  It prints microseconds a
position: the median of 9 calls in ms * 1000 / (P - 1).  Only ``base``
computes the forward pass; it is held exactly against the plain version
on the card.  The variants compute garbage, at the cost of what is left:

- ``noremote``: each CTA stores its new costs into its own buffer only
  (no distributed-shared-memory stores into its peers);
- ``noremote_localbar``: and a CTA barrier in place of the per-position
  cluster barrier (with the remote stores on, a CTA could leave while
  peers still write into it, so ``localbar`` alone is not run);
- ``nomloop``: the m-tile loop (tensor-core products and relaxations)
  skipped at run time, its code and the B build kept;
- ``nomloop_nobbuild``: and the B fragments zero instead of built;
- ``all_off``: all of the above: what is left is the cp.async prefetch,
  the lane reductions, the backpointer and cost stores and the barrier.

The k <= 2 forward (``dpk_forward_warp``) has variants of its own, timed
at k <= 2 shapes (the ones above leave it as it is):

- ``warp_nominplus``: the min-plus step of a position (the loads of the
  staged transition costs, the shuffles of the previous costs, the adds
  and the minimum) switched off; a position is left with the staged node
  cost added to the carry and the backpointer stored.  Its time, times
  P - 1, is the serial floor;
- ``warp_noprep``: the tile's eq bits and transition costs not computed
  (the min-plus step reads whatever the buffer holds);
- ``warp_nostage``: no tile staged (no cp.async copies at all);
- ``warp_all_off``: all three.

The backtrace (``dpk_backtrace``) is timed on random backpointers at
shapes of its own, in ``base`` and in two variants: ``bt_nowalk`` (no
walk of the staged tiles: what is left is staging them and storing the
states) and ``bt_nostage`` (no tile staged: the walk reads buffers zeroed
once).  It prints microseconds a backpointer row, (P - 1) rows a
chain.

The last line is one JSON object: the card's ``nvidia-smi`` name and
power limit, and ``{variant: {shape: us a position}}``.  ``--out`` also
writes it to FILE.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "ahsoka_tpu_torch", "csrc", "minplus_stream.cu")
WORK = os.path.join(ROOT, "build", "dpk_ablation")

# text edits of the source, as (old, new, occurrences); a false run-time
# condition (switch costs are never below -1e38) keeps the m-tile loop's
# code, and with it the B build, which a compile-time false would drop
_NOREMOTE = [("cg::this_cluster().map_shared_rank(cnext, r)[t0 + lc] = v;",
              "cnext[t0 + lc] = v;", 2)]
_LOCALBAR = [("candidate row) visible to every CTA of the cluster\n"
              "    if (G > 1)\n      cg::this_cluster().sync();\n"
              "    else\n      __syncthreads();",
              "candidate row) visible to every CTA of the cluster\n"
              "    __syncthreads();", 1)]
_NOMLOOP = [("if (sp < MT) load_a<K>",
             "if (sp < MT && switch_cost < -1.0e38f) load_a<K>", 1),
            ("for (int mt = sp; mt < MT; mt += SP) {",
             "for (int mt = sp; mt < MT && switch_cost < -1.0e38f; "
             "mt += SP) {", 1)]
_NOBBUILD = [("build_b<K>(cprow, ccrow, counts, t, q, bfr[nt]);",
              "for (int x = 0; x < L::KS; ++x) "
              "bfr[nt][x][0] = bfr[nt][x][1] = 0u * t;", 1)]
_W_NOMINPLUS = [("minplus_step<K>(cost, trans_s + (jj * S + tl) * SP, best, "
                 "bidx);",
                 "best = cost;\n      bidx = 0;", 1)]
_W_NOPREP = [("for (int jj = lane; jj < n; jj += 32) {",
              "for (int jj = lane; jj < n && switch_cost < -1.0e38f; "
              "jj += 32) {", 1),
             ("for (int x = lane; x < n * S; x += 32) {\n"
              "      const int jj = x / S",
              "for (int x = lane; x < n * S && switch_cost < -1.0e38f; "
              "x += 32) {\n      const int jj = x / S", 1)]
_W_NOSTAGE = [("const int j0 = i * T, n = min(T, P - j0), b = i & 1;\n"
               "    stage_async(",
               "const int j0 = i * T, b = i & 1;\n"
               "    const int n = switch_cost < -1.0e38f ? min(T, P - j0) : 0;"
               "\n    stage_async(", 1)]
# no copies, and the buffers zeroed once so that the walk stays in range
_BT_NOSTAGE = [("    if (j1 > jl)\n      stage_async(smem_b",
                "    if (j1 > jl && P < 0)\n      stage_async(smem_b", 1),
               ("  int st = final_state[c];",
                "  for (int x = tid; x < 2 * bw; x += kBtThreads) smem_b[x] = 0;\n"
                "  __syncthreads();\n  int st = final_state[c];", 1)]
_BT_NOWALK = [("if (tid == 0) {\n        const int* row = tile",
               "if (tid == 0 && P < 0) {\n        const int* row = tile", 1),
              ("if (tid < G) {\n        // 16 of the S walks",
               "if (tid < G && P < 0) {\n        // 16 of the S walks", 1),
              ("if (tid == 0) {\n        for (int g = G - 1;",
               "if (tid == 0 && P < 0) {\n        for (int g = G - 1;", 1),
              ("if (tid < G) {\n        int x = seg_in[tid];",
               "if (tid < G && P < 0) {\n        int x = seg_in[tid];", 1)]
BT_VARIANTS = {"bt_nowalk": _BT_NOWALK, "bt_nostage": _BT_NOSTAGE}
# (name, ploidy, chains, positions) of the backtrace's shapes
BT_SHAPES = [("bt_k2_long", 2, 1, 10000), ("bt_k4_long", 4, 1, 2048),
             ("bt_config3c", 4, 20, 256), ("bt_k5_c1", 5, 1, 64),
             ("bt_config4", 2, 1000, 56)]
WARP_VARIANTS = {
    "warp_nominplus": _W_NOMINPLUS,
    "warp_noprep": _W_NOPREP,
    "warp_nostage": _W_NOSTAGE,
    "warp_all_off": _W_NOMINPLUS + _W_NOPREP + _W_NOSTAGE,
}
VARIANTS = {
    "base": [],
    "noremote": _NOREMOTE,
    "noremote_localbar": _NOREMOTE + _LOCALBAR,
    "nomloop": _NOMLOOP,
    "nomloop_nobbuild": _NOMLOOP + _NOBBUILD,
    "all_off": _NOREMOTE + _LOCALBAR + _NOMLOOP + _NOBBUILD,
}
# (name, ploidy, chains, positions, CTAs a chain)
SHAPES = [("tetra_long/G16", 4, 1, 2048, 16),
          ("tetra_long/G8", 4, 1, 2048, 8),
          ("config3c/G4", 4, 20, 256, 4),
          ("k5/G16", 5, 4, 64, 16),
          ("k3_c1/G1", 3, 1, 300, 1),
          ("k4_c300/G1", 4, 300, 56, 1),
          # k <= 2: dpk_forward_warp (one warp a chain)
          ("k2_long/G1", 2, 1, 10000, 1),
          ("k1_long/G1", 1, 1, 10000, 1),
          ("k2_config4/G1", 2, 1000, 56, 1)]
ALL_VARIANTS = {**VARIANTS, **WARP_VARIANTS, **BT_VARIANTS}


def variants_for(k: int):
    """The variants timed at ploidy k: base and those of the kernel that
    runs it."""
    family = WARP_VARIANTS if k <= 2 else VARIANTS
    return ["base"] + [n for n in family if n != "base"]


def variant_source(edits) -> str:
    with open(SRC) as fh:
        text = fh.read()
    for old, new, count in edits:
        if text.count(old) != count:
            raise RuntimeError(f"the source no longer holds {count} x "
                               f"{old!r}: update the variant's edits")
        text = text.replace(old, new)
    return text


def build_all() -> dict:
    """name -> loaded library, one nvcc per variant run at once."""
    from ahsoka_tpu_torch.ops import _build

    os.makedirs(WORK, exist_ok=True)
    procs = {}
    for name, edits in ALL_VARIANTS.items():
        src = os.path.join(WORK, f"{name}.cu")
        with open(src, "w") as fh:
            fh.write(variant_source(edits))
        lib = os.path.join(WORK, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        lib = ctypes.CDLL(path)
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.ahsoka_dpk_forward.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci,
                                           ci, ci, ci, cf, cf, vp]
        lib.ahsoka_dpk_forward.restype = ci
        lib.ahsoka_dpk_backtrace.argtypes = [vp, vp, vp, ci, ci, ci, vp]
        lib.ahsoka_dpk_backtrace.restype = ci
        libs[name] = lib
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON result here")
    args = ap.parse_args(argv)

    from math import comb

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("dpk_forward_ablation: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from ahsoka_tpu_torch.device import card_line
    from ahsoka_tpu_torch.ops import minplus_stream as ms
    from ahsoka_tpu_torch.ops.minplus import (backtrace_ref,
                                              minplus_forward_ref)
    from ahsoka_tpu_torch.thread.states import full_state_counts

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    libs = build_all()
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)
    result = {name: {} for name in ALL_VARIANTS}
    for shape, k, C, P, G in SHAPES:
        counts = full_state_counts(k)
        S = counts.shape[0]
        arrays = cs.random_dp_batch(C, P, seed=cs._seed(k, C, P), ploidy=k)
        cand, node = cs._node_costs(arrays, dev, k)
        planes, packed = ms._device_tables(counts, k, dev)
        bp = torch.empty((C, P, S), dtype=torch.int32, device=dev)
        fin = torch.empty((C, S), dtype=torch.float32, device=dev)
        for name in variants_for(k):
            def run(lib=libs[name], name=name):
                err = lib.ahsoka_dpk_forward(
                    cand.data_ptr(), node.data_ptr(), planes.data_ptr(),
                    packed.data_ptr(), bp.data_ptr(), fin.data_ptr(), C, P,
                    S, 2 * k, G, cs.SWITCH, cs.AFFINE,
                    torch.cuda.current_stream(dev).cuda_stream)
                if err:
                    raise RuntimeError(f"{name} at {shape}: CUDA error {err}")

            if name == "base":
                run()
                fin_r, bp_r = minplus_forward_ref(
                    cand, node, counts, ploidy=k, switch_cost=cs.SWITCH,
                    affine_cost=cs.AFFINE)
                if not (torch.equal(fin, fin_r) and torch.equal(bp, bp_r)):
                    raise AssertionError(f"base != plain at {shape}")
            result[name][shape] = cs._median_ms(run, 9) * 1e3 / (P - 1)
    for shape, k, C, P in BT_SHAPES:
        S = comb(3 * k - 1, k)
        rng = np.random.default_rng(cs._seed(k, C, P))
        bp = torch.from_numpy(rng.integers(0, S, size=(C, P, S),
                                           dtype=np.int32)).to(dev)
        fs = torch.from_numpy(rng.integers(0, S, size=C,
                                           dtype=np.int32)).to(dev)
        st = torch.empty((C, P), dtype=torch.int32, device=dev)
        for name in ["base", *BT_VARIANTS]:
            def run(lib=libs[name], name=name):
                err = lib.ahsoka_dpk_backtrace(
                    bp.data_ptr(), fs.data_ptr(), st.data_ptr(), C, P, S,
                    torch.cuda.current_stream(dev).cuda_stream)
                if err:
                    raise RuntimeError(f"{name} at {shape}: CUDA error {err}")

            if name == "base":
                run()
                if not torch.equal(st, backtrace_ref(bp, fs)):
                    raise AssertionError(f"base != plain at {shape}")
            result[name][shape] = cs._median_ms(run, 9) * 1e3 / (P - 1)
    card = card_line(dev)
    print(card)
    for name, row in result.items():
        if not row:
            continue
        print(f"{name:18s} us a position (row): " + "; ".join(
            f"{shape} {us:.2f}" for shape, us in row.items()))
    line = json.dumps({"card": card, "us_per_position": result})
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
