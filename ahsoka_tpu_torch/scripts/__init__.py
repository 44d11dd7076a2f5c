"""The port's benches and study tools, run as ``python -m
ahsoka_tpu_torch.scripts.<name>``: ``bench_e2e`` (end-to-end stage
seconds, records/s and planted-truth accuracy), ``roofline`` (the H100's
peaks and the DP's achieved fraction of them), ``quantify_fastpaths`` and
``profile_ce`` (accuracy studies of the fast paths and the cluster-editing
solvers) and ``plot_bubbles`` (bubble-chain statistics)."""

import os

# generated inputs and outputs of the benches: build/ of the checkout
BUILD_BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "bench")
