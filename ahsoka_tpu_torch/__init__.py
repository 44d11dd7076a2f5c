"""ahsoka_tpu_torch — the phasing engine on PyTorch and CUDA (NVIDIA Hopper).

A port of the ``phase`` path of ``ahsoka_tpu`` (JAX/Pallas) at ploidy 1-6
to PyTorch, with hand-written CUDA kernels for the threading DP:

    GFA/GAF ──> host parse, bubbles, allele paths     io/, graph/ (host)
            ──> projection pre-pass                   project/device.py (torch)
            ──> matrix assembly, collapsing           project/matrix.py (numpy)
            ──> pair scoring, dense                   score/device.py   (torch)
                  or banded (large chains)            score/banded.py   (torch)
            ──> cluster editing, dense or sparse      cluster/ (native C++)
            ──> threading DP                          thread/dp_torch.py
                  forward, ploidy 1-2: a warp a chain csrc/minplus_stream.cu
                  forward, ploidy 3-5: CTA clusters   csrc/minplus_stream.cu
                  backtrace, ploidy 1-5               csrc/minplus_stream.cu
                  beam-pruned (ploidy 6)              thread/dp_beam.py (torch)
            ──> emission                              emit/ (host)

The host modules (configuration, parsers, graph, readsets, collapsing,
scoring statistics, cluster editing, emission, synthetic inputs) are this
package's own copies of the JAX package's, under the same module names;
the native helpers they load build from the repository's ``native/``
sources into ``build/ahsoka_tpu_torch/native/``.  Nothing in this package
imports jax or ``ahsoka_tpu``.
"""

__version__ = "0.1.0"
