"""ahsoka_tpu_torch — the phasing engine on PyTorch and CUDA (NVIDIA Hopper).

A port of the ``phase`` path of ``ahsoka_tpu`` (JAX/Pallas) at ploidy 1-6
to PyTorch, with hand-written CUDA kernels for the threading DP:

    GFA/GAF ──> host parse, bubbles, allele paths     (ahsoka_tpu host layer)
            ──> projection pre-pass                   project/device.py (torch)
            ──> matrix assembly, collapsing           project/matrix.py (numpy)
            ──> pair scoring, dense                   score/device.py   (torch)
                  or banded (large chains)            score/banded.py   (torch)
            ──> cluster editing, dense or sparse      native C++ (shared)
            ──> threading DP                          thread/dp_torch.py
                  diploid forward + backtrace         csrc/minplus_diploid.cu
                  ploidy 1, 3-5                       csrc/minplus_stream.cu
                  beam-pruned (ploidy 6)              thread/dp_beam.py (torch)
            ──> emission                              (ahsoka_tpu host layer)

The host modules of ``ahsoka_tpu`` that never load jax (parsers, graph,
readsets, cluster editing, emission, synthetic inputs) are shared by
import, not copied; ``host.py`` names that boundary.  Nothing in this
package imports jax.
"""

__version__ = "0.1.0"
