"""ahsoka_tpu_torch — the phasing engine on PyTorch and CUDA (NVIDIA Hopper).

A port of the default diploid ``phase`` path of ``ahsoka_tpu`` (JAX/Pallas)
to PyTorch, with hand-written CUDA kernels for the threading DP:

    GFA/GAF ──> host parse, bubbles, allele paths     (ahsoka_tpu host layer)
            ──> projection pre-pass                   project/device.py (torch)
            ──> matrix assembly, collapsing           project/matrix.py (numpy)
            ──> dense pair scoring                    score/device.py   (torch)
            ──> cluster editing                       native C++ (shared)
            ──> threading DP                          thread/dp_torch.py
                  diploid forward + backtrace         csrc/minplus_diploid.cu
            ──> emission                              (ahsoka_tpu host layer)

The host modules of ``ahsoka_tpu`` that never load jax (parsers, graph,
readsets, cluster editing, emission, synthetic inputs) are shared by
import, not copied; ``host.py`` names that boundary.  Nothing in this
package imports jax.
"""

__version__ = "0.1.0"
