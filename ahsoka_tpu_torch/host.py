"""The host layer the port shares with ``ahsoka_tpu``, in one place.

These ``ahsoka_tpu`` modules never load jax (a test holds every port
module to that), so the port imports them instead of forking them:
configuration, GFA/GAF parsing, bubbles and allele paths, readsets,
identical-read collapsing, coverage capping, host-side scoring
statistics, native cluster editing, DP input construction, emission,
synthetic inputs and planted-truth accuracy.  The modules of
``ahsoka_tpu`` that do load jax (``ops``, ``dist``,
``thread/dp_jax.py``, ``thread/dp_pallas.py``, ``project/device.py``,
``project/matrix.py``, ``score/device.py``, ``score/banded.py``) have
their counterparts, where ported, in this package.
"""

from ahsoka_tpu.cluster.postprocess import DPInputs  # noqa: F401
from ahsoka_tpu.config import PhasingConfig  # noqa: F401
from ahsoka_tpu.utils.accuracy import (ploidy_map_from_truth,  # noqa: F401
                                       score_phased_output)
from ahsoka_tpu.utils.synth import (CONFIGS, SynthSpec,  # noqa: F401
                                    write_synthetic)

# ahsoka_tpu modules that load jax: the port may load none of them
JAX_MODULES = ("ahsoka_tpu.ops", "ahsoka_tpu.dist", "ahsoka_tpu.thread.dp_jax",
               "ahsoka_tpu.thread.dp_pallas", "ahsoka_tpu.project.device",
               "ahsoka_tpu.project.matrix", "ahsoka_tpu.score.device",
               "ahsoka_tpu.score.banded", "ahsoka_tpu.utils.xla_cache")


def loaded_jax_modules(modules) -> list:
    """Names in ``modules`` (e.g. sys.modules) that are jax, or an
    ahsoka_tpu module that imports jax."""
    return sorted(m for m in modules
                  if m == "jax" or m.startswith(("jax.", "jaxlib"))
                  or any(m == p or m.startswith(p + ".")
                         for p in JAX_MODULES))
