"""What a process has loaded of the reference packages.

The port keeps its own copy of every host module it runs (configuration,
parsers, bubbles and allele paths, readsets, collapsing, coverage cap,
scoring statistics, cluster editing, DP inputs, emission, synthetic
inputs and planted-truth accuracy), under the JAX package's module names,
so it loads neither jax nor anything of ``ahsoka_tpu``.
"""


def loaded_reference_modules(modules) -> list:
    """Names in ``modules`` (e.g. sys.modules) that are jax or jaxlib, or
    ``ahsoka_tpu`` and its submodules."""
    return sorted(m for m in modules
                  if m in ("jax", "jaxlib", "ahsoka_tpu")
                  or m.startswith(("jax.", "jaxlib.", "ahsoka_tpu.")))
