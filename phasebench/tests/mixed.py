"""The test-local mixed-ploidy cell (``cells/``: BASELINE config 5's
chain plan, a planted ploidy map, the beam DP at ploidy 6, a fixed
warm-up job), and a cut of it that a CPU test can hold."""

import json
import os

from phasebench.run import make_cell

CELLS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cells")
# a seed whose job 0 draws chains of ploidy 2, 4 and 6 in the tiny plan
TINY_SEED = 2 ** 31 + 977


def _read(name):
    with open(os.path.join(CELLS, name + ".json")) as fh:
        return json.load(fh)


def mixed_cell() -> dict:
    return make_cell(_read("mixed-genome.slice"), _read("mixed-genome"))


def tiny_mixed_cell(beam_width: int = 256, banded_threshold: int = 150
                    ) -> dict:
    """Four ragged chains a job (10-40 bubbles, ploidy 2, 4 and 6 at
    TINY_SEED's job 0), the beam at ``beam_width`` (< 12,376, the state
    space of ploidy 6), chains above ``banded_threshold`` effective rows
    banded; a fixed warm-up job of three short chains and one job,
    every chain of it checked."""
    work, config = _read("mixed-genome.slice"), _read("mixed-genome")
    config["plan"] = dict(config["plan"], num_chains=4, max_bubbles=40,
                          ploidy_mix={"2": 0.5, "4": 0.3, "6": 0.2})
    config["settings"] = dict(config["settings"], dp_beam_width=beam_width,
                              banded_scoring_threshold=banded_threshold)
    work.update(pool_jobs=1, check=dict(jobs=1, first_jobs=1, chains=4),
                warmup_job={"chains": [[12, 2], [12, 4], [10, 6]]})
    return make_cell(work, config)
