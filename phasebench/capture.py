"""What the timed path produced, per chain, for the comparison.

The program writes its result files and returns its chains' allele
paths and DP inputs and paths (``PipelineArtifacts``), but not the
stages between: the capped allele matrix, the collapse, the pair scores
(a banded chain's band edges) and the clusters.  ``Capture.install``
wraps the program's stage functions by name so that, in the jobs it is
told to record, each chain's stage outputs are kept by reference (no
copy, no device sync).
The wrappers stay in place in every job of a run, recorded or not, so
every job takes the same path.  A stage function that is no longer
there raises at set-up: the benchmark then cannot judge the run.

With ``annotate`` set (the traced run), the wrappers and those around
the job's other stages also open a profiler range named
``phasebench.<stage>``, by which the trace's idle gaps are labelled.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Dict, Optional


class ChainRecord:
    __slots__ = ("matrix", "collapse", "scores", "weights", "clusters",
                 "dp", "banded", "edges")

    def __init__(self):
        self.matrix = self.collapse = self.scores = self.weights = None
        self.clusters = self.dp = self.edges = None
        self.banded = False


class Capture:
    def __init__(self):
        self.recording = False
        self.annotate = False
        self.chains: Dict[int, ChainRecord] = {}
        self._lock = threading.Lock()
        self._by_matrix: Dict[int, int] = {}
        self._local = threading.local()
        self._undo = []

    def start(self, record: bool) -> None:
        self.recording = record
        self.chains = {}
        self._by_matrix = {}

    def _chain(self, cid: int) -> ChainRecord:
        with self._lock:
            return self.chains.setdefault(cid, ChainRecord())

    def _current(self) -> Optional[ChainRecord]:
        cid = getattr(self._local, "chain", None)
        return None if cid is None else self._chain(cid)

    def _range(self, name: str):
        if not self.annotate:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function("phasebench." + name)

    def _patch(self, module, name, make):
        if not hasattr(module, name):
            raise RuntimeError(f"{module.__name__}.{name} is gone: the "
                               "benchmark cannot record this stage")
        orig = getattr(module, name)
        # the wrapper carries the original's attributes (a CUDA launch
        # counter such as ``score_pairs_banded.launches``, which the
        # program increments through the module's name)
        setattr(module, name, functools.update_wrapper(make(orig), orig))
        self._undo.append((module, name, orig))

    def install(self) -> None:
        from ahsoka_tpu_torch import phase, pipeline
        from ahsoka_tpu_torch.cluster import _native_ce
        from ahsoka_tpu_torch.score import banded as score_banded
        from ahsoka_tpu_torch.score import device as score_device
        from ahsoka_tpu_torch.thread import dp_torch

        cap = self

        def ranged(label):
            def make(orig):
                def wrapped(*a, **kw):
                    with cap._range(label):
                        return orig(*a, **kw)
                return wrapped
            return make

        def matrix_stage(orig):
            def wrapped(chain_id, *a, **kw):
                with cap._range("matrix"):
                    matrix = orig(chain_id, *a, **kw)
                if cap.recording and matrix is not None:
                    cap._chain(chain_id).matrix = matrix
                    with cap._lock:
                        cap._by_matrix[id(matrix)] = chain_id
                return matrix
            return wrapped

        def cluster_dp_stage(orig):
            def wrapped(matrix, config, result, scores=None, **kw):
                if not cap.recording:
                    with cap._range("score_cluster"):
                        return orig(matrix, config, result, scores=scores,
                                    **kw)
                with cap._lock:
                    cid = cap._by_matrix.get(id(matrix))
                cap._local.chain = cid
                try:
                    with cap._range("score_cluster"):
                        dp = orig(matrix, config, result, scores=scores,
                                  **kw)
                finally:
                    cap._local.chain = None
                if cid is not None:
                    rec = cap._chain(cid)
                    if scores is not None:
                        rec.scores = scores
                    rec.dp = dp
                return dp
            return wrapped

        def collapse_stage(orig):
            def wrapped(matrix, *a, **kw):
                cm = orig(matrix, *a, **kw)
                if cap.recording:
                    with cap._lock:
                        cid = cap._by_matrix.get(id(matrix))
                    if cid is not None:
                        cap._chain(cid).collapse = cm
                return cm
            return wrapped

        def scorer(orig):
            def wrapped(*a, **kw):
                out = orig(*a, **kw)
                rec = cap._current() if cap.recording else None
                if rec is not None:
                    rec.scores = out
                return out
            return wrapped

        def solver(orig):
            def wrapped(weights, *a, **kw):
                with cap._range("cluster_editing"):
                    out = orig(weights, *a, **kw)
                rec = cap._current() if cap.recording else None
                if rec is not None:
                    rec.weights, rec.clusters = weights, out
                return out
            return wrapped

        def band_scorer(orig):
            def wrapped(*a, **kw):
                out = orig(*a, **kw)
                rec = cap._current() if cap.recording else None
                if rec is not None:
                    rec.banded, rec.edges = True, out
                return out
            return wrapped

        def sparse_solver(orig):
            def wrapped(*a, **kw):
                with cap._range("cluster_editing_sparse"):
                    out = orig(*a, **kw)
                rec = cap._current() if cap.recording else None
                if rec is not None:
                    rec.banded, rec.clusters = True, out
                return out
            return wrapped

        self._patch(phase, "_chain_matrix_stage", matrix_stage)
        self._patch(phase, "_chain_cluster_dp_stage", cluster_dp_stage)
        self._patch(phase, "_chain_collapse", collapse_stage)
        self._patch(phase, "cluster_editing", solver)
        self._patch(score_device, "score_pairs_device", scorer)
        self._patch(_native_ce, "cluster_editing_sparse", sparse_solver)
        self._patch(score_banded, "score_pairs_banded", band_scorer)
        self._patch(pipeline, "prepare_phase_inputs", ranged("parse"))
        self._patch(score_device, "score_pairs_device_many",
                    ranged("score_many"))
        self._patch(dp_torch, "thread_chains_batched", ranged("dp"))

    def uninstall(self) -> None:
        for module, name, orig in reversed(self._undo):
            setattr(module, name, orig)
        self._undo = []
