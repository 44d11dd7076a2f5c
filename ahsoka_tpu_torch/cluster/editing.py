"""Cluster editing of the read-similarity graph.

Role parity: the reference runs WhatsHap's ``ClusterEditingSolver(sim,
false).run()`` (src/alignmentstoreadset.cpp:312-314) — the induced-cost
heuristic (InducedCostHeuristic / EdgeHeap, src/CMakeLists.txt:15-17)
that partitions reads into clusters by making edges permanent (merging)
or forbidden.  The WhatsHap C++ is unavailable here (BASELINE.md), so
two modes are provided:

``mode="whatshap"`` — the induced-cost heuristic's **published decision
rule** (Boecker et al., weighted cluster editing; as shipped in WhatsHap
polyphase).  For every undecided edge (u, v)::

    icf(u,v) = relu(w_uv)  + sum_z relu(min(w_uz, w_vz))
               # induced cost of FORBIDDING: lose the attraction, and
               # every common positive neighbour gives up an attraction
    icp(u,v) = relu(-w_uv) + sum_z [sign conflict] min(|w_uz|, |w_vz|)
               # induced cost of making PERMANENT: overcome the
               # repulsion, and pay the smaller side of each conflict

Each step finds the edge e_f with the maximum icf and the edge e_p with
the maximum icp over all undecided edges; if ``icf(e_f) >= icp(e_p)``
e_f becomes permanent (endpoints merge, weights add, forbidden status
is sticky — the WhatsHap ``-inf + x = -inf``), otherwise e_p becomes
forbidden.  The undecided set is the nonzero edges (WhatsHap's sparse
matrix has no entries for non-overlapping pairs).  When the maximum icf
reaches 0 every undecided edge is repulsive and forbidding the rest is
free, so the loop stops (same clusters as deciding them one by one).
Unpinnable details chosen here: ties take the lexicographically
smallest (u, v); permanent wins the ``icf == icp`` comparison.

``mode="fresh"`` — this repo's own derivation: only *positive*
undecided edges are candidates, the edge with the largest
``max(icf, icp)`` is decided first, and its own icf/icp comparison
picks merge vs forbid.  Kept as a documented alternate.

Both modes run on the host (the heuristic is inherently sequential,
SURVEY.md §7 layer 5) with incrementally maintained neighbour sums;
native C++ (native/cluster_editing.cpp) takes over for large chains,
decision-trace parity-tested against this oracle.
"""

from __future__ import annotations

import itertools
from typing import List

import numpy as np

FORBIDDEN = -1.0e18


def cluster_editing(weights: np.ndarray,
                    prefer_native: bool = True,
                    mode: str = "whatshap") -> List[List[int]]:
    """Partition reads given a symmetric score matrix (diagonal ignored).

    Returns clusters as lists of original read indices, ordered by smallest
    member; members ascending.  Above 64 reads (``prefer_native``) it runs
    the native C++ implementation (native/cluster_editing.cpp, identical
    results — parity-tested; its build raises on failure); the Python
    engine below is the oracle and solves the small instances.
    """
    if mode not in ("whatshap", "fresh"):
        raise ValueError(f"unknown cluster-editing mode: {mode!r}")
    if prefer_native and weights.shape[0] > 64:
        from ahsoka_tpu_torch.cluster._native_ce import (cluster_editing_native,
                                                   cluster_editing_sparse)
        n = weights.shape[0]
        if mode == "fresh":
            iu = np.triu_indices(n, k=1)
            mask = weights[iu] != 0
            density = float(mask.mean()) if mask.size else 0.0
            if n > 1500 or density < 0.15:
                # The read-similarity graph is position-local, so most
                # chains are sparse (reads overlapping in <minOverlap
                # positions score 0 and are absent edges, like WhatsHap's
                # TriangleSparseMatrix) — the fresh greedy's
                # adjacency+lazy-heap solver wins by ~20x there.  The
                # whatshap rule is the opposite: its many forbid
                # decisions churn the lazy heaps (every push recomputes a
                # common-neighbourhood sum), while the dense solver's
                # incrementally-maintained sum matrices make the same
                # decisions ~10x faster (support-pruned deltas), so
                # whatshap mode always takes the dense path here (chains
                # above banded_scoring_threshold never reach this
                # function; they go to score_pairs_banded +
                # cluster_editing_sparse).
                return cluster_editing_sparse(
                    n, iu[0][mask], iu[1][mask], weights[iu][mask],
                    mode=mode)
        return cluster_editing_native(weights, mode=mode)
    return _host_cluster_editing(weights, mode)


class _EditingState:
    """Dense weights + alive/forbidden masks + incrementally maintained
    icf/icp neighbour sums, shared by both decision rules."""

    def __init__(self, weights: np.ndarray):
        n = weights.shape[0]
        self.n = n
        self.W = weights.astype(np.float64).copy()
        np.fill_diagonal(self.W, 0.0)
        self.alive = np.ones(n, dtype=bool)
        self.forb = np.zeros((n, n), dtype=bool)
        self.members: List[List[int]] = [[i] for i in range(n)]
        self.sum_f = np.zeros((n, n))
        self.sum_p = np.zeros((n, n))
        # SumF/SumP include z == u, v: those terms are provably zero for
        # the pair (u, v) itself (min with the zero diagonal), so no
        # exclusion is needed when reading icf/icp off the matrices.
        for z in range(n):
            self.sum_f += self._contrib_f(z)
            self.sum_p += self._contrib_p(z)

    def _contrib_f(self, z: int) -> np.ndarray:
        col = self.W[:, z] * self.alive[z]
        return np.maximum(np.minimum.outer(col, col), 0.0)

    def _contrib_p(self, z: int) -> np.ndarray:
        col = self.W[:, z] * self.alive[z]
        pos, neg = col > 0, col < 0
        conflict = np.logical_or(np.logical_and.outer(pos, neg),
                                 np.logical_and.outer(neg, pos))
        return conflict * np.minimum.outer(np.abs(col), np.abs(col))

    def icf_icp(self):
        icf = np.maximum(self.W, 0.0) + self.sum_f
        icp = np.maximum(-self.W, 0.0) + self.sum_p
        return icf, icp

    def undecided(self, positive_only: bool) -> np.ndarray:
        """Upper-triangle mask of candidate edges."""
        live = self.alive[:, None] & self.alive[None, :]
        cand = (self.W > 0) if positive_only else (
            (self.W != 0) & ~self.forb)
        return np.triu(cand & live, 1)

    def forbid(self, u: int, v: int) -> None:
        old_fu, old_pu = self._contrib_f(u), self._contrib_p(u)
        old_fv, old_pv = self._contrib_f(v), self._contrib_p(v)
        self.W[u, v] = self.W[v, u] = FORBIDDEN
        self.forb[u, v] = self.forb[v, u] = True
        self._update_z(u, old_fu, old_pu)
        self._update_z(v, old_fv, old_pv)

    def _update_z(self, z: int, old_f, old_p) -> None:
        self.sum_f += self._contrib_f(z) - old_f
        self.sum_p += self._contrib_p(z) - old_p

    def merge(self, u: int, v: int) -> None:
        W, alive = self.W, self.alive
        old_fu, old_pu = self._contrib_f(u), self._contrib_p(u)
        old_fv, old_pv = self._contrib_f(v), self._contrib_p(v)
        merged = W[u] + W[v]
        merged[u] = 0.0
        # forbidden is sticky under merging (WhatsHap: -inf + x = -inf)
        fmerged = self.forb[u] | self.forb[v]
        fmerged[u] = False
        merged[fmerged] = FORBIDDEN
        W[u, :] = merged
        W[:, u] = merged
        W[v, :] = 0.0
        W[:, v] = 0.0
        self.forb[u, :] = fmerged
        self.forb[:, u] = fmerged
        alive[v] = False
        self.members[u].extend(self.members[v])
        self.members[v] = []
        # contributions OF columns u and v changed for every pair ...
        self._update_z(u, old_fu, old_pu)
        self._update_z(v, old_fv, old_pv)
        # ... and every pair (u, y) changed through every OTHER column z,
        # because row u of W was rewritten: recompute those sums fresh
        self._recompute_pair_row(u)

    def _recompute_pair_row(self, u: int) -> None:
        """Fresh sum_f/sum_p for all pairs (u, y):
        sum_f[u, y] = sum_z relu(min(W[u, z], W[y, z])) over alive z."""
        Wa = self.W * self.alive[None, :]
        wu = Wa[u]                                # [n]
        f = np.maximum(np.minimum(wu[None, :], Wa), 0.0)   # [n(y), n(z)]
        row_f = f.sum(axis=1)
        conflict = np.logical_or(
            np.logical_and(wu[None, :] > 0, Wa < 0),
            np.logical_and(wu[None, :] < 0, Wa > 0))
        p = conflict * np.minimum(np.abs(wu)[None, :], np.abs(Wa))
        row_p = p.sum(axis=1)
        self.sum_f[u, :] = row_f
        self.sum_f[:, u] = row_f
        self.sum_p[u, :] = row_p
        self.sum_p[:, u] = row_p

    def clusters(self) -> List[List[int]]:
        out = [sorted(self.members[i]) for i in range(self.n)
               if self.alive[i]]
        out.sort(key=lambda c: c[0])
        return out


def _argmax_edge(values: np.ndarray, mask: np.ndarray, n: int):
    """(value, u, v) of the masked maximum; row-major argmax ==
    lexicographically smallest (u, v) on ties."""
    masked = np.where(mask, values, -np.inf)
    flat = int(np.argmax(masked))
    u, v = divmod(flat, n)
    return masked[u, v], u, v


def _host_cluster_editing(weights: np.ndarray, mode: str
                          ) -> List[List[int]]:
    n = weights.shape[0]
    if n == 0:
        return []
    st = _EditingState(weights)
    import os
    trace = os.environ.get("AHSOKA_CE_TRACE")
    while True:
        und = st.undecided(positive_only=(mode == "fresh"))
        if not und.any():
            break
        icf, icp = st.icf_icp()
        if mode == "whatshap":
            m_icf, fu, fv = _argmax_edge(icf, und, n)
            m_icp, pu, pv = _argmax_edge(icp, und, n)
            if m_icf <= 0:
                # only repulsive edges remain: forbidding them (in any
                # order) is what the heuristic would do and cannot
                # change the final clusters — stop early
                break
            do_merge = m_icf >= m_icp
            u, v = (fu, fv) if do_merge else (pu, pv)
            if trace:
                import sys
                print(f"W {u} {v} icf={m_icf:.9g} icp={m_icp:.9g} "
                      f"{'merge' if do_merge else 'forbid'}",
                      file=sys.stderr)
        else:
            _, u, v = _argmax_edge(np.maximum(icf, icp), und, n)
            do_merge = icf[u, v] >= icp[u, v]
        if do_merge:
            st.merge(u, v)
        else:
            st.forbid(u, v)
    return st.clusters()


def assignment_from_clusters(clusters: List[List[int]],
                             num_reads: int) -> np.ndarray:
    """Per read its cluster id, -1 for a read in no cluster (a read in
    several takes the last)."""
    out = np.full(num_reads, -1, dtype=np.int32)
    sizes = [len(c) for c in clusters]
    reads = np.fromiter(itertools.chain.from_iterable(clusters),
                        dtype=np.int64, count=sum(sizes))
    np.maximum.at(out, reads, np.repeat(
        np.arange(len(clusters), dtype=np.int32), sizes))
    return out
