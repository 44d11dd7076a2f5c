"""Accuracy scoring of phased output against a planted truth.

The synthetic generators (utils/synth.py) plant one haplotype per branch
per bubble and write a ``.truth`` side file (``chain hap node,node,...``
— the branch node chosen by haplotype ``hap`` at every bubble of every
synthetic chain).  The reference pipeline's only notion of truth is its
own output (emission semantics, src/alignmentstoreadset.cpp:411-487);
with the reference binary unbuildable (BASELINE.md), planted-truth
accuracy is the stand-in correctness column for every recorded perf run:
this module reads the emitted per-chain result
files back and computes

- switch error rate: per phased bubble the best assignment of emitted
  haplotypes to truth haplotypes; count assignment changes between
  consecutive phased bubbles, over all chains (standard phasing metric);
- hamming divergence: min over haplotype permutations (global per chain)
  of the fraction of (bubble, haplotype) branch calls differing from
  truth;
- phased fraction: bubbles with a complete ploidy-way call / planted
  bubbles.

Branch node ids are unique per (chain, bubble, haplotype) by
construction, so parsing node ids out of the emitted walk lines
identifies every call without re-running any pipeline stage; chain
detection order/direction does not matter because bubbles are keyed by
the planted node ids.
"""

from __future__ import annotations

import glob
import itertools
import re
from typing import Dict, List, Tuple

import numpy as np

_NODE_RE = re.compile(r"(\d+)\([+-]\)")


def load_truth(truth_path: str) -> Dict[int, Tuple[int, int, int]]:
    """``.truth`` file -> {branch_node_id: (chain, bubble, haplotype)}."""
    info: Dict[int, Tuple[int, int, int]] = {}
    with open(truth_path) as fh:
        for line in fh:
            parts = line.split()
            if len(parts) != 3:
                continue
            c, h = int(parts[0]), int(parts[1])
            for b, node in enumerate(parts[2].split(",")):
                info[int(node)] = (c, b, h)
    return info


def _parse_result_file(path: str) -> List[List[int]]:
    """Per-haplotype node-id lists from a ``-chain<id>-result.txt``."""
    haps = []
    with open(path) as fh:
        for line in fh:
            haps.append([int(m) for m in _NODE_RE.findall(line)])
    return haps


def _switches(chosen: np.ndarray) -> Tuple[int, int]:
    """(switch count, comparable position pairs) for one chain's phased
    [P, k] branch-call matrix where truth hap of column i is simply i
    (branch h == haplotype h by construction)."""
    P, k = chosen.shape
    perms = list(itertools.permutations(range(k)))
    truth_row = np.arange(k)
    pairings = []
    for j in range(P):
        best, bperm = None, None
        for perm in perms:
            err = int(np.sum(chosen[j, list(perm)] != truth_row))
            if best is None or err < best:
                best, bperm = err, perm
        pairings.append(bperm)
    switches = sum(1 for j in range(1, P)
                   if pairings[j] != pairings[j - 1])
    return switches, max(P - 1, 0)


def _hamming(chosen: np.ndarray) -> Tuple[int, int]:
    """(min-permutation mismatch count, cells) for one chain."""
    P, k = chosen.shape
    truth_row = np.arange(k)
    best = P * k
    for perm in itertools.permutations(range(k)):
        best = min(best, int(np.sum(chosen[:, list(perm)]
                                    != truth_row[None, :])))
    return best, P * k


def ploidy_map_from_truth(allele_paths, truth_path: str
                          ) -> Dict[int, int]:
    """Engine-chain-id -> planted ploidy, by matching each engine
    chain's branch nodes against the truth table.

    For benchmarking mixed-ploidy synthetics (config 5): a real user
    assigns per-chain ploidies after inspecting ``only-bubbles`` output
    (the same two-step workflow the reference's subcommands imply);
    here the planted truth plays that role."""
    info = load_truth(truth_path)
    planted_k: Dict[int, int] = {}
    for c, _b, h in info.values():
        planted_k[c] = max(planted_k.get(c, 0), h + 1)
    out: Dict[int, int] = {}
    for chain_id, bubbles in allele_paths.items():
        found = None
        for paths in bubbles.values():
            for p in paths:
                for n in p:
                    if n in info:
                        found = info[n][0]
                        break
                if found is not None:
                    break
            if found is not None:
                break
        if found is not None:
            out[chain_id] = planted_k[found]
    return out


def score_phased_output(outstem: str, truth_path: str) -> dict:
    """Score every ``<outstem>-chain*-result.txt`` against the planted
    truth.  Returns the aggregate accuracy dict (see module docstring).
    """
    info = load_truth(truth_path)
    if not info:
        return {"error": "empty truth file"}
    num_chains = max(c for c, _b, _h in info.values()) + 1
    bubbles_of = np.zeros(num_chains, dtype=np.int64)
    # per-chain ploidy: mixed-ploidy truths (config 5) plant different
    # haplotype counts per chain
    ploidy_of = np.zeros(num_chains, dtype=np.int64)
    for c, b, h in info.values():
        bubbles_of[c] = max(bubbles_of[c], b + 1)
        ploidy_of[c] = max(ploidy_of[c], h + 1)

    # chosen[c][b, i] = planted-haplotype index of the branch emitted
    # haplotype i chose at bubble b (-1 = no call)
    chosen = {c: np.full((bubbles_of[c], ploidy_of[c]), -1,
                         dtype=np.int64)
              for c in range(num_chains)}
    files = sorted(glob.glob(f"{outstem}-chain*-result.txt"))
    for path in files:
        haps = _parse_result_file(path)
        for i, nodes in enumerate(haps):
            for node in nodes:
                hit = info.get(node)
                if hit is None:
                    continue                    # anchor node
                c, b, h = hit
                if i < ploidy_of[c]:
                    chosen[c][b, i] = h

    total_sw = total_pairs = 0
    total_ham = total_cells = 0
    phased = planted = 0
    for c in range(num_chains):
        m = chosen[c]
        planted += m.shape[0]
        complete = (m >= 0).all(axis=1)
        phased += int(complete.sum())
        mm = m[complete]
        if mm.shape[0] == 0:
            continue
        sw, pairs = _switches(mm)
        ham, cells = _hamming(mm)
        total_sw += sw
        total_pairs += pairs
        total_ham += ham
        total_cells += cells

    return {
        "truth_chains": num_chains,
        "result_files": len(files),
        "planted_bubbles": int(planted),
        "phased_bubble_frac": round(phased / max(planted, 1), 4),
        "switch_err_vs_truth": round(total_sw / max(total_pairs, 1), 4),
        "hamming_vs_truth": round(total_ham / max(total_cells, 1), 4),
    }
