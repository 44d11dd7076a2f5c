"""Synthetic GFA/GAF generator of the benchmark's jobs.

Frozen copy of ``ahsoka_tpu_torch/utils/synth.py`` (``SynthSpec``,
``write_synthetic`` and, as ``chain_plan``, the rule of ``config5_plan``;
its preset configurations are left out) and of ``load_truth`` and
``ploidy_map_from_truth`` (``ahsoka_tpu_torch/utils/accuracy.py``), so
that a change to the program cannot move the benchmark's inputs.

Produces the workload shapes of BASELINE.md's measurement configs:

- config 2: one bacterial-scale component — a single bubble chain with
  ~10k bubbles and ~50k reads;
- config 4: chr20 scale — many independent chains totalling ~1M GAF
  records.

The graph shape is a linear chain of simple bubbles per component
(anchor -> {ploidy branches} -> anchor -> ...), the shape hifiasm emits
for well-separated haplotypes (the reference's input
format, its README.md:24-26); reads walk one planted haplotype with
per-bubble switch errors at ``error_rate``.  Generation streams to disk
(no per-record objects), so the 1M-record config writes in seconds.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Dict, List, Mapping, Optional, Sequence, Tuple


def seg_name(node_id: int) -> str:
    return f"utg{node_id:06d}l"


@dataclasses.dataclass
class SynthSpec:
    num_chains: int = 1
    bubbles_per_chain: int = 100
    reads_per_hap: int = 100          # per chain, per haplotype
    ploidy: int = 2
    span: int = 3                     # bubbles covered per read
    identity: float = 0.99
    error_rate: float = 0.0           # per-bubble haplotype switch error
    seed: int = 0
    # uneven haplotype coverage: per-haplotype read-count weights
    # (normalised; None = balanced).  Skewed coverage is a divergence
    # regime for the approximate fast paths (coverage capping and the
    # sparse cluster-editing refresh both key on read multiplicity).
    hap_weights: Optional[Sequence[float]] = None
    # explicit per-chain (bubbles, ploidy) plan: overrides num_chains /
    # bubbles_per_chain / ploidy when set — the mixed-ploidy ragged
    # whole-genome shape of BASELINE config 5 (see config5_plan)
    chain_plan: Optional[Sequence[Tuple[int, int]]] = None
    # per-haplotype coverage target: when set, each chain's reads per
    # haplotype = max(1, round(coverage_per_hap * bubbles / span)) so
    # ragged chains get uniform depth instead of uniform read counts
    coverage_per_hap: Optional[float] = None

    def plan(self) -> List[Tuple[int, int]]:
        if self.chain_plan is not None:
            return list(self.chain_plan)
        return [(self.bubbles_per_chain, self.ploidy)] * self.num_chains

    def reads_per_hap_for(self, bubbles: int) -> int:
        if self.coverage_per_hap:
            return max(1, round(self.coverage_per_hap * bubbles
                                / self.span))
        return self.reads_per_hap

    @property
    def total_reads(self) -> int:
        return sum(k * self.reads_per_hap_for(nb)
                   for nb, k in self.plan())

    @property
    def total_bubbles(self) -> int:
        return sum(nb for nb, _k in self.plan())


def _chain_edges(base: int, bubbles: int, arity: int
                 ) -> Tuple[List[Tuple[int, int]], List[List[int]], int]:
    """Edges and per-bubble branch ids for one chain starting at node
    base+1.  Returns (edges as (from,to) '+'/'+' pairs, branches, last node).
    """
    edges: List[Tuple[int, int]] = []
    nid = base + 1
    branches: List[List[int]] = []
    for _ in range(bubbles):
        bids = list(range(nid + 1, nid + 1 + arity))
        nxt = nid + arity + 1
        for b in bids:
            edges.append((nid, b))
            edges.append((b, nxt))
        branches.append(bids)
        nid = nxt
    return edges, branches, nid


def write_synthetic(gfa_path: str, gaf_path: str, spec: SynthSpec,
                    truth_path: Optional[str] = None) -> None:
    """Write a synthetic GFA + GAF pair (and optionally the planted
    haplotype branch table, one ``chain hap node,node,...`` line per
    haplotype) per ``spec``."""
    rng = random.Random(spec.seed)
    gfa = open(gfa_path, "w", buffering=1 << 20)
    gaf = open(gaf_path, "w", buffering=1 << 20)
    truth = open(truth_path, "w") if truth_path else None
    try:
        ridx = 0
        base = 0
        for c, (nb, arity) in enumerate(spec.plan()):
            step = arity + 1
            edges, branches, last = _chain_edges(base, nb, arity)
            for node in range(base + 1, last + 1):
                gfa.write(f"S\t{seg_name(node)}\tACGT\n")
            for a, b in edges:
                gfa.write(f"L\t{seg_name(a)}\t+\t{seg_name(b)}\t+\t0M\n")
            for a, b in edges:
                gfa.write(f"L\t{seg_name(b)}\t-\t{seg_name(a)}\t-\t0M\n")
            haps = [[branches[b][h] for b in range(nb)]
                    for h in range(arity)]
            if truth is not None:
                for h in range(arity):
                    truth.write(f"{c} {h} " +
                                ",".join(map(str, haps[h])) + "\n")
            anchors = [base + 1 + b * step for b in range(nb + 1)]
            rph = spec.reads_per_hap_for(nb)
            if spec.hap_weights is not None \
                    and len(spec.hap_weights) == arity:
                w = [max(float(x), 0.0) for x in spec.hap_weights]
                total = rph * arity
                reads_of = [int(round(total * x / sum(w))) for x in w]
            else:
                reads_of = [rph] * arity
            for h in range(arity):
                hap = haps[h]
                for r in range(reads_of[h]):
                    start_b = rng.randrange(max(1, nb - spec.span + 1)) \
                        if nb > spec.span else 0
                    stop_b = min(start_b + spec.span, nb)
                    parts: List[str] = []
                    for b in range(start_b, stop_b):
                        branch = hap[b]
                        if spec.error_rate and rng.random() < spec.error_rate:
                            branch = branches[b][(h + 1) % arity]
                        parts.append(">" + seg_name(anchors[b]))
                        parts.append(">" + seg_name(branch))
                    parts.append(">" + seg_name(anchors[stop_b]))
                    gaf.write(_gaf_record(f"read{ridx}", "".join(parts),
                                          spec.identity))
                    ridx += 1
            base = last
    finally:
        gfa.close()
        gaf.close()
        if truth is not None:
            truth.close()


def _gaf_record(name: str, pathstr: str, identity: float,
                start: int = 0, end: int = 1000, qlen: int = 1000) -> str:
    """One GAF line in the reference parser's column layout (identity tag
    ``id:f:X`` at column 16, src/alignmentreader.cpp:112-135)."""
    return (f"{name}\t{qlen}\t0\t{qlen}\t+\t{pathstr}\t{end - start}\t"
            f"{start}\t{end}\t100\t{end - start}\t60\ttp:A:P\tcm:i:10\t"
            f"NM:i:0\tid:f:{identity}\n")


def chain_plan(num_chains: int, min_bubbles: int, max_bubbles: int,
               ploidy_mix: Mapping, seed: int) -> List[Tuple[int, int]]:
    """A ragged whole-genome chain plan, (bubbles, ploidy) a chain:
    lengths log-uniform in [min_bubbles, max_bubbles], each chain's
    ploidy drawn by ``ploidy_mix`` (ploidy -> share, the last ploidy in
    ascending order taking what the others leave).  The rule of
    ``config5_plan``, which is ``ploidy_mix`` {2: 0.70, 4: 0.29, 6:
    0.01}; deterministic per seed."""
    mix = sorted((int(k), float(v)) for k, v in ploidy_mix.items())
    rng = random.Random(seed)
    plan: List[Tuple[int, int]] = []
    for _ in range(num_chains):
        nb = int(round(math.exp(rng.uniform(math.log(min_bubbles),
                                            math.log(max_bubbles)))))
        r = rng.random()
        k, edge = mix[-1][0], 0.0
        for ploidy, share in mix[:-1]:
            edge += share
            if r < edge:
                k = ploidy
                break
        plan.append((nb, k))
    return plan


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


def ploidy_map_from_truth(allele_paths, truth_path: str
                          ) -> Dict[int, int]:
    """Engine-chain-id -> planted ploidy, by matching each engine
    chain's branch nodes against the truth table: what a user assigns
    per chain after reading ``only-bubbles``' output."""
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
