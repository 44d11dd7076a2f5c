"""Haplotype emission: cluster path -> consensus allele -> oriented node walk
-> result files.

Behavior matched from src/alignmentstoreadset.cpp:411-487:

- For haplotype i and dense position j: cluster ``c = path[j][i]``, consensus
  allele ``cons = consensus[j][c]``, allele node path
  ``pathToAlleles[chain][position_j][cons]``.
- Walk consecutive node pairs of each allele path (the last node of each
  path is never printed — the loop stops at size-1); per haplotype a node is
  printed at most once (``usednodes``); orientation comes from the first
  oriented edge found between the pair, '+' orientation of the first node
  tried first (Graph::getEdge, src/graph.cpp:251-261).
- Output: ``node(+|-),`` entries, one line per haplotype, written to both
  the per-chain ``-chain<id>-result.txt`` and (with ``haplotype i:``
  headers) the aggregate ``-result.txt``.

Frozen copy of ``ahsoka_tpu_torch/emit/result.py``, returning the lines
instead of writing the files.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from .gfa import GfaGraph


class EmissionError(RuntimeError):
    pass


def haplotype_walk_line(graph: GfaGraph,
                        allele_paths: Sequence[Sequence[int]]) -> str:
    """One haplotype's ``node(d),`` line from its per-position allele node
    paths."""
    used: set = set()
    parts: List[str] = []
    for node_path in allele_paths:
        for idx in range(len(node_path) - 1):
            single, nxt = node_path[idx], node_path[idx + 1]
            if single in used:
                continue
            edge = graph.get_edge(single, nxt)
            if edge is None:
                raise EmissionError(
                    f"no oriented edge between consecutive allele-path "
                    f"nodes {single} and {nxt}")
            (fid, fplus), _ = edge
            parts.append(f"{single}({'+' if fplus else '-'}),")
            used.add(single)
    return "".join(parts)


def chain_result_lines(graph: GfaGraph,
                       hap_cluster_path: Sequence[Tuple[int, ...]],
                       consensus_by_cluster: Sequence[Dict[int, int]],
                       dense_positions: Sequence[int],
                       bubble_paths: Dict[int, List[List[int]]],
                       ploidy: int) -> List[str]:
    """The lines of a chain's ``-chain<id>-result.txt``, one a haplotype
    (the aggregate ``-result.txt`` repeats them under ``haplotype i:``)."""
    lines: List[str] = []
    for i in range(ploidy):
        hap_node_paths: List[Sequence[int]] = []
        for j in range(len(hap_cluster_path)):
            cons = consensus_by_cluster[j].get(hap_cluster_path[j][i], 0)
            hap_node_paths.append(bubble_paths[dense_positions[j]][cons])
        lines.append(haplotype_walk_line(graph, hap_node_paths) + "\n")
    return lines
