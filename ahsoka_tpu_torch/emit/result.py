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
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, TextIO, Tuple

from ahsoka_tpu_torch.io.gfa import GfaGraph


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


def emit_chain_result(graph: GfaGraph,
                      chain_id: int,
                      hap_cluster_path: Sequence[Tuple[int, ...]],
                      consensus_by_cluster: Sequence[Dict[int, int]],
                      dense_positions: Sequence[int],
                      bubble_paths: Dict[int, List[List[int]]],
                      ploidy: int,
                      outstem: str,
                      full_output: Optional[TextIO]) -> List[List[int]]:
    """Write the per-chain result file and append to the aggregate file.

    Returns the per-haplotype consensus-allele sequences (the reference's
    ``haps``, printed to stdout at src/alignmentstoreadset.cpp:479-486).
    """
    haps: List[List[int]] = []
    with open(f"{outstem}-chain{chain_id}-result.txt", "w") as resfile:
        for i in range(ploidy):
            hap_alleles: List[int] = []
            hap_node_paths: List[Sequence[int]] = []
            for j in range(len(hap_cluster_path)):
                c_id = hap_cluster_path[j][i]
                cons = consensus_by_cluster[j].get(c_id, 0)
                hap_alleles.append(cons)
                hap_node_paths.append(
                    bubble_paths[dense_positions[j]][cons])
            haps.append(hap_alleles)
            line = haplotype_walk_line(graph, hap_node_paths)
            if full_output is not None:
                full_output.write(f"haplotype {i}:\n")
                full_output.write(line + "\n")
            resfile.write(line + "\n")
    return haps
