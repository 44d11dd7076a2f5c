"""Allele-path enumeration per bubble.

Each source->sink path through a bubble is one allele; the allele index is
the enumeration order.  Behavior matched (not ported) from
src/chainstoreadset.cpp:

- A *simple* bubble (exactly 2 inner nodes) yields one path
  ``[source, inner_i, sink]`` per inner node (src/chainstoreadset.cpp:17-30).
- Any other bubble is enumerated by DFS starting at the *sink*
  (src/chainstoreadset.cpp:84-116): the travel orientation is chosen so that
  the sink's children stay inside the bubble ('-' adjacency is tried first);
  the DFS (``addSequence``, src/chainstoreadset.cpp:44-82) deduplicates nodes
  within a path, truncates to the branching prefix on each fork, and emits a
  path whenever a node has no children or any child leaves the bubble.
  Complex-bubble paths are therefore in sink->...->source order, and we keep
  that order (projection treats paths as node *sets*, and emission walks
  consecutive pairs in stored order, so the orientation must match).

The reference stamps ``Node.allele`` on a by-value Graph copy
(src/chainstoreadset.cpp:161), so those stamps are lost; we do not reproduce
that dead effect.
"""

from __future__ import annotations

from typing import Dict, List

from ahsoka_tpu_torch.graph.structures import Bubble, BubbleIndex
from ahsoka_tpu_torch.io.gfa import GfaGraph

# pathToAlleles[chain_id][bubble_id] -> list of allele paths (allele = index)
AllelePathTable = Dict[int, Dict[int, List[List[int]]]]


def enumerate_allele_paths(graph: GfaGraph, index: BubbleIndex
                           ) -> AllelePathTable:
    """Build {chain_id -> {bubble_id -> [allele node paths]}}
    (the reference's ``ChainsToReadsetDetailed``,
    src/chainstoreadset.cpp:161-203)."""
    table: AllelePathTable = {}
    for chain in index.chains:
        per_bubble: Dict[int, List[List[int]]] = {}
        for bubble in chain.bubbles:
            if len(bubble.inner) == 2:
                per_bubble[bubble.id] = _paths_simple(bubble)
            else:
                per_bubble[bubble.id] = _paths_complex(graph, bubble)
        table[chain.id] = per_bubble
    return table


def _paths_simple(bubble: Bubble) -> List[List[int]]:
    return [[bubble.source, inner, bubble.sink] for inner in bubble.inner]


def _paths_complex(graph: GfaGraph, bubble: Bubble) -> List[List[int]]:
    members = set(bubble.node_ids())
    # Direction convention in this enumeration (opposite flag encoding from
    # the bubble sweep): plus_dir=True walks '+' adjacency.  The reference
    # uses '-' adjacency unless the sink's '-' children leave the bubble
    # (src/chainstoreadset.cpp:87-105).
    minus_children = graph.edges.get((bubble.sink, False), [])
    minus_within = all(c_id in members for c_id, _ in minus_children)
    plus_dir = not minus_within

    paths: List[List[int]] = []
    _dfs(graph, bubble.sink, plus_dir, members, [], paths)
    if paths == [[bubble.sink]]:
        # Degenerate direction pick (e.g. the sink has no '-' adjacency at a
        # chain end): the reference emits the single-node path [sink], which
        # later trips undefined behavior in its partial containment check.
        # We instead retry the opposite direction — the fix the reference
        # keeps commented out at src/chainstoreadset.cpp:110-114.
        retry: List[List[int]] = []
        _dfs(graph, bubble.sink, not plus_dir, members, [], retry)
        if retry != [[bubble.sink]]:
            paths = retry
    return paths


def _dfs(graph: GfaGraph, node: int, plus_dir: bool, members: set,
         prefix: List[int], paths: List[List[int]]) -> None:
    """The reference's ``addSequence`` (src/chainstoreadset.cpp:44-82),
    iterative over an explicit stack to keep recursion depth flat."""
    stack = [(node, plus_dir, prefix)]
    while stack:
        node, plus_dir, seq = stack.pop()
        if node not in seq:
            seq = seq + [node]
        children = graph.edges.get((node, plus_dir), [])
        within = all(c_id in members for c_id, _ in children)
        if children and within:
            idx = seq.index(node)
            branch_prefix = seq[:idx + 1]
            # reference recurses in adjacency order; an explicit LIFO stack
            # visits in reverse, so push reversed to preserve emission order
            for c_id, c_plus in reversed(children):
                stack.append((c_id, c_plus, branch_prefix))
        else:
            paths.append(seq)
