"""Superbubble / bubble-chain detection.

Re-implements the behavior of the reference's frontier sweep
(src/graph.cpp:333-501) with the same tie-breaking, because chain ids,
bubble ids, and inner-node order all feed the byte-exact output files:

- Chains are discovered by iterating graph nodes in libstdc++
  ``unordered_map`` iteration order (src/graph.cpp:335) — replicated via
  compat/stdmap (or plain insertion order when compat is off).
- From each unvisited node both travel directions are swept (0 == '+'
  adjacency first), appending bubbles to one chain (src/graph.cpp:339-341).
- The frontier ``S`` pops the smallest (node_id, dir) pair — the reference's
  ``std::set<pair<Node,bool>>`` ordering (src/graph.cpp:379-381).
- A child enters the frontier only when all its "parents" (its adjacency in
  the opposite orientation) were popped in the current sweep
  (src/graph.cpp:429-472).
- An edge back to the sweep's start node aborts the bubble
  (src/graph.cpp:417-423); a node without children (tip) ends the sweep
  (src/graph.cpp:396-397).
- When exactly one frontier node and one "seen but unvisited" node remain,
  that node is the sink: a bubble (source, inner in pop order, sink) is
  emitted and the sweep restarts from the sink, chaining bubbles
  (src/graph.cpp:476-497).  A source directly adjacent to its sink (only two
  swept nodes) terminates the chain without emitting (src/graph.cpp:481-482).

The sweep itself is cheap, control-flow-heavy host work on a graph that is
replicated per host in the distributed setup (SURVEY.md §2c); the TPU tensor
programs start downstream at projection.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ahsoka_tpu_torch.graph.structures import Bubble, BubbleIndex, Chain
from ahsoka_tpu_torch.io.gfa import GfaGraph


def find_bubbles(graph: GfaGraph, compat_std_ordering: bool = True,
                 node_order: Optional[Sequence[int]] = None) -> BubbleIndex:
    """Detect all bubble chains and stamp nodes with chain/bubble ids."""
    if node_order is None:
        if compat_std_ordering:
            from ahsoka_tpu_torch.compat import native_iteration_order
            node_order = native_iteration_order(graph.node_order)
        else:
            node_order = list(graph.node_order)

    index = BubbleIndex()
    globally_visited: set = set()
    for start in node_order:
        if start in globally_visited:
            continue
        chain = Chain()
        for direction in (0, 1):
            _sweep_chain(graph, start, direction, chain, globally_visited)
        if chain.bubbles:
            index.chains.append(chain)

    # assign sequential ids and stamp nodes (src/graph.cpp:351-365);
    # later stamps overwrite earlier ones, as in the reference
    for chain_id, chain in enumerate(index.chains):
        chain.id = chain_id
        for bubble_id, bubble in enumerate(chain.bubbles):
            bubble.id = bubble_id
            for node_id in bubble.node_ids():
                index.chain_id_of[node_id] = chain_id
                index.bubble_id_of[node_id] = bubble_id
    return index


def _sweep_chain(graph: GfaGraph, start: int, direction: int, chain: Chain,
                 globally_visited: set) -> None:
    """One ``findBubble`` call chain.  The reference tail-recurses from each
    sink (src/graph.cpp:497); we loop to keep stack depth flat for
    chains with many thousands of bubbles."""
    while True:
        nxt = _sweep_one_bubble(graph, start, direction, chain,
                                globally_visited)
        if nxt is None:
            return
        start, direction = nxt


def _sweep_one_bubble(graph: GfaGraph, start: int, direction: int,
                      chain: Chain, globally_visited: set
                      ) -> Optional[Tuple[int, int]]:
    seen = {(start, direction)}
    visited: set = set()
    inside: List[int] = []          # pop order
    frontier = {(start, direction)}

    while frontier:
        v_id, v_dir = min(frontier)  # set<pair<Node,bool>> pop (graph.cpp:379)
        frontier.remove((v_id, v_dir))
        visited.add(v_id)
        globally_visited.add(v_id)
        inside.append(v_id)
        seen.discard((v_id, v_dir))

        children = graph.out_edges(v_id, v_dir)
        if not children:  # tip ends the sweep (graph.cpp:396-397)
            break

        for u_id, u_plus in children:
            u_dir = 0 if u_plus else 1
            if u_id == start:  # loop back to start aborts (graph.cpp:417-423)
                frontier.clear()
                break
            seen.add((u_id, u_dir))
            parents = graph.in_edges(u_id, u_dir)
            if all(p_id in visited for p_id, _ in parents):
                frontier.add((u_id, u_dir))

        if len(frontier) == 1 and len(seen) == 1:
            t_id, t_dir = next(iter(frontier))
            frontier.clear()
            inside.append(t_id)
            if len(inside) == 2:
                # source directly wired to sink: no bubble, chain ends
                return None
            inside.remove(start)   # first occurrence, like vector::erase+find
            inside.remove(t_id)
            chain.bubbles.append(Bubble(source=start, sink=t_id,
                                        inner=list(inside)))
            return (t_id, t_dir)   # continue the chain from the sink
    return None
