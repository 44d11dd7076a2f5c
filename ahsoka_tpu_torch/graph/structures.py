"""Bubble / chain data structures (host side).

Mirrors the information content of the reference's Bubble/Chain classes
(src/graph.hpp:71-93) as plain id-based records; node payloads live in
:class:`ahsoka_tpu_torch.io.gfa.GfaGraph`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List


@dataclasses.dataclass
class Bubble:
    source: int
    sink: int
    inner: List[int]          # inner node ids in discovery (pop) order
    id: int = 0

    def node_ids(self) -> List[int]:
        """source, inner..., sink — the order bubbleinfo prints
        (src/graph.cpp:98-105)."""
        return [self.source, *self.inner, self.sink]


@dataclasses.dataclass
class Chain:
    id: int = 0
    bubbles: List[Bubble] = dataclasses.field(default_factory=list)

    def size(self) -> int:
        return len(self.bubbles)


@dataclasses.dataclass
class BubbleIndex:
    """All chains plus the node -> (chain, bubble) stamping.

    ``chain_id_of``/``bubble_id_of`` default to 0 for nodes outside any
    bubble, matching the reference's zero-initialised Node fields
    (src/graph.cpp:27-36) — reads touching such nodes are bucketed into
    chain 0 by the GAF reader, and we reproduce that.
    """

    chains: List[Chain] = dataclasses.field(default_factory=list)
    chain_id_of: Dict[int, int] = dataclasses.field(default_factory=dict)
    bubble_id_of: Dict[int, int] = dataclasses.field(default_factory=dict)

    def chain_of_node(self, node_id: int) -> int:
        return self.chain_id_of.get(node_id, 0)

    def bubble_of_node(self, node_id: int) -> int:
        return self.bubble_id_of.get(node_id, 0)

    def get_chain(self, chain_id: int) -> Chain:
        for chain in self.chains:
            if chain.id == chain_id:
                return chain
        raise KeyError(chain_id)
