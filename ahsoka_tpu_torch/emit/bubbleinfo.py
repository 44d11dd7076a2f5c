"""Byte-exact ``-bubbleinfo.txt`` writer.

Format quirks reproduced from src/polyassembly.cpp:95-110: the chain header
has no separator between the id and "size:" (``chain id: 3size: 7``), and
node-id lists end with a trailing comma.
"""

from __future__ import annotations

from typing import TextIO

from ahsoka_tpu_torch.graph.structures import BubbleIndex


def write_bubbleinfo(index: BubbleIndex, out: TextIO) -> None:
    for chain in index.chains:
        out.write(f"chain id: {chain.id}size: {len(chain.bubbles)}\n")
        for bubble in chain.bubbles:
            out.write(f"bubble id: {bubble.id}\n")
            out.write("node id: ")
            for node_id in bubble.node_ids():
                out.write(f"{node_id},")
            out.write("\n")


def write_bubbleinfo_file(index: BubbleIndex, outstem: str) -> str:
    path = f"{outstem}-bubbleinfo.txt"
    with open(path, "w") as fh:
        write_bubbleinfo(index, fh)
    return path
