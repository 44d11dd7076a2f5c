"""GFA assembly-graph parsing into host tables.

Produces the graph model consumed by bubble detection and haplotype emission.
Reference behavior being matched (not ported): src/graph.cpp:188-249.

Semantics reproduced:
- Node ids derive from the segment name by stripping all non-digit characters
  (``utg000013l`` -> 13), src/graph.cpp:161-165.
- ``S <name> <seq>``: registers a node (sequence must be non-empty).
- ``L <from> <+/-> <to> <+/-> <overlap><M|S>``: one *directed* adjacency entry
  keyed by (from_id, from_orient); no implicit reverse edge is added.  The
  CIGAR must be a single match op (``NM``) or ``0S`` (asserted in the
  reference, src/graph.cpp:233).
- Overlap table keyed by the full oriented edge (from_id, from+, to_id, to+).
- Node first-touch order is recorded so chain numbering can replicate the
  reference's ``unordered_map`` iteration order (see compat/stdmap.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

DirectedEdge = Tuple[int, bool]  # (node_id, plus_orientation)


class GfaParseError(ValueError):
    pass


def raw_id(name: str) -> int:
    """Strip all non-digits and parse as int (src/graph.cpp:161-165)."""
    digits = "".join(c for c in name if c.isdigit())
    if not digits:
        raise GfaParseError(f"segment name {name!r} contains no digits")
    return int(digits)


@dataclasses.dataclass
class GfaGraph:
    """Host-side graph tables.

    ``edges[(v, plus)]`` lists out-neighbours ``(u, u_plus)`` for traversing
    node ``v`` in orientation ``plus`` (True == '+'), in L-line file order.
    This single adjacency map serves both the reference's ``edges`` and its
    redundant per-node ``childrenleft``/``childrenright`` lists (they hold
    identical data, src/graph.cpp:237-244).
    """

    node_order: List[int] = dataclasses.field(default_factory=list)
    seq_len: Dict[int, int] = dataclasses.field(default_factory=dict)
    seqs: Optional[Dict[int, str]] = None
    edges: Dict[DirectedEdge, List[DirectedEdge]] = dataclasses.field(
        default_factory=dict)
    offsets: Dict[Tuple[DirectedEdge, DirectedEdge], int] = dataclasses.field(
        default_factory=dict)

    def __post_init__(self) -> None:
        self._touched = set(self.node_order)

    # -- construction ------------------------------------------------------
    def _touch(self, node_id: int) -> None:
        if node_id not in self._touched:
            self._touched.add(node_id)
            self.node_order.append(node_id)

    def add_node(self, node_id: int, seq_len: int, seq: Optional[str]) -> None:
        self._touch(node_id)
        self.seq_len[node_id] = seq_len
        if self.seqs is not None and seq is not None:
            self.seqs[node_id] = seq

    def add_edge(self, from_id: int, from_plus: bool, to_id: int,
                 to_plus: bool, overlap: int) -> None:
        # first-touch order matches the reference parser: from, then to
        # (C++17 sequencing of graph.nodes[start].children...push_back(
        #  make_pair(graph.nodes[end]...)), src/graph.cpp:241-244)
        self._touch(from_id)
        self._touch(to_id)
        frm, to = (from_id, from_plus), (to_id, to_plus)
        self.edges.setdefault(frm, []).append(to)
        self.offsets[(frm, to)] = overlap

    # -- queries -----------------------------------------------------------
    def num_nodes(self) -> int:
        return len(self.node_order)

    def out_edges(self, node_id: int, travel_dir: int) -> List[DirectedEdge]:
        """Out-neighbours when traversing `node_id` with travel direction
        ``travel_dir`` (0 follows '+' adjacency, 1 follows '-', matching the
        reference's childrenleft/childrenright selection at
        src/graph.cpp:391-394)."""
        return self.edges.get((node_id, travel_dir == 0), [])

    def in_edges(self, node_id: int, travel_dir: int) -> List[DirectedEdge]:
        """The reference's "parents" of a node reached with ``travel_dir``:
        its out-adjacency in the opposite orientation (src/graph.cpp:400-409).
        """
        return self.edges.get((node_id, travel_dir != 0), [])

    def get_edge(self, first: int, second: int
                 ) -> Optional[Tuple[DirectedEdge, DirectedEdge]]:
        """First oriented edge first->second, trying '+' then '-' orientation
        of `first` and scanning adjacency in insertion order
        (src/graph.cpp:251-261)."""
        for plus in (True, False):
            for to in self.edges.get((first, plus), []):
                if to[0] == second:
                    return (first, plus), to
        return None


def parse_gfa(path_or_lines, keep_seqs: bool = False,
              strict: bool = True, engine: str = "auto") -> GfaGraph:
    """Parse a GFA file (path or iterable of lines) into a :class:`GfaGraph`.

    With ``strict=True`` an L line referencing a segment with no S record is
    an error.  (The reference would silently default-construct a node whose
    ``node_id`` is 0 in that case — a latent bug we do not reproduce.)

    ``engine="native"`` uses the C++ parser (native/gfa_parser.cpp) for
    file paths when sequences are not needed; "auto" prefers it and falls
    back to the Python parser (which also produces the precise error for
    malformed input)."""
    if (engine in ("auto", "native") and not keep_seqs
            and isinstance(path_or_lines, (str, bytes))):
        graph = _parse_gfa_native(path_or_lines, strict)
        if graph is not None:
            return graph
        if engine == "native":
            raise GfaParseError("native GFA parser unavailable or failed")
    close = False
    if isinstance(path_or_lines, (str, bytes)):
        fh: Iterable[str] = open(path_or_lines, "r")
        close = True
    else:
        fh = path_or_lines
    graph = GfaGraph(seqs={} if keep_seqs else None)
    pending_edges: List[Tuple[int, bool, int, bool, int]] = []
    try:
        for line in fh:
            if not line or line[0] not in "SL":
                continue
            fields = line.split()
            if fields[0] == "S":
                if len(fields) < 3 or not fields[2]:
                    raise GfaParseError(f"malformed S line: {line!r}")
                graph.add_node(raw_id(fields[1]), len(fields[2]),
                               fields[2] if keep_seqs else None)
            elif fields[0] == "L":
                if len(fields) < 6:
                    raise GfaParseError(f"malformed L line: {line!r}")
                _, start, s_or, end, e_or, cigar = fields[:6]
                if s_or not in "+-" or e_or not in "+-":
                    raise GfaParseError(f"bad orientation in L line: {line!r}")
                overlap, op = _parse_overlap(cigar, line)
                start_id, end_id = raw_id(start), raw_id(end)
                graph.add_edge(start_id, s_or == "+", end_id, e_or == "+",
                               overlap)
    finally:
        if close:
            fh.close()  # type: ignore[union-attr]
    del pending_edges
    if strict:
        missing = [nid for nid in graph.node_order
                   if nid not in graph.seq_len]
        if missing:
            raise GfaParseError(
                f"L lines reference segments with no S record: {missing[:5]}"
                f"{'...' if len(missing) > 5 else ''}")
    return graph


def _parse_gfa_native(path, strict: bool) -> Optional[GfaGraph]:
    from ahsoka_tpu_torch.io._native_io import parse_gfa_native

    if isinstance(path, bytes):
        path = path.decode()
    cols = parse_gfa_native(path)
    if cols is None:
        return None
    graph = GfaGraph()
    graph.node_order = [int(x) for x in
                        dict.fromkeys(int(t) for t in cols["touch_order"])]
    graph._touched = set(graph.node_order)
    graph.seq_len = {int(i): int(l) for i, l in
                     zip(cols["seg_ids"], cols["seg_lens"])}
    edges = graph.edges
    offsets = graph.offsets
    for f, t, fp, tp, ov in zip(cols["edge_from"], cols["edge_to"],
                                cols["edge_from_plus"],
                                cols["edge_to_plus"],
                                cols["edge_overlap"]):
        frm = (int(f), bool(fp))
        to = (int(t), bool(tp))
        edges.setdefault(frm, []).append(to)
        offsets[(frm, to)] = int(ov)
    if strict:
        missing = [nid for nid in graph.node_order
                   if nid not in graph.seq_len]
        if missing:
            raise GfaParseError(
                f"L lines reference segments with no S record: "
                f"{missing[:5]}{'...' if len(missing) > 5 else ''}")
    return graph


def _parse_overlap(cigar: str, line: str) -> Tuple[int, int]:
    """Reference reads `int` then one char and asserts 'M' or ('S' and 0)
    (src/graph.cpp:230-234)."""
    i = 0
    while i < len(cigar) and (cigar[i].isdigit() or cigar[i] == "-"):
        i += 1
    if i == 0:
        raise GfaParseError(f"bad CIGAR {cigar!r} in L line: {line!r}")
    overlap = int(cigar[:i])
    op = cigar[i] if i < len(cigar) else ""
    if not (op == "M" or (op == "S" and overlap == 0)) or overlap < 0:
        raise GfaParseError(f"unsupported CIGAR {cigar!r} in L line: {line!r}")
    return overlap, ord(op)
