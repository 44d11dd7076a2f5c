"""GAF alignment parsing into per-chain alignment tables.

Behavior matched (not ported) from src/alignmentreader.cpp:69-186:

- Whitespace-tokenised columns: read name (col 1), path (col 6), path start /
  end (cols 8-9), block length (col 11), and an identity tag ``id:f:<x>``
  required at column 16.
- The path column is split on '<'/'>' with the preceding character giving
  each node's orientation.
- Side effect: ``<gaf-stem>-alignment_identities.txt`` with
  ``name\tidentity\tnode,node,...,\tblocklen`` per record
  (src/alignmentreader.cpp:151-156).
- Bucketing: the alignment is appended to ``alignments[chain]`` once per
  node of its path (so a path with k nodes in one chain contributes k
  duplicate copies, and a path spanning two chains lands in both) —
  src/alignmentreader.cpp:176-183.  ``compat_duplicate_bucketing=False``
  dedups to one copy per (alignment, chain).
- Nodes outside any bubble chain have chain id 0 (the reference's
  zero-initialised ``Node.chain_id``), so their alignments bucket into
  chain 0.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, TextIO, Tuple

from ahsoka_tpu_torch.graph.structures import BubbleIndex
from ahsoka_tpu_torch.io.gfa import raw_id


class GafParseError(ValueError):
    pass


@dataclasses.dataclass
class Alignment:
    """One GAF record (the reference's AlignmentPath,
    src/alignmentreader.hpp:17-31)."""
    name: str
    node_ids: List[int]          # raw node ids along the path
    node_plus: List[bool]        # orientation per node ('>' == True)
    start: int
    end: int
    identity: float
    order: int = 0               # file order, for deterministic iteration


@dataclasses.dataclass
class AlignmentTable:
    """Per-chain alignment buckets (the reference's
    ``AlignmentReader::alignments``)."""
    by_chain: Dict[int, List[Alignment]] = dataclasses.field(
        default_factory=dict)
    num_records: int = 0

    def chain_alignments(self, chain_id: int) -> List[Alignment]:
        return self.by_chain.get(chain_id, [])


def _split_path(path: str) -> Tuple[List[str], List[bool]]:
    """Split a GAF path column into (segment names, '+' orientations)."""
    names: List[str] = []
    plus: List[bool] = []
    i, n = 0, len(path)
    if n and path[0] not in "<>":
        # the reference reads path.substr(beg-1, 1), which indexes before the
        # string for an unoriented leading segment; treat as malformed
        raise GafParseError(f"path must start with '<' or '>': {path[:60]!r}")
    while i < n:
        ori = path[i] == ">"
        j = i + 1
        while j < n and path[j] not in "<>":
            j += 1
        if j > i + 1:
            names.append(path[i + 1:j])
            plus.append(ori)
        i = j
    return names, plus


def parse_gaf_line(line: str, order: int = 0
                   ) -> Optional[Tuple[Alignment, List[str], str]]:
    """Parse one GAF record.  Returns (alignment, segment names, block-length
    column) or None for a record with an empty path."""
    fields = line.split()
    if len(fields) < 16:
        raise GafParseError(
            f"GAF record has {len(fields)} columns, need 16 "
            f"(identity tag id:f:<x> at column 16): {line[:120]!r}")
    name, path = fields[0], fields[5]
    start, end = int(fields[7]), int(fields[8])
    id_tag = fields[15]
    if id_tag.split(":")[0] != "id":
        raise GafParseError(f"column 16 must be an id:f: tag, got {id_tag!r}")
    identity = float(id_tag.rsplit(":", 1)[-1])

    names, plus = _split_path(path)
    if not names:
        return None
    aln = Alignment(name=name, node_ids=[raw_id(s) for s in names],
                    node_plus=plus, start=start, end=end, identity=identity,
                    order=order)
    return aln, names, fields[10]


def read_gaf(path_or_lines, index: BubbleIndex,
             identities_out: Optional[TextIO] = None,
             compat_duplicate_bucketing: bool = True,
             engine: str = "auto") -> AlignmentTable:
    """Parse a GAF file and bucket alignments by bubble chain.

    ``engine``: "native" uses the C++ parser (native/gaf_parser.cpp,
    ~10x faster on large files; slightly more lenient on malformed
    segments), "python" the reference-semantics parser, "auto" prefers
    native for file paths and falls back to python."""
    if engine in ("auto", "native") and isinstance(path_or_lines,
                                                   (str, bytes)):
        table = _read_gaf_native(path_or_lines, index, identities_out,
                                 compat_duplicate_bucketing)
        if table is not None:
            return table
        if engine == "native":
            raise GafParseError("native GAF parser unavailable or failed")
    close = False
    if isinstance(path_or_lines, (str, bytes)):
        fh: Iterable[str] = open(path_or_lines, "r")
        close = True
    else:
        fh = path_or_lines
    table = AlignmentTable()
    try:
        for order, line in enumerate(fh):
            if not line.strip():
                continue
            parsed = parse_gaf_line(line, order=order)
            if parsed is None:
                continue
            aln, names, blocklen = parsed
            if identities_out is not None:
                nodes_str = "".join(f"{s}," for s in names)
                identities_out.write(
                    f"{aln.name}\t{aln.identity:g}\t{nodes_str}\t"
                    f"{blocklen}\n")
            table.num_records += 1
            seen_chains = set()
            for node_id in aln.node_ids:
                chain = index.chain_of_node(node_id)
                if compat_duplicate_bucketing or chain not in seen_chains:
                    table.by_chain.setdefault(chain, []).append(aln)
                    seen_chains.add(chain)
    finally:
        if close:
            fh.close()  # type: ignore[union-attr]
    return table


def _read_gaf_native(path, index: BubbleIndex,
                     identities_out: Optional[TextIO],
                     compat_duplicate_bucketing: bool
                     ) -> Optional[AlignmentTable]:
    from ahsoka_tpu_torch.io._native_io import parse_gaf_native

    if isinstance(path, bytes):
        path = path.decode()
    cols = parse_gaf_native(path)
    if cols is None:
        return None
    table = AlignmentTable()
    nb = cols["name_bytes"]
    no = cols["name_offsets"]
    po = cols["path_offsets"]
    so = cols["seg_offsets"]
    sb = cols["seg_bytes"]
    bb = cols["blocklen_bytes"]
    bo = cols["blocklen_offsets"]
    ids = cols["node_ids"]
    dirs = cols["node_dirs"]
    for r in range(cols["num_records"]):
        lo, hi = int(po[r]), int(po[r + 1])
        aln = Alignment(
            name=nb[int(no[r]):int(no[r + 1])].decode(),
            node_ids=[int(x) for x in ids[lo:hi]],
            node_plus=[bool(x) for x in dirs[lo:hi]],
            start=int(cols["starts"][r]), end=int(cols["ends"][r]),
            identity=float(cols["identities"][r]), order=r)
        if identities_out is not None:
            segs = "".join(
                sb[int(so[i]):int(so[i + 1])].decode() + ","
                for i in range(lo, hi))
            blocklen = bb[int(bo[r]):int(bo[r + 1])].decode()
            identities_out.write(
                f"{aln.name}\t{aln.identity:g}\t{segs}\t{blocklen}\n")
        table.num_records += 1
        seen_chains = set()
        for node_id in aln.node_ids:
            chain = index.chain_of_node(node_id)
            if compat_duplicate_bucketing or chain not in seen_chains:
                table.by_chain.setdefault(chain, []).append(aln)
                seen_chains.add(chain)
    return table


def identities_sidefile_path(gaf_path: str) -> str:
    """Path of the ``-alignment_identities.txt`` side file for a GAF input
    (src/alignmentreader.cpp:74-75: everything before the first ".gaf")."""
    pos = gaf_path.find(".gaf")
    stem = gaf_path[:pos] if pos >= 0 else gaf_path
    return f"{stem}-alignment_identities.txt"
