"""Readset construction: project alignments onto bubble positions.

This is the host-exact oracle for the projection stage (the TPU tensor
program in project/device.py is cross-checked against it).  Behavior matched
from src/alignmentstoreadset.cpp:55-304 and the WhatsHap Read/ReadSet call
sites it uses:

Full pass (src/alignmentstoreadset.cpp:87-135): for every bubble (iterated
in the reference's unordered_map order over bubble ids), every allele path,
and every alignment bucketed into the chain, an allele path fully contained
in the alignment's node set adds variant ``(position=bubble_id, allele)`` to
the read named by the alignment.  The first match creates the read with
``mapq = int(identity * 100)`` (WhatsHap's Read ctor takes int mapq, so the
float truncates); later matches only add variants at new positions.

Filter (src/alignmentstoreadset.cpp:151-163): keep reads with >= 2 variants
and mapq >= 93.

Partial pass (src/alignmentstoreadset.cpp:174-254): positions 0..last-1 of
the full readset (plus chain-boundary positions, which can extend to last
and last+1) are re-projected using only the allele path's *inner* nodes
(first and last path entries stripped; paths of length <= 2 therefore match
every alignment).  A new read is created on any match; adding a variant to
an existing read additionally requires ``identity * 100 > 90`` — so the
winning allele at a position is the first match by (allele, alignment)
order for new reads, but the first *gated* match for existing reads.

The partial readset replaces the full one downstream
(src/alignmentstoreadset.cpp:296); the full one feeds only the debug dumps
and the position bookkeeping above.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Sequence, Set

from ahsoka_tpu_torch.config import PhasingConfig
from ahsoka_tpu_torch.io.gaf import Alignment


@dataclasses.dataclass
class Read:
    """A read's projection onto bubble positions (WhatsHap Read semantics:
    name, int mapq, sorted variant list)."""
    name: str
    mapq: int
    positions: List[int] = dataclasses.field(default_factory=list)
    alleles: List[int] = dataclasses.field(default_factory=list)

    def add_variant(self, position: int, allele: int) -> None:
        # keep variants sorted by position (Read::sortVariants after add)
        import bisect
        i = bisect.bisect_left(self.positions, position)
        self.positions.insert(i, position)
        self.alleles.insert(i, allele)

    def has_position(self, position: int) -> bool:
        return position in self.positions

    def first_position(self) -> int:
        return self.positions[0]

    def last_position(self) -> int:
        return self.positions[-1]

    def variant_count(self) -> int:
        return len(self.positions)

    def allele_at(self, position: int) -> int:
        return self.alleles[self.positions.index(position)]


class ReadSet:
    """Ordered collection of reads with name lookup (WhatsHap ReadSet)."""

    def __init__(self) -> None:
        self.reads: List[Read] = []
        self._by_name: Dict[str, Read] = {}

    def add(self, read: Read) -> None:
        self.reads.append(read)
        self._by_name[read.name] = read

    def get_by_name(self, name: str) -> Optional[Read]:
        return self._by_name.get(name)

    def __len__(self) -> int:
        return len(self.reads)

    def __iter__(self):
        return iter(self.reads)

    def get(self, i: int) -> Read:
        return self.reads[i]

    def subset(self, indices: Sequence[int]) -> "ReadSet":
        out = ReadSet()
        for i in indices:
            out.add(self.reads[i])
        return out

    def sort_by_first_position(self) -> None:
        """ReadSet::sort orders reads by first variant position (stable for
        ties, which diverges from std::sort only for >16 equal keys)."""
        self.reads.sort(key=lambda r: r.first_position())

    def positions(self) -> List[int]:
        """Sorted union of variant positions (ReadSet::get_positions)."""
        ps: Set[int] = set()
        for r in self.reads:
            ps.update(r.positions)
        return sorted(ps)

    def to_debug_string(self) -> str:
        parts = []
        for r in self.reads:
            vs = " ".join(f"{p}:{a}" for p, a in zip(r.positions, r.alleles))
            parts.append(f"{r.name} mapq={r.mapq} [{vs}]")
        return "\n".join(parts)


def full_contained(path: Sequence[int], aln_nodes: FrozenSet[int]) -> bool:
    """is_subset(..., take_partial=false): the sorted allele path is a
    sub-multiset of the alignment's node ids (paths are duplicate-free, so
    set inclusion; src/alignmentstoreadset.cpp:504-508)."""
    return all(n in aln_nodes for n in path)


def partial_inner(path: Sequence[int]) -> Sequence[int]:
    """The inner nodes used by the partial containment check: the reference
    pops the last element and erases the first (src/alignmentstoreadset.cpp:
    510-511).  Length <= 2 leaves an empty set, which matches every
    alignment (length < 2 is undefined behavior in the reference; we treat
    it as empty too)."""
    if len(path) <= 2:
        return ()
    return path[1:-1]


@dataclasses.dataclass
class ChainReadsets:
    full: ReadSet                 # unfiltered full pass
    full_filtered: ReadSet        # >=2 variants, mapq >= threshold
    partial: ReadSet              # unfiltered partial pass
    partial_filtered: ReadSet     # the readset used downstream
    projected_positions: List[int]  # the partial pass's position sweep


def _mapq(identity: float, config: PhasingConfig) -> int:
    return int(identity * config.mapq_scale)  # int truncation, Read ctor


def _filter(readset: ReadSet, config: PhasingConfig) -> ReadSet:
    indices = [i for i, r in enumerate(readset.reads)
               if r.variant_count() >= config.min_variants
               and r.mapq >= config.mapq_threshold]
    return readset.subset(indices)


def _bubble_iteration_order(bubble_ids: Sequence[int],
                            config: PhasingConfig) -> List[int]:
    """The full pass iterates the chain's bubble map in unordered_map order
    (keys inserted in ascending bubble id, src/chainstoreadset.cpp:178)."""
    ids = sorted(bubble_ids)
    if config.compat_std_ordering:
        from ahsoka_tpu_torch.compat import native_iteration_order
        return native_iteration_order(ids)
    return ids


def build_full_readset(bubble_paths: Dict[int, List[List[int]]],
                       alignments: Sequence[Alignment],
                       config: PhasingConfig) -> ReadSet:
    readset = ReadSet()
    aln_sets = [frozenset(a.node_ids) for a in alignments]
    for bubble_id in _bubble_iteration_order(list(bubble_paths), config):
        for allele, path in enumerate(bubble_paths[bubble_id]):
            for aln, nodes in zip(alignments, aln_sets):
                if not full_contained(path, nodes):
                    continue
                read = readset.get_by_name(aln.name)
                if read is None:
                    read = Read(aln.name, _mapq(aln.identity, config))
                    read.add_variant(bubble_id, allele)
                    readset.add(read)
                elif not read.has_position(bubble_id):
                    read.add_variant(bubble_id, allele)
    return readset


def partial_position_sweep(full: ReadSet, full_filtered: ReadSet
                           ) -> List[int]:
    """Positions the partial pass projects, in ascending order
    (src/alignmentstoreadset.cpp:174-208): all of 0..last-1 over the *full*
    readset's position span, plus boundary positions el/el+1 for filtered
    reads whose last position is not any filtered read's first position
    (these can reach last and last+1)."""
    full_positions = full.positions()
    if not full_positions:
        return []
    last = full_positions[-1]
    to_be_added: Set[int] = set(range(last))
    first_pos = {r.first_position() for r in full_filtered.reads}
    last_pos = {r.last_position() for r in full_filtered.reads}
    for el in last_pos:
        if el not in first_pos:
            to_be_added.add(el)
            to_be_added.add(el + 1)
    # gap positions (uncovered by the filtered set) are already inside
    # range(last); kept for clarity with the reference's three-way union
    return sorted(to_be_added)


def build_partial_readset(bubble_paths: Dict[int, List[List[int]]],
                          alignments: Sequence[Alignment],
                          sweep_positions: Sequence[int],
                          config: PhasingConfig) -> ReadSet:
    partial = ReadSet()
    aln_sets = [frozenset(a.node_ids) for a in alignments]
    gate = config.partial_identity_gate
    for position in sweep_positions:
        paths = bubble_paths.get(position, [])
        for allele, path in enumerate(paths):
            inner = partial_inner(path)
            for aln, nodes in zip(alignments, aln_sets):
                if not all(n in nodes for n in inner):
                    continue
                read = partial.get_by_name(aln.name)
                if read is None:
                    read = Read(aln.name, _mapq(aln.identity, config))
                    read.add_variant(position, allele)
                    partial.add(read)
                elif (not read.has_position(position)
                      and aln.identity * config.mapq_scale > gate):
                    read.add_variant(position, allele)
    return partial


def build_chain_readsets(bubble_paths: Dict[int, List[List[int]]],
                         alignments: Sequence[Alignment],
                         config: PhasingConfig) -> ChainReadsets:
    full = build_full_readset(bubble_paths, alignments, config)
    full_filtered = _filter(full, config)
    sweep = partial_position_sweep(full, full_filtered)
    partial = build_partial_readset(bubble_paths, alignments, sweep, config)
    partial_filtered = _filter(partial, config)
    partial_filtered.sort_by_first_position()
    return ChainReadsets(full=full, full_filtered=full_filtered,
                         partial=partial, partial_filtered=partial_filtered,
                         projected_positions=sweep)
