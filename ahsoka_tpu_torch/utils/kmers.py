"""Canonical k-mer iteration.

Parity with the reference's dormant Jellyfish ``sequence_mers`` iterator
(src/sequence_mers.hpp:20-94 — vendored, linked, never invoked; its
``-k``/``-c`` flags are unreachable).  Implemented natively here (no
Jellyfish dependency): iterate canonical k-mers (lexicographic min of the
k-mer and its reverse complement) over a sequence, resetting at non-ACGT
characters."""

from __future__ import annotations

from typing import Iterator

_COMP = str.maketrans("ACGT", "TGCA")
_VALID = frozenset("ACGT")


def reverse_complement(seq: str) -> str:
    return seq.translate(_COMP)[::-1]


def canonical_kmers(seq: str, k: int) -> Iterator[str]:
    """Yield the canonical form of every k-mer window (skipping windows
    containing non-ACGT characters)."""
    seq = seq.upper()
    run_start = 0
    for i, c in enumerate(seq):
        if c not in _VALID:
            run_start = i + 1
            continue
        if i - run_start + 1 >= k:
            kmer = seq[i - k + 1:i + 1]
            rc = reverse_complement(kmer)
            yield kmer if kmer <= rc else rc


def kmer_counts(seq: str, k: int) -> dict:
    counts: dict = {}
    for kmer in canonical_kmers(seq, k):
        counts[kmer] = counts.get(kmer, 0) + 1
    return counts
