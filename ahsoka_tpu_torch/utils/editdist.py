"""Edit-distance utility.

Parity with the reference's dormant ``EditDistDP`` rolling two-row
Levenshtein (src/utils.hpp:1-59; only used by a commented-out
bubble-allele experiment there).  Provided as a tested utility so the
allele-sequence comparison experiments the reference sketched remain
possible here."""

from __future__ import annotations

from typing import Sequence


def edit_distance(a: Sequence, b: Sequence) -> int:
    """Levenshtein distance with O(min(len)) memory."""
    if len(a) < len(b):
        a, b = b, a
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, start=1):
        cur = [i]
        for j, cb in enumerate(b, start=1):
            cur.append(min(prev[j] + 1,          # deletion
                           cur[j - 1] + 1,       # insertion
                           prev[j - 1] + (ca != cb)))  # substitution
        prev = cur
    return prev[-1]
