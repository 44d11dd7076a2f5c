"""libstdc++ ``std::unordered_map`` iteration-order simulation.

Why this exists: the reference assigns chain ids by iterating
``unordered_map<int, Node> Graph::nodes`` (src/graph.cpp:333-335) and builds
the full readset by iterating ``unordered_map<int, vector<vector<int>>>``
bubble maps (src/alignmentstoreadset.cpp:90).  Its output chain/bubble
numbering therefore depends on libstdc++'s hashtable iteration order.  To be
able to match the reference's output files byte-for-byte we replicate that
order exactly (SURVEY.md §7 "hard parts" #1).

libstdc++ hashtable semantics (verified against /usr/include/c++/12/bits/
hashtable.h and an empirical probe):

- One global singly-linked list of nodes; iteration walks this list.
- ``_M_insert_bucket_begin``: inserting into an occupied bucket splices the
  node right after the bucket's "before" node (i.e. at the bucket's front);
  inserting into an empty bucket pushes the node at the head of the global
  list and repoints the previous head's bucket.
- Rehash (``_M_rehash_aux``): walks the current global list front-to-back and
  re-inserts each node with the same rule into the new bucket array.
- ``std::hash<int>`` is the identity (cast to size_t); bucket = hash % count.
- ``_Prime_rehash_policy``: bucket counts grow 1 -> 13 -> 29 -> 59 -> 127 ->
  257 -> 541 -> ... (next tabulated prime >= 2x), max load factor 1.0.
  The growth sequence below was extracted from a compiled probe on this
  toolchain (g++ 12, matches g++ 9 used by the reference container).

Only insertion is needed: the reference never erases from these maps.

Frozen copy of ``ahsoka_tpu_torch/compat/stdmap.py`` (the Python simulation; the native order is left out), so that a
change to the program cannot move the reference.
"""

from __future__ import annotations

from typing import Iterable, Iterator, List, Sequence

# Bucket-count growth chain observed for default-constructed maps under
# max_load_factor 1.0 (probe: insert ints 0..30M, record bucket_count()).
_BUCKET_GROWTH: List[int] = [
    1, 13, 29, 59, 127, 257, 541, 1109, 2357, 5087, 10273, 20753, 42043,
    85229, 172933, 351061, 712697, 1447153, 2938679, 5967347, 12117689,
    24607243, 49969847,
    # continue doubling with next-prime; values beyond the probe range
    # (sufficient for graphs up to ~100M nodes)
    99940891, 199881779,
]

_U64 = (1 << 64) - 1


def _bucket_of(key: int, bucket_count: int) -> int:
    # std::hash<int> casts to size_t (2's complement for negatives).
    return (key & _U64) % bucket_count


class StdUnorderedMapOrder:
    """Tracks the iteration order of a libstdc++ ``unordered_map<int, T>``
    under a sequence of insertions (``operator[]`` first-touches).

    Usage:
        order = StdUnorderedMapOrder()
        for k in first_touch_sequence: order.touch(k)
        list(order)   # iteration order of the C++ map
    """

    __slots__ = ("_next", "_buckets", "_bucket_count", "_growth_idx", "_count",
                 "_present")

    _BEFORE_BEGIN = object()  # sentinel head

    def __init__(self) -> None:
        # singly-linked list: _next maps node-key -> following node-key
        # (or None); the sentinel _BEFORE_BEGIN heads the list.
        self._next = {self._BEFORE_BEGIN: None}
        self._growth_idx = 0
        self._bucket_count = _BUCKET_GROWTH[0]
        # bucket -> the node *before* the bucket's first node in the list
        self._buckets: dict = {}
        self._count = 0
        self._present: set = set()

    def __len__(self) -> int:
        return self._count

    def __contains__(self, key: int) -> bool:
        return key in self._present

    def touch(self, key: int) -> None:
        """operator[]: insert `key` if absent (no-op when present)."""
        if key in self._present:
            return
        # _Prime_rehash_policy::_M_need_rehash with max_load_factor == 1:
        # rehash when element_count + 1 > bucket_count.
        if self._count + 1 > self._bucket_count:
            self._growth_idx += 1
            self._rehash(_BUCKET_GROWTH[self._growth_idx])
        self._insert_bucket_begin(key)
        self._present.add(key)
        self._count += 1

    def update(self, keys: Iterable[int]) -> None:
        for k in keys:
            self.touch(k)

    def _insert_bucket_begin(self, key: int) -> None:
        bkt = _bucket_of(key, self._bucket_count)
        before = self._buckets.get(bkt)
        if before is not None:
            # occupied bucket: splice after the bucket's before-node
            self._next[key] = self._next[before]
            self._next[before] = key
        else:
            # empty bucket: push at head of the global list
            head = self._next[self._BEFORE_BEGIN]
            self._next[key] = head
            self._next[self._BEFORE_BEGIN] = key
            if head is not None:
                # the former head's bucket now starts after `key`
                self._buckets[_bucket_of(head, self._bucket_count)] = key
            self._buckets[bkt] = self._BEFORE_BEGIN

    def _rehash(self, new_count: int) -> None:
        # _M_rehash_aux: walk the old list front-to-back, reinsert each node.
        old_order = list(self)
        self._bucket_count = new_count
        self._buckets = {}
        self._next = {self._BEFORE_BEGIN: None}
        for key in old_order:
            self._insert_bucket_begin(key)

    def __iter__(self) -> Iterator[int]:
        node = self._next[self._BEFORE_BEGIN]
        while node is not None:
            yield node
            node = self._next[node]


def std_iteration_order(keys: Sequence[int]) -> List[int]:
    """Iteration order of a libstdc++ ``unordered_map<int, T>`` after
    inserting ``keys`` in sequence (duplicates are first-touch no-ops)."""
    order = StdUnorderedMapOrder()
    order.update(keys)
    return list(order)

