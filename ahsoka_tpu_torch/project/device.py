"""Projection on the device, in PyTorch.

Counterpart of ``ahsoka_tpu/project/device.py``.  The JAX module imports
jax at its top, so its host half cannot be imported without jax; this is
the port's one forced copy of it:

- host half, copied unchanged: key packing (``AL_BITS``, ``MAX_ALN``,
  ``NO_MATCH``), ``SparseOnehot``, ``ChainDeviceInputs``,
  ``prepare_chain_inputs``, ``prepare_chain_inputs_from_columns``,
  ``_padded_chain_arrays``, ``SparseKeys``, ``table_coo``, ``_decode``
  and ``assemble_readsets``;
- device half, in torch: ``containment_keys_core`` with a written-out
  chain batch, ``containment_key_tables`` (batch of one, bubble-blocked
  for oversized tables, data-sharded over a mesh with ``data_shards`` >
  1) and ``containment_key_tables_many``.

The containment test is two matmuls: with V the chain's path-node
vocabulary, P[s, v] the one-hot of allele path s and A[a, v] the node
membership of alignment a, path s is contained in alignment a iff
(P @ A^T)[s, a] == |path s|.  The reference's "first (allele, alignment)
match wins" order is packed into one int32 key ``allele << AL_BITS |
alignment`` and min-reduced per bubble, then scatter-min-reduced into a
[bubbles, names] table by read name.  Tables stay on the device and only
their matched entries come back (``torch.nonzero``), as SparseKeys.

The JAX package's transfer machinery for a remote TPU link (COO capacity
guesses, packed and sliced fetches, rank-search compaction, compile-shape
bucketing of the batch axis) has no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ahsoka_tpu_torch.config import PhasingConfig
from ahsoka_tpu_torch.dist.mesh import DATA_AXIS, gated_mesh, local_devices
from ahsoka_tpu_torch.dist.step import (shard_alignments,
                                        sharded_containment_keys)
from ahsoka_tpu_torch.io.gaf import Alignment
from ahsoka_tpu_torch.project.readset import (ChainReadsets, Read, ReadSet,
                                        _filter, partial_inner,
                                        partial_position_sweep)
from ahsoka_tpu_torch.state import to_torch

AL_BITS = 23                    # alignment index bits in the packed key
MAX_ALLELE = (1 << (31 - AL_BITS)) - 1
MAX_ALN = (1 << AL_BITS) - 1
NO_MATCH = np.int32(2 ** 31 - 1)

def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _bucket(x: int, minimum: int = 128) -> int:
    """Next power of two (>= minimum): pads shapes into a logarithmic
    family of buckets so per-chain kernels share compile-cache entries
    instead of recompiling for every distinct chain size."""
    b = minimum
    while b < x:
        b *= 2
    return b


class SparseOnehot:
    """COO form of a 0/1 path-node table (logically int8 [S, V]).

    Big chains never materialise the dense onehots: a 10k-bubble,
    50k-node-vocab chain's two tables are 2 GB of host zeros at ~0.3%
    occupancy, and the device path scatters the COO coordinates
    directly (_scatter_onehot)."""

    __slots__ = ("shape", "r", "c")
    dtype = np.dtype(np.int8)

    def __init__(self, shape, r, c):
        self.shape = shape
        self.r = np.asarray(r, dtype=np.int64)
        self.c = np.asarray(c, dtype=np.int64)

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=np.int8)
        out[self.r, self.c] = 1
        return out


# above this many cells the path onehots stay COO (SparseOnehot)
_DENSE_ONEHOT_CELLS = 1 << 26


def _onehot_repr(shape, r, c):
    if shape[0] * shape[1] > _DENSE_ONEHOT_CELLS:
        return SparseOnehot(shape, r, c)
    out = np.zeros(shape, dtype=np.int8)
    out[r, c] = 1
    return out


@dataclasses.dataclass
class ChainDeviceInputs:
    """Host-prepared padded arrays for one chain's projection."""
    # paths (full + inner variants share the same (bubble, allele)
    # layout); SparseOnehot above _DENSE_ONEHOT_CELLS
    path_onehot_full: "np.ndarray | SparseOnehot"   # int8 [S, V]
    path_onehot_inner: "np.ndarray | SparseOnehot"  # int8 [S, V]
    path_len_full: np.ndarray       # int32 [S]
    path_len_inner: np.ndarray      # int32 [S]
    path_bubble: np.ndarray         # int32 [S] dense bubble index
    path_key_base: np.ndarray       # int32 [S] allele << AL_BITS
    bubble_ids: np.ndarray          # int32 [B] bubble ids (sorted)
    # alignments
    aln_vocab_nodes: np.ndarray     # int32 [A, L] vocab indices, -1 pad
    aln_name_id: np.ndarray         # int32 [A]
    aln_identity: np.ndarray        # float32 [A]
    names: List[str]
    num_paths: int
    num_alignments: int


def _path_tables(bubble_paths: Dict[int, List[List[int]]]):
    bubble_ids = sorted(bubble_paths)
    flat: List[Tuple[int, int, List[int]]] = []
    for b_idx, b in enumerate(bubble_ids):
        for allele, path in enumerate(bubble_paths[b]):
            if allele > MAX_ALLELE:
                raise ValueError("allele index exceeds packed-key capacity")
            flat.append((b_idx, allele, path))
    vocab: Dict[int, int] = {}
    for _, _, path in flat:
        for n in path:
            vocab.setdefault(n, len(vocab))
    return bubble_ids, flat, vocab


def _build_path_tables(flat, vocab):
    """Shared path-table construction: COO onehots (dense below the
    threshold), lengths, bubble index, packed-key base."""
    S, V = len(flat), max(len(vocab), 1)
    path_len_full = np.zeros(S, dtype=np.int32)
    path_len_inner = np.zeros(S, dtype=np.int32)
    path_bubble = np.zeros(S, dtype=np.int32)
    path_key_base = np.zeros(S, dtype=np.int32)
    fr: List[int] = []
    fc: List[int] = []
    ir: List[int] = []
    ic: List[int] = []
    for s, (b_idx, allele, path) in enumerate(flat):
        uniq = set(path)
        for n in uniq:
            fr.append(s)
            fc.append(vocab[n])
        path_len_full[s] = len(uniq)
        inner = set(partial_inner(path))
        for n in inner:
            ir.append(s)
            ic.append(vocab[n])
        path_len_inner[s] = len(inner)
        path_bubble[s] = b_idx
        path_key_base[s] = allele << AL_BITS
    return (_onehot_repr((S, V), fr, fc), _onehot_repr((S, V), ir, ic),
            path_len_full, path_len_inner, path_bubble, path_key_base)


def prepare_chain_inputs(bubble_paths: Dict[int, List[List[int]]],
                         alignments: Sequence[Alignment]
                         ) -> ChainDeviceInputs:
    bubble_ids, flat, vocab = _path_tables(bubble_paths)
    S = len(flat)
    (path_onehot_full, path_onehot_inner, path_len_full, path_len_inner,
     path_bubble, path_key_base) = _build_path_tables(flat, vocab)

    if len(alignments) > MAX_ALN:
        raise ValueError("alignment count exceeds packed-key capacity")
    names: List[str] = []
    name_index: Dict[str, int] = {}
    L = max((len(set(a.node_ids)) for a in alignments), default=1)
    A = len(alignments)
    aln_vocab_nodes = np.full((A, L), -1, dtype=np.int32)
    aln_name_id = np.zeros(A, dtype=np.int32)
    aln_identity = np.zeros(A, dtype=np.float32)
    for i, aln in enumerate(alignments):
        if aln.name not in name_index:
            name_index[aln.name] = len(names)
            names.append(aln.name)
        aln_name_id[i] = name_index[aln.name]
        aln_identity[i] = aln.identity
        k = 0
        for n in set(aln.node_ids):
            v = vocab.get(n)
            if v is not None:
                aln_vocab_nodes[i, k] = v
                k += 1
    return ChainDeviceInputs(
        path_onehot_full=path_onehot_full,
        path_onehot_inner=path_onehot_inner,
        path_len_full=path_len_full, path_len_inner=path_len_inner,
        path_bubble=path_bubble, path_key_base=path_key_base,
        bubble_ids=np.asarray(bubble_ids, dtype=np.int32),
        aln_vocab_nodes=aln_vocab_nodes, aln_name_id=aln_name_id,
        aln_identity=aln_identity, names=names,
        num_paths=S, num_alignments=A)


def prepare_chain_inputs_from_columns(bubble_paths, cols, bucket
                                      ) -> ChainDeviceInputs:
    """Columnar variant of prepare_chain_inputs: builds the device inputs
    from GafColumns + a ChainBucket with vectorised numpy (no per-record
    Python objects; the batched jax backend's data path)."""
    bubble_ids, flat, vocab = _path_tables(bubble_paths)
    S = len(flat)
    (path_onehot_full, path_onehot_inner, path_len_full, path_len_inner,
     path_bubble, path_key_base) = _build_path_tables(flat, vocab)

    # The reference buckets an alignment once per path node in the chain
    # (src/alignmentreader.cpp:176-183).  For containment the duplicates
    # are pure redundancy: every copy has the same node set/name/identity,
    # so first-match winners and creation order are invariant under an
    # order-preserving dedup (bucket entries are ascending -> np.unique
    # keeps first-occurrence order; packed keys remap monotonically).
    # Dropping them shrinks the kernel's alignment axis by ~|path| x.
    entries = np.unique(bucket.record_idx)
    A = len(entries)
    if A > MAX_ALN:
        raise ValueError("alignment count exceeds packed-key capacity")
    identities = cols.identities[entries].astype(np.float32)
    gnames = cols.record_name[entries]
    uniq_names, name_id = np.unique(gnames, return_inverse=True)
    names = [cols.names[int(g)] for g in uniq_names]

    # vocab-mapped node rows for the unique records, gathered raggedly
    uniq_recs, rec_inv = np.unique(entries, return_inverse=True)
    off = cols.path_offsets
    starts = off[uniq_recs]
    lens = (off[uniq_recs + 1] - starts).astype(np.int64)
    total = int(lens.sum()) if len(lens) else 0
    L = int(lens.max()) if len(lens) else 1
    if total:
        within = np.arange(total, dtype=np.int64) - np.repeat(
            np.cumsum(lens) - lens, lens)
        flat_idx = np.repeat(starts, lens) + within
        nodes_concat = cols.node_ids[flat_idx]
        vocab_ids = np.fromiter(vocab.keys(), dtype=np.int64,
                                count=len(vocab))
        vocab_vals = np.arange(len(vocab), dtype=np.int64)
        sort = np.argsort(vocab_ids)
        vocab_ids, vocab_vals = vocab_ids[sort], vocab_vals[sort]
        pos = np.clip(np.searchsorted(vocab_ids, nodes_concat), 0,
                      max(len(vocab_ids) - 1, 0))
        mapped = np.where(vocab_ids[pos] == nodes_concat,
                          vocab_vals[pos], -1)
        per_rec = np.full((len(uniq_recs), L), -1, dtype=np.int32)
        rows = np.repeat(np.arange(len(uniq_recs)), lens)
        per_rec[rows, within] = mapped
    else:
        per_rec = np.full((max(len(uniq_recs), 1), L), -1, dtype=np.int32)
    aln_vocab_nodes = per_rec[rec_inv] if A else \
        np.full((0, L), -1, dtype=np.int32)

    return ChainDeviceInputs(
        path_onehot_full=path_onehot_full,
        path_onehot_inner=path_onehot_inner,
        path_len_full=path_len_full, path_len_inner=path_len_inner,
        path_bubble=path_bubble, path_key_base=path_key_base,
        bubble_ids=np.asarray(bubble_ids, dtype=np.int32),
        aln_vocab_nodes=aln_vocab_nodes,
        aln_name_id=name_id.astype(np.int32),
        aln_identity=identities, names=names,
        num_paths=S, num_alignments=A)


def _onehot_coo(oh) -> tuple:
    """(rows, cols) of a dense or SparseOnehot path table."""
    if isinstance(oh, SparseOnehot):
        return oh.r, oh.c
    r, c = np.nonzero(oh)
    return r, c


def _padded_chain_arrays(inputs: ChainDeviceInputs, chunk: int = 1024,
                         dense_onehots: bool = True):
    """Pad one chain's arrays into the bucketed kernel layout.

    Returns (arrays, statics): ``arrays`` = (pf, pi, plf, pli, pb, pkb,
    nodes, name_id, ident), ``statics`` = (num_bubbles, num_names, chunk,
    alleles_per_bubble).  Chains with equal array shapes + statics can be
    stacked on a leading axis and run in one vmapped kernel call.

    ``dense_onehots=False`` returns pf/pi as padded SparseOnehot COO
    (the blocked big-chain path scatters them on device; the multi-GB
    dense padded tables are never built)."""
    A = inputs.num_alignments
    chunk = min(chunk, _round_up(max(A, 1), 256))
    A_pad = _round_up(max(A, 1), chunk)
    pad = A_pad - A
    nodes = np.pad(inputs.aln_vocab_nodes, ((0, pad), (0, 0)),
                   constant_values=-1)
    # padded alignments point at a sacrificial extra name slot
    name_id = np.pad(inputs.aln_name_id, (0, pad),
                     constant_values=len(inputs.names))
    ident = np.pad(inputs.aln_identity, (0, pad), constant_values=0.0)
    # bucket the table shapes (and the path/vocab axes) so chains of
    # similar size share one compiled kernel
    B = len(inputs.bubble_ids)
    N = len(inputs.names) + 1
    B_pad, N_pad = _bucket(B, 64), _bucket(N, 128)
    S, V = inputs.path_onehot_full.shape
    V_pad = _bucket(V, 128)
    L = nodes.shape[1]
    L_pad = _bucket(L, 8)
    counts = np.bincount(inputs.path_bubble, minlength=B) if S else \
        np.ones(B, dtype=np.int64)
    amax = int(counts.max()) if B else 1
    if amax <= 16:
        # uniform layout: row s = b * A_max + allele rank; the kernel's
        # per-bubble min becomes a reshape+min instead of a segment_min
        apb = _bucket(max(amax, 1), 2)
        S_pad = B_pad * apb
        offsets = np.concatenate([[0], np.cumsum(counts)])
        rank = np.arange(S) - offsets[inputs.path_bubble]
        rows = inputs.path_bubble.astype(np.int64) * apb + rank
        plf = np.full(S_pad, np.int32(2 ** 30), dtype=np.int32)
        pli = np.full(S_pad, np.int32(2 ** 30), dtype=np.int32)
        pb = np.zeros(S_pad, dtype=np.int32)
        pkb = np.zeros(S_pad, dtype=np.int32)
        fr, fc = _onehot_coo(inputs.path_onehot_full)
        ir, ic = _onehot_coo(inputs.path_onehot_inner)
        pf_s = SparseOnehot((S_pad, V_pad), rows[fr], fc)
        pi_s = SparseOnehot((S_pad, V_pad), rows[ir], ic)
        pf = pf_s.to_dense() if dense_onehots else pf_s
        pi = pi_s.to_dense() if dense_onehots else pi_s
        plf[rows] = inputs.path_len_full
        pli[rows] = inputs.path_len_inner
        pkb[rows] = inputs.path_key_base
    else:
        apb = 0
        S_pad = _bucket(S, 64)
        fr, fc = _onehot_coo(inputs.path_onehot_full)
        ir, ic = _onehot_coo(inputs.path_onehot_inner)
        pf_s = SparseOnehot((S_pad, V_pad), fr, fc)
        pi_s = SparseOnehot((S_pad, V_pad), ir, ic)
        pf = pf_s.to_dense() if dense_onehots else pf_s
        pi = pi_s.to_dense() if dense_onehots else pi_s
        # padded paths: impossible length so they never match; bubble id
        # points at a sacrificial padded bubble row
        plf = np.pad(inputs.path_len_full, (0, S_pad - S),
                     constant_values=np.int32(2 ** 30))
        pli = np.pad(inputs.path_len_inner, (0, S_pad - S),
                     constant_values=np.int32(2 ** 30))
        pb = np.pad(inputs.path_bubble, (0, S_pad - S),
                    constant_values=np.int32(B_pad - 1) if B_pad > B else 0)
        pkb = np.pad(inputs.path_key_base, (0, S_pad - S))
    nodes = np.pad(nodes, ((0, 0), (0, L_pad - L)), constant_values=-1)
    if V_pad < 2 ** 15:
        # vocab indices fit int16: halves the dominant upload
        nodes = nodes.astype(np.int16)
    return ((pf, pi, plf, pli, pb, pkb, nodes, name_id, ident),
            (B_pad, N_pad, chunk, apb))

class SparseKeys:
    """COO view of a winner table: logically a [rows, cols] int32 array
    that is NO_MATCH everywhere except the matched entries (r, c) -> v.

    The matrix-native consumers (project/matrix.py) start by
    re-sparsifying dense tables (``np.nonzero(tbl != NO_MATCH)``), so
    for big blocked chains the pipeline carries this COO form end to
    end instead of materialising (and then rescanning) multi-GB dense
    tables on the host.  Entries are in device-compaction order
    (row-major: r ascending, c ascending within r)."""

    __slots__ = ("shape", "r", "c", "v")

    def __init__(self, shape, r, c, v):
        self.shape = shape
        self.r = r
        self.c = c
        self.v = v

    def coo(self):
        return self.r, self.c, self.v

    def row_slice(self, lo: int, hi: int) -> "SparseKeys":
        """Rows [lo, hi) re-based to 0 (contiguous sweep case).  Entries
        are row-major by construction, so the slice is two binary
        searches, not a full-length mask."""
        a = int(np.searchsorted(self.r, lo))
        b = int(np.searchsorted(self.r, hi))
        return SparseKeys((hi - lo, self.shape[1]),
                          self.r[a:b] - lo, self.c[a:b], self.v[a:b])

    def row_subset(self, rows: np.ndarray) -> "SparseKeys":
        """Rows re-indexed by their rank in the sorted ``rows`` list."""
        rows = np.asarray(rows, dtype=np.int64)
        if len(rows) == 0:
            z = np.zeros(0, dtype=np.int64)
            return SparseKeys((0, self.shape[1]), z, z,
                              np.zeros(0, dtype=self.v.dtype))
        idx = np.searchsorted(rows, self.r)
        idx_c = np.minimum(idx, len(rows) - 1)
        ok = (idx < len(rows)) & (rows[idx_c] == self.r)
        return SparseKeys((len(rows), self.shape[1]),
                          idx_c[ok], self.c[ok], self.v[ok])

    def to_dense(self) -> np.ndarray:
        out = np.full(self.shape, NO_MATCH, dtype=np.int32)
        out[self.r, self.c] = self.v
        return out


def table_coo(tbl):
    """(r, c, v) of the matched entries, row-major — for SparseKeys a
    view, for dense np tables one nonzero scan."""
    if isinstance(tbl, SparseKeys):
        return tbl.coo()
    r, c = np.nonzero(tbl != NO_MATCH)
    return r, c, tbl[r, c]


# running pow2 capacity guesses for the speculative count+compact fetch,
# keyed by the pow2 bucket of the table's cell count: one global guess
# thrashed between call sites (a 6M-entry group fetch pushed the guess

def _decode(key: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    allele = key >> AL_BITS
    al = key & MAX_ALN
    return allele, al


def assemble_readsets(inputs: ChainDeviceInputs,
                      full_keys: np.ndarray,
                      part_keys: np.ndarray,
                      gate_keys: np.ndarray,
                      config: PhasingConfig) -> ChainReadsets:
    """Rebuild the reference-ordered readsets from the winner tables."""
    # the debug/oracle path works on dense tables; big blocked chains
    # arrive as SparseKeys (debug dumps are off at that scale anyway)
    if isinstance(full_keys, SparseKeys):
        full_keys = full_keys.to_dense()
    if isinstance(part_keys, SparseKeys):
        part_keys = part_keys.to_dense()
    if isinstance(gate_keys, SparseKeys):
        gate_keys = gate_keys.to_dense()
    bubble_ids = inputs.bubble_ids
    B, N = full_keys.shape
    identity = inputs.aln_identity

    # ---- full pass ----
    full_match = full_keys != NO_MATCH
    full = ReadSet()
    if N:
        # read creation order: first (bubble stdmap-rank, allele, al) match
        if config.compat_std_ordering:
            from ahsoka_tpu_torch.compat import native_iteration_order
            order = native_iteration_order([int(b) for b in bubble_ids])
            rank_of = {b: r for r, b in enumerate(order)}
            ranks = np.asarray([rank_of[int(b)] for b in bubble_ids],
                               dtype=np.int64)
        else:
            ranks = np.arange(B, dtype=np.int64)
        # per name: winning bubble by rank among matches
        order_key = np.where(
            full_match,
            ranks[:, None] * np.int64(1 << 31) + full_keys.astype(np.int64),
            np.int64(1 << 62))
        creation_key = order_key.min(axis=0)
        name_order = np.argsort(creation_key, kind="stable")
        allele_tab, al_tab = _decode(full_keys)
        for n in name_order:
            if not full_match[:, n].any():
                continue
            win_b = int(np.argmin(order_key[:, n]))
            _, win_al = int(allele_tab[win_b, n]), int(al_tab[win_b, n])
            read = Read(inputs.names[n],
                        int(identity[win_al] * config.mapq_scale))
            bs = np.nonzero(full_match[:, n])[0]
            read.positions = [int(bubble_ids[b]) for b in bs]
            read.alleles = [int(allele_tab[b, n]) for b in bs]
            full.add(read)
    full_filtered = _filter(full, config)

    # ---- partial pass ----
    sweep = partial_position_sweep(full, full_filtered)
    bubble_index = {int(b): i for i, b in enumerate(bubble_ids)}
    sweep_dense = [bubble_index[p] for p in sweep if p in bubble_index]
    partial = ReadSet()
    if sweep_dense and N:
        sd = np.asarray(sweep_dense)
        pm = part_keys[sd] != NO_MATCH          # [Bs, N]
        gm = gate_keys[sd] != NO_MATCH
        p_allele, p_al = _decode(part_keys[sd])
        g_allele, _ = _decode(gate_keys[sd])
        any_match = pm.any(axis=0)
        first_row = np.where(any_match, pm.argmax(axis=0), -1)
        # creation order: ascending position, then packed key
        creation = np.where(
            any_match,
            first_row.astype(np.int64) * (1 << 31)
            + part_keys[sd][np.maximum(first_row, 0),
                            np.arange(N)].astype(np.int64),
            np.int64(1 << 62))
        for n in np.argsort(creation, kind="stable"):
            if not any_match[n]:
                continue
            r0 = int(first_row[n])
            win_al = int(p_al[r0, n])
            read = Read(inputs.names[n],
                        int(identity[win_al] * config.mapq_scale))
            positions = [int(bubble_ids[sd[r0]])]
            alleles = [int(p_allele[r0, n])]
            for r in range(r0 + 1, len(sd)):
                if gm[r, n]:
                    positions.append(int(bubble_ids[sd[r]]))
                    alleles.append(int(g_allele[r, n]))
            read.positions = positions
            read.alleles = alleles
            partial.add(read)
    partial_filtered = _filter(partial, config)
    partial_filtered.sort_by_first_position()
    return ChainReadsets(full=full, full_filtered=full_filtered,
                         partial=partial,
                         partial_filtered=partial_filtered,
                         projected_positions=sweep)


# ---------------------------------------------------------------------
# Device half (torch)
# ---------------------------------------------------------------------

# device bytes for the [3, B, N] key-table carry of one chain above which
# the chain runs in exact bubble blocks (containment never crosses
# bubbles): a 10k-bubble x 50k-read chain needs 6 GB of tables
_KEY_TABLE_BUDGET = 1536 * 1024 * 1024

# device working-set budget of one batched call (stacked inputs, the
# per-chunk membership / hit tensors and the key tables)
_BATCH_DEVICE_BYTES = 1 << 30


def containment_keys_core(pf, pi, plf, pli, pb, pkb, nodes, name_id, ident,
                          gate_mask_value: float, *, num_bubbles: int,
                          num_names: int, chunk: int,
                          alleles_per_bubble: int = 0,
                          aln_offset: int = 0) -> torch.Tensor:
    """Containment matmuls + packed-key reductions for a chain batch.

    Every array argument has a leading chain axis C: pf/pi [C, S, V]
    (0/1), plf/pli/pb/pkb [C, S] int32, nodes [C, A, L] (vocab index,
    -1 pad), name_id [C, A] int32, ident [C, A] float32.  Returns int32
    key tables [C, 3, B, N] (full, partial, partial-gated), NO_MATCH
    where no (allele, alignment) matched — ``project/device.py:274-344``
    of the JAX package with the batch written out.

    - membership [C, chunk, V] is a scatter of ones (duplicate nodes
      collapse like the host oracle's ``set()``; -1 lands in a discarded
      column), equal to the JAX compare-any at :310-311;
    - hit counts are float32 matmuls: operands are 0/1 and the sums stay
      below 2^24, so the counts are exact integers;
    - the per-bubble min is a reshape+amin for the uniform layout
      (``alleles_per_bubble > 0``), a scatter-amin by path bubble
      otherwise (:325-332);
    - the scatter-min by read name starts from NO_MATCH (:342).

    ``aln_offset`` is the global index of the first alignment given: a
    data shard's keys pack global alignment indices, so the shards' tables
    min-merge into the unsharded ones."""
    C, S, V = pf.shape
    A = nodes.shape[1]
    dev = pf.device
    B, N = num_bubbles, num_names
    pf = pf.to(torch.float32)
    pi = pi.to(torch.float32)
    nodes = nodes.to(torch.int64)
    plf_f = plf.to(torch.float32)[:, :, None]
    pli_f = pli.to(torch.float32)[:, :, None]
    pkb = pkb.to(torch.int32)[:, :, None]
    no_match = torch.tensor(int(NO_MATCH), dtype=torch.int32, device=dev)
    keys = torch.full((C, 3, B, N), int(NO_MATCH), dtype=torch.int32,
                      device=dev)
    if not alleles_per_bubble:
        pb_idx = pb.to(torch.int64)[:, :, None].expand(C, S, chunk)

    def reduce_keys(key, contained):
        k = torch.where(contained, key, no_match)             # [C, S, ch]
        if alleles_per_bubble:
            return k.view(C, B, alleles_per_bubble, chunk).amin(dim=2)
        out = torch.full((C, B, chunk), int(NO_MATCH), dtype=torch.int32,
                         device=dev)
        return out.scatter_reduce_(1, pb_idx, k, reduce="amin",
                                   include_self=True)

    for start in range(0, A, chunk):
        nd = nodes[:, start:start + chunk]                    # [C, ch, L]
        member = torch.zeros((C, chunk, V + 1), dtype=torch.float32,
                             device=dev)
        member.scatter_(2, torch.where(nd >= 0, nd, V), 1.0)
        member_t = member[:, :, :V].transpose(1, 2)           # [C, V, ch]
        cont_full = torch.matmul(pf, member_t) == plf_f       # [C, S, ch]
        cont_inner = torch.matmul(pi, member_t) == pli_f
        al_idx = torch.arange(aln_offset + start, aln_offset + start + chunk,
                              dtype=torch.int32, device=dev)
        key = pkb + al_idx                                    # [C, S, ch]
        gate = (ident[:, start:start + chunk] * 100.0
                > gate_mask_value)[:, None, :]
        pb3 = torch.stack([reduce_keys(key, cont_full),
                           reduce_keys(key, cont_inner),
                           reduce_keys(key, cont_inner & gate)], dim=1)
        names = name_id[:, start:start + chunk].to(torch.int64)
        keys.scatter_reduce_(3, names[:, None, None, :].expand(C, 3, B, chunk),
                             pb3, reduce="amin", include_self=True)
    return keys


def _compact(keys: torch.Tensor, extents, row_offset: int = 0):
    """[C, 3, B_pad, N_pad] device tables -> per chain a 3-tuple of
    SparseKeys cropped to that chain's (bubbles, names) extent.  The
    tables stay on the device; only the matched entries (``torch.nonzero``,
    row-major) cross to the host."""
    from ahsoka_tpu_torch.utils import substage

    C = keys.shape[0]
    with substage.timed("projection.fetch"):
        mask = keys != int(NO_MATCH)
        idx = torch.nonzero(mask).cpu().numpy()               # [nnz, 4]
        vals = keys[mask].cpu().numpy()
        substage.add("projection.fetch_calls", 1.0)
        # the two selections' counts and the two copies
        substage.count("device.round_trips", 4)
        substage.count("device.fetch_bytes", idx.nbytes + vals.nbytes)
    ct = idx[:, 0] * 3 + idx[:, 1]
    bounds = np.searchsorted(ct, np.arange(3 * C + 1))
    out = []
    for j, (rows, cols) in enumerate(extents):
        tabs = []
        for t in range(3):
            lo, hi = bounds[3 * j + t], bounds[3 * j + t + 1]
            r, c, v = idx[lo:hi, 2], idx[lo:hi, 3], vals[lo:hi]
            keep = (r < rows) & (c < cols)
            tabs.append(SparseKeys((rows + row_offset, cols),
                                   r[keep] + row_offset, c[keep], v[keep]))
        out.append(tuple(tabs))
    return out


def _onehot_tensor(oh, device) -> torch.Tensor:
    """int8 path table on the device from a dense or SparseOnehot form."""
    if isinstance(oh, SparseOnehot):
        t = torch.zeros(oh.shape, dtype=torch.int8, device=device)
        r, c = to_torch(oh.r, oh.c, device=device)
        t[r.long(), c.long()] = 1
        return t
    return to_torch(oh, device=device)[0]


def data_mesh(config: PhasingConfig, devices, dev: torch.device):
    """The data-sharded projection's mesh, or None when the device-count
    gate (``project/device.py:952-953`` of the JAX package) falls back."""
    return gated_mesh(getattr(config, "data_shards", 1), DATA_AXIS,
                      local_devices(devices, dev), dev, "projection")


def containment_key_tables(inputs: ChainDeviceInputs, config: PhasingConfig,
                           chunk: int = 1024, device="cuda", devices=None):
    """One chain's (full, partial, gated) winner tables as SparseKeys:
    ``containment_keys_core`` at a batch of one.  Chains whose key tables
    exceed _KEY_TABLE_BUDGET run in exact bubble blocks over one upload
    of the path tables (per device).  With ``config.data_shards`` > 1 and
    that many devices in ``devices`` (every process's), the alignments
    shard over them and the tables min-merge (``dist.step``)."""
    from ahsoka_tpu_torch.utils import substage

    dev = torch.device(device)
    mesh = data_mesh(config, devices, dev)
    with substage.timed("projection.pack"):
        arrays, statics = _padded_chain_arrays(inputs, chunk,
                                               dense_onehots=False)
    pf, pi, plf, pli, pb, pkb, nodes, name_id, ident = arrays
    B_pad, N_pad, chunk, apb = statics
    B, n_real = len(inputs.bubble_ids), len(inputs.names)
    gate = float(np.float32(config.partial_identity_gate))
    paths: Dict[torch.device, tuple] = {}

    def path_tables(d: torch.device) -> tuple:
        # the path tables, uploaded once per device (inside the caller's
        # projection.device timer)
        if d not in paths:
            paths[d] = ((_onehot_tensor(pf, d), _onehot_tensor(pi, d))
                        + to_torch(plf, pli, pb, pkb, device=d))
        return paths[d]

    with substage.timed("projection.device"):
        if mesh is None:
            alns = to_torch(nodes[None], name_id[None], ident[None],
                            device=dev)
        else:
            alns = shard_alignments(mesh, nodes, name_id, ident, chunk,
                                    len(inputs.names))
    nblocks = max(1, -(-(3 * B_pad * N_pad * 4) // _KEY_TABLE_BUDGET))
    Bb = -(-B_pad // nblocks)
    parts = []
    for b0 in range(0, B, Bb):
        bb = min(Bb, B_pad - b0)
        if apb:
            lo, hi = b0 * apb, (b0 + bb) * apb
        else:
            lo, hi = (int(x) for x in np.searchsorted(pb, [b0, b0 + bb]))

        def block(d, lo=lo, hi=hi, b0=b0):
            pf_d, pi_d, plf_d, pli_d, pb_d, pkb_d = path_tables(d)
            return (pf_d[None, lo:hi], pi_d[None, lo:hi], plf_d[None, lo:hi],
                    pli_d[None, lo:hi], pb_d[None, lo:hi] - b0,
                    pkb_d[None, lo:hi])

        kw = dict(num_bubbles=bb, num_names=N_pad, chunk=chunk,
                  alleles_per_bubble=apb)
        with substage.timed("projection.device"):
            if mesh is None:
                keys = containment_keys_core(*block(dev), *alns, gate, **kw)
            else:
                keys = sharded_containment_keys(mesh, block, alns, gate,
                                                **kw)
        parts.append(_compact(keys, [(min(bb, B - b0), n_real)],
                              row_offset=b0)[0])
    return tuple(
        SparseKeys((B, n_real),
                   np.concatenate([p[t].r for p in parts]),
                   np.concatenate([p[t].c for p in parts]),
                   np.concatenate([p[t].v for p in parts]))
        for t in range(3))


def containment_key_tables_many(inputs_list: Sequence[ChainDeviceInputs],
                                config: PhasingConfig, chunk: int = 1024,
                                device="cuda", devices=None):
    """Winner tables for MANY chains: chains are padded into bucketed
    shapes, grouped by (shape, statics) signature, and each group runs
    ``containment_keys_core`` over a written-out batch axis (split by a
    device working-set budget).  Same tables as per-chain
    ``containment_key_tables``, which a data-sharded projection runs
    chain by chain (its shards own the device axis;
    ``project/device.py:1017-1022`` of the JAX package)."""
    from ahsoka_tpu_torch.utils import substage

    dev = torch.device(device)
    if data_mesh(config, devices, dev) is not None:
        return [containment_key_tables(i, config, chunk, device=dev,
                                       devices=devices)
                for i in inputs_list]
    gate = float(np.float32(config.partial_identity_gate))
    with substage.timed("projection.pack"):
        padded = [_padded_chain_arrays(i, chunk) for i in inputs_list]
    groups: Dict[tuple, List[int]] = {}
    for idx, (arrays, statics) in enumerate(padded):
        sig = (statics, tuple((a.shape, a.dtype.str) for a in arrays))
        groups.setdefault(sig, []).append(idx)

    results: List = [None] * len(inputs_list)
    for (statics, _shapes), idxs in groups.items():
        B_pad, N_pad, g_chunk, apb = statics
        if 3 * B_pad * N_pad * 4 > _KEY_TABLE_BUDGET:
            for i in idxs:
                results[i] = containment_key_tables(inputs_list[i], config,
                                                    g_chunk, device=dev)
            continue
        S_pad, V_pad = padded[idxs[0]][0][0].shape
        per_chain = 4 * (2 * S_pad * V_pad + g_chunk * (V_pad + 1)
                         + 6 * S_pad * g_chunk + 6 * B_pad * N_pad)
        cap = max(1, _BATCH_DEVICE_BYTES // per_chain)
        for lo in range(0, len(idxs), cap):
            batch = idxs[lo:lo + cap]
            with substage.timed("projection.pack"):
                stacked = [np.stack([padded[i][0][k] for i in batch])
                           for k in range(9)]
            with substage.timed("projection.device"):
                tensors = to_torch(*stacked, device=dev)
                keys = containment_keys_core(
                    *tensors, gate, num_bubbles=B_pad, num_names=N_pad,
                    chunk=g_chunk, alleles_per_bubble=apb)
            extents = [(len(inputs_list[i].bubble_ids),
                        len(inputs_list[i].names)) for i in batch]
            for i, tabs in zip(batch, _compact(keys, extents)):
                results[i] = tabs
    return results


def build_chain_readsets_device(bubble_paths: Dict[int, List[List[int]]],
                                alignments: Sequence[Alignment],
                                config: PhasingConfig,
                                device="cuda") -> ChainReadsets:
    inputs = prepare_chain_inputs(bubble_paths, alignments)
    if inputs.num_alignments == 0 or inputs.num_paths == 0:
        from ahsoka_tpu_torch.project.readset import build_chain_readsets
        return build_chain_readsets(bubble_paths, alignments, config)
    full_keys, part_keys, gate_keys = containment_key_tables(
        inputs, config, device=device)
    return assemble_readsets(inputs, full_keys, part_keys, gate_keys, config)
