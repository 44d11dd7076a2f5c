"""Configuration for the phasing pipeline.

The reference hard-codes its entire numeric configuration surface
(SURVEY.md §5 "Config / flag system"); here every constant is explicit, with
the reference's values as defaults:

- ploidy=2                      (src/alignmentstoreadset.cpp:306)
- variant quality 30            (src/alignmentstoreadset.cpp:94,118)
- mapq threshold 93             (src/alignmentstoreadset.cpp:158,270)
- partial identity gate 90      (src/alignmentstoreadset.cpp:245)
- min read-pair overlap 1       (src/alignmentstoreadset.cpp:311)
- switch costs 32.0 / 8.0       (src/alignmentstoreadset.cpp:320)
- coverage cutoff 1/(8*ploidy)  (src/alignmentstoreadset.cpp:768)
- genotypes {0:1, 1:1}          (src/alignmentstoreadset.cpp:342)
- simple-bubble criterion: exactly 2 inner nodes (src/chainstoreadset.cpp:172)
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class PhasingConfig:
    """All tunable pipeline parameters.  Defaults reproduce the reference."""

    # --- core ---
    ploidy: int = 2
    # per-chain ploidy overrides for mixed-ploidy samples (BASELINE
    # config 5's whole-genome shape: diploid chromosomes next to
    # tetraploid/hexaploid subgenomes).  Maps ENGINE chain ids to
    # ploidy; chains absent from the map use `ploidy`.  Every pipeline
    # stage from DP-input construction (covmap candidate caps,
    # genotypes) through threading (per-ploidy state spaces, batched in
    # per-ploidy groups) and emission runs at the chain's own k.
    # The reference pins k=2 globally (src/alignmentstoreadset.cpp:306);
    # this generalises the whole per-chain pipeline instead.
    ploidy_map: Optional[dict] = None

    # --- readset construction (projection) ---
    variant_quality: int = 30          # quality stored per variant
    mapq_scale: float = 100.0          # mapq = alignment identity * this
    mapq_threshold: float = 93.0       # keep reads with mapq >= this
    min_variants: int = 2              # keep reads with > 1 variants
    partial_identity_gate: float = 90.0  # mapq gate for adding variants to
    # an existing read during the partial pass (strictly greater-than),
    # src/alignmentstoreadset.cpp:245

    # --- pairwise read scoring ---
    min_overlap: int = 1               # minimum shared positions per pair
    error_rate: float = 0.07           # per-position allele error rate eps
    # (the reference's WhatsHap core estimates this locally; we expose it and
    #  also support data-driven estimation, see score/pairwise.py)
    estimate_error_rate: bool = True
    # "whatshap": ReadScoring::scoreReadsetLocal as published in the
    # polyphase paper — binomial LLR with quantile-estimated p_s and
    # per-pair p_d from multiplicity-rounded local allele frequencies
    # (score/whatshap.py); "fresh": this repo's per-position-weight LLR
    # derivation (score/pairwise.py)
    score_mode: str = "whatshap"

    # --- cluster editing ---
    # "whatshap": the induced-cost heuristic's published decision rule
    # (max-icf edge -> permanent, max-icp edge -> forbidden, larger max
    # first; cluster/editing.py); "fresh": this repo's max(icf,icp)
    # positive-edge greedy
    ce_mode: str = "whatshap"

    # --- cluster selection per position ---
    # keep between ploidy and 2*ploidy clusters per position; cut when the
    # relative coverage drops below 1/(coverage_cutoff_denom * ploidy)
    coverage_cutoff_denom: float = 8.0

    # --- haplotype threading DP ---
    switch_cost: float = 32.0
    affine_switch_cost: float = 8.0
    # weights of the per-position (node) cost terms; the reference's WhatsHap
    # HaploThreader combines coverage deviation and genotype conformity
    coverage_cost_weight: float = 1.0
    genotype_cost_weight: float = 1.0
    use_genotypes: bool = True
    # "reference": every position gets the balanced biallelic genotype
    # ((k+1)//2, k//2) — the reference's hard-coded diploid {0:1,1:1}
    # (src/alignmentstoreadset.cpp:341-344) generalised.  "balanced":
    # per-position greedy-ML allocation of the k slots to the observed
    # alleles (cluster/postprocess.balanced_genotypes) — the prior to
    # use for ploidy>2 where bubbles carry more than two alleles
    genotype_prior: str = "reference"

    # --- compat switches (reference quirks, SURVEY.md §7 "hard parts" #5) ---
    # bucket an alignment once per node of its path into its chain(s)
    # (src/alignmentreader.cpp:176-183); False dedups per (read, chain)
    compat_duplicate_bucketing: bool = True
    # the partial readset replaces the full one (src/alignmentstoreadset.cpp:296)
    compat_partial_replaces_full: bool = True
    # replicate libstdc++ unordered_map iteration order for chain/bubble ids
    compat_std_ordering: bool = True

    # --- execution ---
    backend: str = "jax"               # "jax" (TPU tensor programs) | "host"
    # thread all chains with one batched device DP program per chain group
    # (jax backend); False runs the DP chain by chain
    batch_dp: bool = True
    # cap per-position read coverage before scoring (None = off).  Deep
    # coverage makes the pair graph quadratically dense (every read
    # overlaps ~coverage x span others); capping at ~64 is the standard
    # phasing practice and bounds scoring/clustering cost.  Off by default
    # for reference parity.
    max_coverage: Optional[int] = None
    # chains with more reads than this score in diagonal-band blocks and
    # cluster on the sparse edge list (the dense [R, R] pair matrix is
    # never materialised)
    banded_scoring_threshold: int = 4096
    # host-byte cap on batched-scoring slices: the batched phasing fetches
    # at most this many bytes of [G, G] float64 score matrices before
    # the cluster stage consumes (and frees) them — whole-genome ragged
    # runs hold sum(G^2) doubles (~100 GB at config5's shape) otherwise
    score_fetch_budget_bytes: int = 4 << 30
    # --- identical-read collapsing (project/collapse.py) ---
    # Reads with byte-identical allele rows are interchangeable: collapse
    # them before scoring + cluster editing, score G distinct rows with
    # multiplicity-weighted statistics (byte-equal scores), run CE on the
    # weighted group graph (edge w = m_u * m_v * s — the exact supernode
    # weight WhatsHap accumulates when contracting duplicate pairs), and
    # expand the clusters.  Cuts config4-chain clustering+scoring by the
    # duplicate factor squared.  Divergence from the uncollapsed decision
    # trace is possible only when the exact greedy would not merge two
    # identical reads; measured in scripts/profile_ce.py and bounded by
    # the fast-path contract test.  Collapse only engages at or above
    # ce_collapse_min_reads so small (golden-parity) chains keep the
    # exact uncollapsed trace.
    ce_collapse_identical: bool = True
    ce_collapse_min_reads: int = 256
    # collapse only when the distinct-row count is at most this fraction
    # of the reads.  The regime study of scripts/
    # quantify_fastpaths.py found the one contract violation at
    # high-noise/low-redundancy (G/R = 0.53: collapsed switch error
    # 2.1x exact, just over fastpath_accept_factor); at production
    # redundancy (config4 0.15-0.26, config2 0.37) the collapsed
    # clusters are identical or indistinguishable downstream.  Above
    # the gate the chain runs the exact uncollapsed path.
    ce_collapse_max_ratio: float = 0.5
    # --- fast-path acceptance contract ---
    # The production fast-path stack (identical-read collapsing, banded
    # scoring + approximate sparse CE above banded_scoring_threshold,
    # coverage capping) must stay within this factor of the exact
    # pipeline's planted-truth switch error — with a small absolute
    # floor for near-zero baselines — on the divergence-study regimes
    # (scripts/quantify_fastpaths.py REGIMES).  The contract is enforced
    # by tests/test_fastpath_contract.py on a representative scale every
    # CI run; a production configuration that cannot meet it must switch
    # the offending path off (ce_collapse_identical=False, raise
    # banded_scoring_threshold, max_coverage=None) rather than ship the
    # regression.
    fastpath_accept_factor: float = 2.0
    fastpath_accept_floor: float = 0.02
    # shard alignment batches over this many mesh devices during
    # projection (1 = single device); per-shard winner tables merge with a
    # min collective (SURVEY.md §2c data parallelism)
    data_shards: int = 1
    # shard the batched threading DP's chain axis over this many mesh
    # devices (1 = single device); chains are independent, so the
    # shard_map is a pure scatter (SURVEY.md §2c chain parallelism)
    chain_shards: int = 1
    # host worker threads for per-chain pass-1 (projection prep, scoring,
    # clustering): chains are embarrassingly parallel; device calls
    # serialise inside jax, host/native stages overlap (ctypes releases
    # the GIL).  The reference's -t flag fan-out (src/polyassembly.cpp:
    # 178-222, fixed 2 threads over the 10 largest chains) generalised.
    threads: int = 1
    # multi-process chain sharding: partition chains round-robin (in
    # size-sorted order) across jax.distributed processes; every device
    # call stays process-local, per-chain result files are written by
    # their owner, and rank 0 merges the aggregate -result.txt after a
    # cross-process barrier.  The production layout for many-chain
    # workloads (chains are embarrassingly parallel — the reference's
    # 2-thread split, src/polyassembly.cpp:178-222, scaled to hosts);
    # the default global-mesh mode instead runs collectives across
    # processes for giant-single-chain workloads.  Requires a shared
    # filesystem and data_shards == chain_shards == 1.
    process_chain_sharding: bool = False
    # write the per-chain readset debug dumps (the reference's
    # -chainN-readset[_final].txt); requires the object-based readset
    # assembly, so turn off for large-scale runs
    debug_readset_files: bool = True
    # bucket padding for batched per-chain execution
    max_states: Optional[int] = None   # override DP state-space cap

    # --- threading-DP beam pruning (the WhatsHap rowLimit analog,
    # HaploThreader ctor src/alignmentstoreadset.cpp:320) ---
    # 0 = exact DP.  > 0: keep only the dp_beam_width cheapest states
    # per position (jax.lax.top_k; ties -> lowest state index).  With
    # beam >= S the result is exactly the full DP (parity-tested);
    # smaller beams are approximate with deterministic pruning.
    # Required for ploidy 6, where the exact [S, S] transition tensor
    # (S = 12376) exceeds device memory; 2048 retains the full exact
    # space of every ploidy <= 5 position.
    dp_beam_width: int = 0

    # DP state-space ceiling.  The threading DP enumerates multisets of
    # size `ploidy` over up to 2*ploidy candidate clusters: S = C(3k-1, k)
    # states (k=2: 10, k=3: 56, k=4: 330, k=5: 2002, k=6: 12376).  Each
    # exact scan step materialises [S, S] transition tensors — ~16 MB/
    # position at k=5; k=6 (~0.6 GB/position) requires the beam-pruned
    # DP (dp_beam_width > 0).  Beyond k=6 even the beam's [B, S] frontier
    # outgrows device memory (S = C(20, 7) = 77520 at k=7).
    MAX_PLOIDY = 6

    def __post_init__(self):
        from math import comb
        if self.ploidy_map:
            for cid, k_c in self.ploidy_map.items():
                # each mapped ploidy must satisfy the same constraints
                # as a global one (range, beam requirements)
                dataclasses.replace(self, ploidy=int(k_c),
                                    ploidy_map=None)
        k = self.ploidy
        S = comb(3 * k - 1, k) if k >= 1 else 0
        if not 1 <= self.ploidy <= self.MAX_PLOIDY:
            raise ValueError(
                f"ploidy={k} is outside the supported range 1.."
                f"{self.MAX_PLOIDY}: the threading DP state space is "
                f"S = C(3k-1, k) = {S} multisets, and each DP step "
                f"builds [S, S] transition tensors "
                f"(~{4 * S * S / 2**20:.0f} MB/position) — beyond "
                f"ploidy {self.MAX_PLOIDY} even a pruned frontier "
                f"exceeds device memory. Split the sample or phase "
                f"per-subgenome instead.")
        if k >= 6 and not self.dp_beam_width:
            raise ValueError(
                f"ploidy={k} requires the beam-pruned DP: the exact "
                f"[S, S] transition tensor at S = {S} needs "
                f"~{4 * S * S / 2**20:.0f} MB per scan step. Set "
                f"dp_beam_width (e.g. 2048; --dp-beam-width on the "
                f"CLI) to cap retained states per position — the "
                f"WhatsHap rowLimit concept.")
        if k >= 6 and self.dp_beam_width >= S:
            # _beam_width_for disables the beam when S <= beam_width, so
            # a too-wide beam would silently run the exact [S, S] path
            # this check exists to prevent (~0.6 GB/position at k=6)
            raise ValueError(
                f"ploidy={k} with dp_beam_width={self.dp_beam_width} "
                f">= S={S} would run the exact full-width DP "
                f"(~{4 * S * S / 2**20:.0f} MB per scan step — device "
                f"OOM); choose a beam width below {S}.")

    def num_states(self, num_candidates: int) -> int:
        """Number of multisets of size `ploidy` from `num_candidates` clusters."""
        from math import comb

        return comb(num_candidates + self.ploidy - 1, self.ploidy)


DIPLOID = PhasingConfig(ploidy=2)
TETRAPLOID = PhasingConfig(ploidy=4)
