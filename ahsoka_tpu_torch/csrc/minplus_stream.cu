// Haplotype-threading DP on Hopper (sm_90a), every ploidy 1-5: min-plus
// forward pass over the multiset state space, and its backtrace.
//
// Replaces the TPU kernels that compute them:
//   dpk_forward      <- _stream_kernel_ge (ahsoka_tpu/ops/minplus_stream.py,
//                       minplus_forward_streamed, ge=True: the default)
//                    <- _stream_kernel    (same file, ge=False)
//                    <- _dp_kernel        (ahsoka_tpu/ops/minplus.py,
//                       minplus_forward: all positions resident in VMEM)
//                       k >= 3 (S = 56, 330, 2002)
//   dpk_forward_warp <- _dp2_kernel (ahsoka_tpu/ops/minplus_diploid.py,
//                       minplus_forward_diploid_raw), and the same Pallas
//                       bodies at k = 1: k <= 2 (S = 2, 10)
//   dpk_backtrace    <- _bt2_kernel (ahsoka_tpu/ops/minplus_diploid.py,
//                       backtrace_diploid) and the reverse XLA scan of
//                       thread_batch_pallas_streamed
//                       (ahsoka_tpu/thread/dp_pallas.py:127-133)
// The Pallas bodies differ in how they stage memory on a TPU (MXU
// GE-matmul or M min-and-add sweeps for the intersection; VMEM resident
// or HBM streamed; 1024 diploid chains over an [8, 128] vreg); the
// function is one, and the kernels here split it by state count only.
//
// State s is a multiset of k candidate slots out of M = 2k, given by its
// slot counts counts[s][0..M-1] (thread/states.py full_state_counts);
// S = C(3k-1, k): 2, 10, 56, 330, 2002 for k = 1..5.  Per position j >= 1
// and destination state t:
//   eq[mp][mc] = cand[j-1][mp] == cand[j][mc] and cand[j-1][mp] >= 0
//   mapped[mp] = sum_mc counts[t][mc] * eq[mp][mc]
//   inter(s)   = sum_mp min(counts[s][mp], mapped[mp])
//   sw         = k - inter(s)
//   trans      = switch * sw + affine * [sw > 0]
//   cost'[t]   = min_s (cost[s] + trans) + node[j][t],  bp[j][t] = argmin
// trans is built from __fmul_rn/__fadd_rn, and cost + trans and min + node
// are one IEEE rounding each, as in the plain PyTorch version
// (ops/minplus.py; the build passes --fmad=false).  The argmin keeps the
// first minimum (strict < over ascending source states), like torch.argmin
// and jnp.argmin.  bp[:, 0] = 0.  Invalid states carry the finite node cost
// 1e30 from the caller; the kernel adds no sentinel of its own.  Positions
// run to exactly P: unlike minplus_forward_streamed on the TPU, nothing
// pads P to a block multiple.
//
// What bounds it.  Per chain and position the min-plus step is S*S cells
// of an fp32 add and compare (109k at k=4, 4.0M at k=5) plus the M*k 0/1
// products of each cell's intersection: at config3c's group (k=4, C=20,
// P=256) 1.1 G fp32 operations and 1.1 G int8 ones, 0.035 ms at the
// card's 67 TFLOP/s and 1,979 TOP/s; the bytes (node costs in,
// backpointers out) take less.  The P positions form a serial chain, so
// each position pays a fixed latency, and a group of few chains can fill
// the card only by spreading each chain over several SMs.  On an H100 a
// position of one P=2048 tetraploid chain at G = 16 takes 3.9 us: 1.2
// us the m-tile loop, 0.5 us the B build, 0.7 us the cluster barrier
// over a CTA barrier, 1.5 us the rest (prefetch, lane reductions,
// stores); at k = 5 the m-tile loop is 21 of 25 us
// (tools/dpk_forward_ablation.py, PERF.md).
//
// Design (k >= 3):
// * A chain runs on a thread-block cluster of G CTAs (G in 1, 2, 4, 8,
//   16, chosen by the wrapper: the C clusters must all fit on the card at
//   once, and each CTA keeps at least 4096 cells a position).  CTA r owns
//   the contiguous slice of destination states [r*Tc, (r+1)*Tc).  Every
//   CTA holds the full cost vector of the previous position (double-
//   buffered in shared memory); after computing its slice of the new
//   costs it stores each value into the next buffer of every CTA of the
//   cluster through distributed shared memory (the 8 lanes that hold a
//   column's result share the stores), then one cluster barrier per
//   position publishes them (one __syncthreads when G = 1).
// * The intersection runs on the int8 tensor cores, exactly:
//     min(a, b) = sum_{u=1..k} [a >= u] * [b >= u]   for 0 <= a, b <= k,
//   so inter = A * B with A[s][(mp,u)] = [counts[s][mp] >= u], a fixed 0/1
//   table built once on the host (ge_planes in ops/minplus_stream.py) and
//   held in shared memory for the whole launch, and B[(mp,u)][t] =
//   -[mapped_t[mp] >= u], built per position in registers in the
//   B-fragment layout of mma.sync.m16n8k32.s8.  K = M*k pairs padded to 32
//   (64 at k=5); the plane order puts the slot index on the lane (mp =
//   4*blk + lane%4) and the threshold u in the unrolled register index,
//   so each lane needs mapped[] for at most three slots.  Integer sums of
//   0/1 products are exact in any order.  This is the GE-matmul of the TPU
//   body (_stream_kernel_ge) on Hopper's int8 tensor cores; at k = 4 it
//   measured 2.4x faster than the same kernel with the intersection on
//   the CUDA cores (__vminu4 + __dp4a over byte-packed counts, PERF.md).
//   The accumulator starts at the bit pattern of 1.5 * 2^23 + k, so it
//   ends as that of the float 1.5 * 2^23 + (k - inter): one subtraction
//   gives the switch count as a float.
// * Each lane turns its accumulator cells into cost[s] + trans and keeps a
//   running (best, first s) per destination column over ascending s; a
//   lexicographic (value, index) reduction across lanes, and across the SP
//   warps that split the source range when a CTA has few columns and the
//   SM few CTAs, keeps the lowest s among equal totals.
// * Node costs of the CTA's slice and candidate rows are prefetched four
//   positions ahead with cp.async while earlier positions compute.
// * With several CTAs an SM (many chains), CTAs run fewer warps so that
//   every chain is resident at once, as far as shared memory lets that
//   many CTAs share an SM (at k = 5 one CTA fills it).
//
// k <= 2 (S = 2, 10) runs dpk_forward_warp instead (a 16 x 8 tensor-core
// tile would be mostly padding).  What bounds it: nothing of the card's
// rates (config4's group, C=1000, P=56, is 0.0016 ms of bytes); one
// chain is P - 1 dependent positions, so the time is P times the latency
// of one position.  The design keeps that latency to the carry's own
// dependency chain:
// * One warp a chain (a CTA of one warp, so many-chain groups spread over
//   every SM and no CTA barrier exists).  Lane t < S holds cost[t] in a
//   register.
// * Tiles of T positions of the chain's candidates [T, M] and node costs
//   [T, S] (contiguous rows) are staged into shared memory with cp.async,
//   double-buffered: tile i+1 is in flight while tile i is scanned.  No
//   global load is left on the per-position path.
// * Everything that does not depend on the carry is done a tile at a
//   time, in parallel over the tile's (position, destination) pairs: the
//   eq masks, mapped[] and each source's switch count sw = k - inter,
//   packed 2 bits a source (20 bits at S = 10) into one word a pair.
// * A position is then: S shuffles of the previous costs, total_s =
//   cost_s + trans[sw_s] (a (k+1)-entry table built once; one rounding),
//   a balanced (value, index) minimum that lets the lower index win every
//   tie (equal to the strict-< scan over ascending s), and the staged
//   node cost added.  Only shuffles synchronise the lanes.
// * Backpointers go to a shared tile and leave as one coalesced store of
//   T * S words a tile.
//
// dpk_backtrace (every k): a CTA a chain.  The chain's backpointer rows
// [j0, j1) are one contiguous [j1 - j0, S] block; tiles of rows stream in
// from the end backwards with cp.async into a double buffer sized to
// shared memory, the tile is walked there (a shared-memory load a step
// instead of a dependent global one), and the CTA stores the tile's
// states coalesced.  At S <= 10 the walk of a tile is split into 32
// segments: each lane maps all S states at its segment's top through the
// segment (S independent walks), one thread chains the 32 maps, and each
// lane walks its segment again from its entry state.  At larger S one
// thread walks the tile: S walks a lane cost more than they save, and
// segments of S = 56 rows would share banks 8 lanes to one.  Bound: the P - 1 backpointers the walk follows; the
// tiles move all (P - 1) * S of them, which sets the time once the walk
// is short.
//
// Tiles are staged with cp.async and not TMA bulk copies: a bulk copy
// needs 16-byte aligned addresses and sizes, and a chain's rows are 40
// bytes at S = 10, 8 at M = 2 and 4 * S in the backtrace.  The staging
// copies 16-byte chunks where source and destination can be aligned
// alike (the destination is offset by the source's address mod 16) and
// single words at the ragged ends.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kFwdMaxWarps = 16;     // forward: at most 512 threads a CTA
constexpr int kFwdTargetWarps = 16;  // split the source range up to this
constexpr int kAhead = 4;            // positions prefetched ahead
constexpr int kNodeRing = kAhead + 1;
constexpr int kCandRing = kAhead + 2;
constexpr int kWarpTileMax = 128;    // k <= 2: positions a staged tile
constexpr int kBtThreads = 128;      // backtrace: threads a chain
constexpr int kBtRowsMax = 1024;     // backtrace: rows a staged tile
constexpr int kBtSegments = 32;      // backtrace: segments of a tile's walk
constexpr int kBtSegStates = 10;     // ... at S up to this
// shared memory the k <= 2 forward and the backtrace let the CTAs of one
// SM take together, so that every chain of a launch is resident at once
constexpr size_t kSmemPerSm = 200 * 1024;
constexpr size_t kSmemPerCta = 227 * 1024;

// Compile-time layout of one ploidy k (M = 2k slots).
template <int K>
struct Layout {
  static constexpr int M = 2 * K;
  static constexpr int KPAD = (M * K <= 32) ? 32 : 64;  // plane bytes a row
  static constexpr int KS = KPAD / 32;                  // mma k-steps
  static constexpr int NB = (M + 3) / 4;                // slot blocks
  static constexpr int SLOTS = KPAD / 4;                // bytes a lane holds
  static constexpr int STRIDE_A = KPAD + 16;            // conflict-free rows
  static constexpr int W = (M + 3) / 4;                 // packed count words
  static_assert(K * NB <= SLOTS, "plane layout does not fit");
};

// Launch geometry of one (k, S, G) when each SM holds ``per_sm`` CTAs,
// shared by the launcher and the occupancy query.  The source range is
// split over SP warps only as far as the SM's own warps need it: with
// several CTAs an SM, their warps hide each other's latency instead.
struct Geometry {
  int S16, MT, Tc, Tc16, NI, SP, warps;
  size_t smem;
};

template <int K>
Geometry geometry(int S, int G, int per_sm) {
  using L = Layout<K>;
  Geometry g;
  g.S16 = (S + 15) / 16 * 16;
  g.MT = g.S16 / 16;
  g.Tc = (S + G - 1) / G;
  g.Tc16 = (g.Tc + 15) / 16 * 16;
  g.NI = g.Tc16 / 16;                  // items of two 8-column n-tiles
  int sp = kFwdTargetWarps / per_sm / g.NI;
  if (sp < 1) sp = 1;
  if (sp > g.MT) sp = g.MT;
  g.SP = sp;
  int warps = g.NI * g.SP;
  g.warps = warps < kFwdMaxWarps ? warps : kFwdMaxWarps;
  g.smem = static_cast<size_t>(g.S16) * L::STRIDE_A      // A planes
           + sizeof(float) * 2 * g.S16                   // cost, 2 buffers
           + sizeof(float) * kNodeRing * g.Tc16          // node slice ring
           + sizeof(int) * kCandRing * L::M              // candidate ring
           + (g.SP > 1 ? (sizeof(float) + sizeof(int)) *
                             static_cast<size_t>(g.SP) * g.Tc16
                       : 0);                             // split partials
  return g;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most kAhead - 1 groups (the rows after the next) pend
__device__ __forceinline__ void cp_async_wait_next() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead - 1) : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// Words of a staging buffer for n words: 3 words of slack for the
// alignment offset, a multiple of 4 so that the next buffer stays
// 16-byte aligned.
__host__ __device__ constexpr int stage_words(int n) {
  return (n + 3 + 3) / 4 * 4;
}

// Where word 0 of a staged copy of ``src`` lands in its buffer: the
// buffer is offset by the source's address mod 16, so that source and
// destination are 16-byte aligned at the same words.
__device__ __forceinline__ int stage_offset(const void* src) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
}

// Copy n words from src (4-byte aligned) into buf + stage_offset(src)
// (buf 16-byte aligned, stage_words(n) long) with cp.async, threads
// lane = 0..nthr-1 sharing the copies: 16-byte chunks in the middle,
// single words at the ragged ends.  The caller commits the group.
__device__ __forceinline__ void stage_async(void* buf, const void* src,
                                            int n, int lane, int nthr) {
  const int off = stage_offset(src);
  int* dst = static_cast<int*>(buf) + off;
  const int* s = static_cast<const int*>(src);
  const int head = min(n, (4 - off) & 3);
  const int chunks = (n - head) / 4;
  const int tail = head + 4 * chunks;
  if (lane < head) cp_async4(dst + lane, s + lane);
  for (int i = lane; i < chunks; i += nthr)
    cp_async16(dst + head + 4 * i, s + head + 4 * i);
  for (int i = tail + lane; i < n; i += nthr) cp_async4(dst + i, s + i);
}

// d += a * b on the int8 tensor cores (m16n8k32, s32 accumulators)
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The accumulator starts at kBias + k and B holds -1 where the plane is
// set, so it ends as kBias + (k - inter): the bit pattern of the float
// 1.5 * 2^23 + sw, exact for |sw| < 2^22, so one float subtraction gives
// sw = k - inter without an int-to-float conversion.
constexpr int kBias = 0x4B400000;    // 12582912.0f

// One cell: total = cost_s + trans(sw), kept when strictly below best.
__device__ __forceinline__ void relax(int acc, float cost_s, int s,
                                      float sw_cost, float af1, float af0,
                                      float& best, int& bidx) {
  const float sw = __fsub_rn(__int_as_float(acc), 12582912.0f);
  const float trans = __fadd_rn(__fmul_rn(sw_cost, sw),
                                sw > 0.0f ? af1 : af0);
  const float total = __fadd_rn(cost_s, trans);
  if (total < best) {
    best = total;
    bidx = s;
  }
}

// (value, index) minimum over the 8 lanes of a column (lane bits 2-4),
// the lower index winning a tie
__device__ __forceinline__ void lexmin_lanes(float& v, int& i) {
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (ov < v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

// A fragments (rows 16*mt + g and + 8, bytes 4q.. of each 16-byte half)
// and the source costs of those two rows
template <int K>
__device__ __forceinline__ void load_a(const int8_t* A, const float* cprev,
                                       int mt, int g, int q,
                                       unsigned (&a)[Layout<K>::KS][4],
                                       float& c_lo, float& c_hi) {
  using L = Layout<K>;
  const int r0 = mt * 16 + g;
  const int8_t* arow = A + r0 * L::STRIDE_A + 4 * q;
#pragma unroll
  for (int ks = 0; ks < L::KS; ++ks) {
    a[ks][0] = *reinterpret_cast<const unsigned*>(arow + 32 * ks);
    a[ks][1] =
        *reinterpret_cast<const unsigned*>(arow + 8 * L::STRIDE_A + 32 * ks);
    a[ks][2] = *reinterpret_cast<const unsigned*>(arow + 32 * ks + 16);
    a[ks][3] = *reinterpret_cast<const unsigned*>(arow + 8 * L::STRIDE_A +
                                                  32 * ks + 16);
  }
  c_lo = cprev[r0];
  c_hi = cprev[r0 + 8];
}

// B fragments of one 8-column n-tile for this lane: column t, slots
// mp = 4*blk + q, register i holding plane bytes 16*i + 4*q + b, each
// -1 where mapped[mp] >= u (int8), else 0.
template <int K>
__device__ __forceinline__ void build_b(const int* __restrict__ prev,
                                        const int* __restrict__ cur,
                                        const unsigned* __restrict__ counts,
                                        int t, int q,
                                        unsigned (&b)[Layout<K>::KS][2]) {
  using L = Layout<K>;
  const unsigned* row = counts + static_cast<size_t>(t) * L::W;
  unsigned words[L::W];
#pragma unroll
  for (int w = 0; w < L::W; ++w) words[w] = __ldg(row + w);
  int curv[L::M];
#pragma unroll
  for (int mc = 0; mc < L::M; ++mc) curv[mc] = cur[mc];
  int mapped[L::NB];
#pragma unroll
  for (int blk = 0; blk < L::NB; ++blk) {
    const int mp = 4 * blk + q;
    int v = 0;
    if (mp < L::M) {
      const int pv = prev[mp];
      if (pv >= 0) {
#pragma unroll
        for (int mc = 0; mc < L::M; ++mc) {
          const int cnt = (words[mc / 4] >> (8 * (mc % 4))) & 0xff;
          v += curv[mc] == pv ? cnt : 0;
        }
      }
    }
    mapped[blk] = v;
  }
#pragma unroll
  for (int i = 0; i < 2 * L::KS; ++i) {
    unsigned word = 0;
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) {
      const int sigma = 4 * i + bb;
      const int u = sigma / L::NB + 1;
      if (u <= K && mapped[sigma % L::NB] >= u) word |= 0xffu << (8 * bb);
    }
    b[i / 2][i % 2] = word;
  }
}

template <int K>
__global__ void __launch_bounds__(kFwdMaxWarps * 32)
dpk_forward(const int* __restrict__ cand,          // [C, P, M]
            const float* __restrict__ node,        // [C, P, S]
            const int8_t* __restrict__ planes,     // [S, KPAD] 0/1
            const unsigned* __restrict__ counts,   // [S, W] byte-packed
            int* __restrict__ bp,                  // [C, P, S]
            float* __restrict__ final_cost,        // [C, S]
            int P, int S, int G, int Tc, int SP, float switch_cost,
            float affine_cost) {
  using L = Layout<K>;
  constexpr int M = L::M;
  extern __shared__ __align__(16) unsigned char smem[];
  const int S16 = (S + 15) / 16 * 16;
  const int MT = S16 / 16;
  const int Tc16 = (Tc + 15) / 16 * 16;
  const int NI = Tc16 / 16;
  int8_t* A = reinterpret_cast<int8_t*>(smem);                  // [S16][STRIDE_A]
  float* cfull = reinterpret_cast<float*>(smem + static_cast<size_t>(S16) *
                                                     L::STRIDE_A);  // [2][S16]
  float* node_s = cfull + 2 * S16;                       // [kNodeRing][Tc16]
  int* cand_s = reinterpret_cast<int*>(node_s + kNodeRing * Tc16);  // [ring][M]
  float* red_v = reinterpret_cast<float*>(cand_s + kCandRing * M);  // [SP][Tc16]
  int* red_i = reinterpret_cast<int*>(red_v + SP * Tc16);       // [SP][Tc16]

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int nwarps = nthr >> 5;
  const int rank = static_cast<int>(blockIdx.x) % G;
  const size_t c = blockIdx.x / G;
  const int t0 = rank * Tc;
  const int tc = S - t0 < Tc ? S - t0 : Tc;      // may be <= 0 (no columns)
  const size_t PS = static_cast<size_t>(P) * S;
  const int* cand_c = cand + c * P * M;
  const float* node_c = node + c * PS;
  int* bp_c = bp + c * PS;
  const float inf = __int_as_float(0x7f800000);
  const float af1 = __fmul_rn(affine_cost, 1.0f);
  const float af0 = __fmul_rn(affine_cost, 0.0f);
  // node costs of row r (this CTA's slice) and candidate row r, async
  auto prefetch_row = [&](int r) {
    if (r >= P) return;
    float* dst = node_s + (r % kNodeRing) * Tc16;
    const float* src = node_c + static_cast<size_t>(r) * S + t0;
    for (int i = tid; i < tc; i += nthr) cp_async4(dst + i, src + i);
    if (tid < M)
      cp_async4(cand_s + (r % kCandRing) * M + tid,
                cand_c + static_cast<size_t>(r) * M + tid);
  };

  // the plane table, rows S..S16-1 zero
  constexpr int CH = L::KPAD / 16;
  for (int i = tid; i < S16 * CH; i += nthr) {
    const int row = i / CH, ch = i % CH;
    int4 v = make_int4(0, 0, 0, 0);
    if (row < S)
      v = __ldg(reinterpret_cast<const int4*>(planes + row * L::KPAD) + ch);
    *reinterpret_cast<int4*>(A + row * L::STRIDE_A + ch * 16) = v;
  }
  for (int s = tid; s < S16; s += nthr) {
    cfull[s] = s < S ? node_c[s] : inf;
    cfull[S16 + s] = inf;
  }
  for (int i = tid; i < tc; i += nthr) bp_c[t0 + i] = 0;
  if (tid < M) cand_s[tid] = cand_c[tid];
  // rows 1..kAhead in flight, one cp.async group each (empty past P - 1)
  for (int r = 1; r <= kAhead; ++r) {
    prefetch_row(r);
    cp_async_commit();
  }
  cp_async_wait_next();
  // peers write into this CTA's cost buffers only after its set-up
  if (G > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();

  for (int j = 1; j < P; ++j) {
    const int cur = j & 1;
    const float* cprev = cfull + (cur ^ 1) * S16;
    float* cnext = cfull + cur * S16;
    const float* node_j = node_s + (j % kNodeRing) * Tc16;
    prefetch_row(j + kAhead);
    cp_async_commit();
    const int* cprow = cand_s + ((j - 1) % kCandRing) * M;
    const int* ccrow = cand_s + (j % kCandRing) * M;
    const size_t row = static_cast<size_t>(j) * S;

    for (int item = warp; item < NI * SP; item += nwarps) {
      const int ni = item / SP, sp = item % SP;
      float best[2][2];
      int bidx[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          best[nt][p] = inf;
          bidx[nt][p] = 0;
        }
      unsigned bfr[2][L::KS][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int lc = ni * 16 + nt * 8 + g;
        const int t = lc < tc ? t0 + lc : 0;
        build_b<K>(cprow, ccrow, counts, t, q, bfr[nt]);
      }
      // A fragments and source costs of the next m-tile load while the
      // current one computes
      unsigned a[L::KS][4];
      float c_lo = 0.0f, c_hi = 0.0f;
      if (sp < MT) load_a<K>(A, cprev, sp, g, q, a, c_lo, c_hi);
      for (int mt = sp; mt < MT; mt += SP) {
        const int r0 = mt * 16 + g;
        unsigned an[L::KS][4];
        float n_lo = 0.0f, n_hi = 0.0f;
        if (mt + SP < MT) load_a<K>(A, cprev, mt + SP, g, q, an, n_lo, n_hi);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          int acc[4] = {kBias + K, kBias + K, kBias + K, kBias + K};
#pragma unroll
          for (int ks = 0; ks < L::KS; ++ks)
            mma_s8(acc, a[ks], bfr[nt][ks][0], bfr[nt][ks][1]);
          // rows r0 then r0 + 8: ascending s within each column
          relax(acc[0], c_lo, r0, switch_cost, af1, af0, best[nt][0],
                bidx[nt][0]);
          relax(acc[1], c_lo, r0, switch_cost, af1, af0, best[nt][1],
                bidx[nt][1]);
          relax(acc[2], c_hi, r0 + 8, switch_cost, af1, af0, best[nt][0],
                bidx[nt][0]);
          relax(acc[3], c_hi, r0 + 8, switch_cost, af1, af0, best[nt][1],
                bidx[nt][1]);
        }
#pragma unroll
        for (int ks = 0; ks < L::KS; ++ks)
#pragma unroll
          for (int x = 0; x < 4; ++x) a[ks][x] = an[ks][x];
        c_lo = n_lo;
        c_hi = n_hi;
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          // every lane of the column's 8 ends with its (best, first s)
          lexmin_lanes(best[nt][p], bidx[nt][p]);
          const int lc = ni * 16 + nt * 8 + 2 * q + p;
          if (lc >= tc) continue;
          if (SP > 1) {
            if (g == 0) {
              red_v[sp * Tc16 + lc] = best[nt][p];
              red_i[sp * Tc16 + lc] = bidx[nt][p];
            }
            continue;
          }
          const float v = __fadd_rn(best[nt][p], node_j[lc]);
          if (g == 0) {
            bp_c[row + t0 + lc] = bidx[nt][p];
            if (G == 1) cnext[t0 + lc] = v;
          }
          // lane g stores into CTAs g, g + 8 of the cluster
          if (G > 1)
            for (int r = g; r < G; r += 8)
              cg::this_cluster().map_shared_rank(cnext, r)[t0 + lc] = v;
        }
    }
    if (SP > 1) {
      __syncthreads();
      // several threads a column when the slice is narrow, each storing
      // into its share of the cluster's CTAs
      const int parts = tc > 0 ? max(1, min(G, nthr / tc)) : 1;
      for (int i = tid; i < tc * parts; i += nthr) {
        const int lc = i % tc, part = i / tc;
        float bv = red_v[lc];
        int bi = red_i[lc];
        for (int sp = 1; sp < SP; ++sp) {
          const float v = red_v[sp * Tc16 + lc];
          const int x = red_i[sp * Tc16 + lc];
          if (v < bv || (v == bv && x < bi)) {
            bv = v;
            bi = x;
          }
        }
        const float v = __fadd_rn(bv, node_j[lc]);
        if (part == 0) {
          bp_c[row + t0 + lc] = bi;
          if (G == 1) cnext[t0 + lc] = v;
        }
        if (G > 1)
          for (int r = part; r < G; r += parts)
            cg::this_cluster().map_shared_rank(cnext, r)[t0 + lc] = v;
      }
    }
    cp_async_wait_next();
    // the new costs (and, for the next position, its node slice and
    // candidate row) visible to every CTA of the cluster
    if (G > 1)
      cg::this_cluster().sync();
    else
      __syncthreads();
  }

  const float* cfin = cfull + ((P - 1) & 1) * S16;
  for (int i = tid; i < tc; i += nthr)
    final_cost[c * S + t0 + i] = cfin[t0 + i];
}

// Layout of the shared memory of one k <= 2 chain at tile size T, in
// words: two staging buffers each of candidates and node costs, the
// transition costs of every (position, destination, source) of the tile
// (a row of SP >= S floats a pair), the eq bits of each position, the
// tile's backpointers, the candidate row before the tile.
struct WarpTiles {
  int cand, node, trans, eq, bp, prev, words;
};

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

__host__ __device__ inline WarpTiles warp_tiles(int T, int M, int S) {
  WarpTiles w{};
  w.cand = stage_words(T * M);
  w.node = stage_words(T * S);
  w.trans = 2 * w.cand + 2 * w.node;
  w.eq = w.trans + T * S * round4(S);
  w.bp = w.eq + round4(T);
  w.prev = w.bp + round4(T * S);
  w.words = w.prev + 4;
  return w;
}

template <int K>
struct Small {
  static constexpr int M = 2 * K;
  static constexpr int S = K == 1 ? 2 : 10;  // C(3k - 1, k)
  static constexpr int SP = (S + 3) / 4 * 4;  // a transition row, floats
  static constexpr unsigned SLOTS = (1u << M) - 1;
  static_assert(K == 1 || K == 2, "the one-warp forward takes k <= 2");
};

// The min-plus step of destination lane t at one position: cost_s of
// every source from its lane plus the staged transition cost, then the
// minimum with the lowest s among equal totals.  A balanced reduction:
// every source left of a merge has a lower index than every one right of
// it, so strict < keeps the first minimum.
template <int K>
__device__ __forceinline__ void minplus_step(float cost, const float* trow,
                                             float& best, int& bidx) {
  constexpr int S = Small<K>::S, SP = Small<K>::SP;
  float tr[SP];
#pragma unroll
  for (int q = 0; q < SP / 4; ++q) {
    const float4 f = reinterpret_cast<const float4*>(trow)[q];
    tr[4 * q] = f.x;
    tr[4 * q + 1] = f.y;
    tr[4 * q + 2] = f.z;
    tr[4 * q + 3] = f.w;
  }
  float v[S];
  int ix[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    v[s] = __fadd_rn(__shfl_sync(0xffffffffu, cost, s), tr[s]);
    ix[s] = s;
  }
#pragma unroll
  for (int step = 1; step < S; step <<= 1)
#pragma unroll
    for (int a = 0; a + step < S; a += 2 * step)
      if (v[a + step] < v[a]) {
        v[a] = v[a + step];
        ix[a] = ix[a + step];
      }
  best = v[0];
  bidx = ix[0];
}

template <int K>
__global__ void __launch_bounds__(32)
dpk_forward_warp(const int* __restrict__ cand,         // [C, P, M]
                 const float* __restrict__ node,       // [C, P, S]
                 const unsigned* __restrict__ counts,  // [S] byte-packed
                 int* __restrict__ bp,                 // [C, P, S]
                 float* __restrict__ final_cost,       // [C, S]
                 int P, int T, float switch_cost, float affine_cost) {
  constexpr int M = Small<K>::M, S = Small<K>::S, SP = Small<K>::SP;
  constexpr unsigned SLOTS = Small<K>::SLOTS;
  extern __shared__ __align__(16) int smem_w[];
  // the state's threshold planes: bit (u - 1) * M + m is
  // [counts[s][m] >= u], so that sum_m min(a[m], b[m]) is the popcount of
  // the planes' AND for 0 <= a, b <= k
  __shared__ unsigned planes_s[S];
  const WarpTiles L = warp_tiles(T, M, S);
  int* cand_buf = smem_w;                                    // [2][L.cand]
  float* node_buf = reinterpret_cast<float*>(smem_w + 2 * L.cand);
  float* trans_s = reinterpret_cast<float*>(smem_w + L.trans);  // [T*S][SP]
  unsigned* eq_s = reinterpret_cast<unsigned*>(smem_w + L.eq);  // [T]
  int* bp_s = smem_w + L.bp;                                 // [T * S]
  int* prev_s = smem_w + L.prev;                             // [M]
  const int lane = threadIdx.x;
  const size_t c = blockIdx.x;
  const int* cand_c = cand + c * P * M;
  const float* node_c = node + c * P * S;
  int* bp_c = bp + c * P * S;
  if (lane < S) {
    const unsigned w = __ldg(counts + lane);
    unsigned pl = 0;
#pragma unroll
    for (int u = 1; u <= K; ++u)
#pragma unroll
      for (int m = 0; m < M; ++m)
        if (((w >> (8 * m)) & 0xffu) >= static_cast<unsigned>(u))
          pl |= 1u << ((u - 1) * M + m);
    planes_s[lane] = pl;
  }
  float tr[K + 1];                      // transition cost by switch count
#pragma unroll
  for (int u = 0; u <= K; ++u)
    tr[u] = __fadd_rn(__fmul_rn(switch_cost, static_cast<float>(u)),
                      __fmul_rn(affine_cost, u > 0 ? 1.0f : 0.0f));
  auto stage_tile = [&](int i) {
    const int j0 = i * T, n = min(T, P - j0), b = i & 1;
    stage_async(cand_buf + b * L.cand, cand_c + static_cast<size_t>(j0) * M,
                n * M, lane, 32);
    stage_async(node_buf + b * L.node, node_c + static_cast<size_t>(j0) * S,
                n * S, lane, 32);
    cp_async_commit();
  };

  const int ntiles = (P + T - 1) / T;
  stage_tile(0);
  float cost = 0.0f;
  for (int i = 0; i < ntiles; ++i) {
    const int j0 = i * T, n = min(T, P - j0), b = i & 1;
    const int* ct = cand_buf + b * L.cand +
                    stage_offset(cand_c + static_cast<size_t>(j0) * M);
    const float* nt = node_buf + b * L.node +
                      stage_offset(node_c + static_cast<size_t>(j0) * S);
    cp_async_wait<0>();
    __syncwarp();
    // eq bits of each position: bit mp * M + mc where previous slot mp
    // carries current slot mc's (real) cluster
    for (int jj = lane; jj < n; jj += 32) {
      const int* prow = jj > 0 ? ct + (jj - 1) * M : prev_s;
      const int* crow = ct + jj * M;
      unsigned e = 0;
#pragma unroll
      for (int mp = 0; mp < M; ++mp) {
        const int pv = prow[mp];
#pragma unroll
        for (int mc = 0; mc < M; ++mc)
          if (pv >= 0 && crow[mc] == pv) e |= 1u << (mp * M + mc);
      }
      eq_s[jj] = e;
    }
    __syncwarp();
    // transition costs of every (position, destination) pair of the
    // tile: mapped[mp] = sum_mc counts[t][mc] eq[mp][mc] is the popcount
    // of t's planes under the eq row repeated over the k planes; its
    // threshold planes against each source's give inter, sw = k - inter
    for (int x = lane; x < n * S; x += 32) {
      const int jj = x / S, t = x - jj * S;
      const unsigned e = eq_s[jj], at = planes_s[t];
      unsigned bpl = 0;
#pragma unroll
      for (int mp = 0; mp < M; ++mp) {
        unsigned row = (e >> (mp * M)) & SLOTS;
#pragma unroll
        for (int u = 1; u < K; ++u) row |= row << M;
        const int mapped = __popc(row & at);
#pragma unroll
        for (int u = 1; u <= K; ++u)
          if (mapped >= u) bpl |= 1u << ((u - 1) * M + mp);
      }
      float row_tr[SP];
#pragma unroll
      for (int s = 0; s < SP; ++s) {
        const int sw = K - (s < S ? __popc(planes_s[s] & bpl) : K);
        float v = tr[0];
#pragma unroll
        for (int u = 1; u <= K; ++u)
          if (sw == u) v = tr[u];
        row_tr[s] = v;
      }
      float4* dst = reinterpret_cast<float4*>(trans_s + x * SP);
#pragma unroll
      for (int q = 0; q < SP / 4; ++q)
        dst[q] = make_float4(row_tr[4 * q], row_tr[4 * q + 1],
                             row_tr[4 * q + 2], row_tr[4 * q + 3]);
    }
    __syncwarp();
    if (lane < M) prev_s[lane] = ct[(n - 1) * M + lane];
    if (i + 1 < ntiles) stage_tile(i + 1);
    __syncwarp();
    // the serial scan: registers, shuffles and the staged tile only
    int jj = 0;
    if (j0 == 0) {
      if (lane < S) {
        cost = nt[lane];
        bp_s[lane] = 0;
      }
      jj = 1;
    }
    const int tl = lane < S ? lane : 0;   // lanes >= S shadow lane 0
#pragma unroll 4
    for (; jj < n; ++jj) {
      const float nd = nt[jj * S + tl];
      float best;
      int bidx;
      minplus_step<K>(cost, trans_s + (jj * S + tl) * SP, best, bidx);
      cost = __fadd_rn(best, nd);
      if (lane < S) bp_s[jj * S + lane] = bidx;
    }
    __syncwarp();
    int* bp_tile = bp_c + static_cast<size_t>(j0) * S;
    for (int x = lane; x < n * S; x += 32) bp_tile[x] = bp_s[x];
  }
  if (lane < S) final_cost[c * S + lane] = cost;
}

// Shared memory of the backtrace at R rows a tile: two staging buffers
// of R * S backpointers, the tile's R states, and for a segmented walk
// (G > 1) each segment's state map and entry state.
__host__ __device__ inline size_t bt_smem_bytes(int R, int S, int G) {
  return sizeof(int) *
         (2 * static_cast<size_t>(stage_words(R * S)) + round4(R) +
          (G > 1 ? static_cast<size_t>(G) * S + G : 0));
}

__global__ void __launch_bounds__(kBtThreads)
dpk_backtrace(const int* __restrict__ bp,           // [C, P, S]
              const int* __restrict__ final_state,  // [C]
              int* __restrict__ states,             // [C, P]
              int P, int S, int R, int G) {
  extern __shared__ __align__(16) int smem_b[];
  const int bw = stage_words(R * S);
  int* st_tile = smem_b + 2 * bw;                   // [R]
  int* seg_map = st_tile + round4(R);               // [G][S]
  int* seg_in = seg_map + G * S;                    // [G]
  const int tid = threadIdx.x;
  const size_t c = blockIdx.x;
  const int* bp_c = bp + c * P * S;
  int* st_c = states + c * P;
  // tile i holds rows [j0, j1) = [P - (i + 1) R, P - i R) clipped at 0;
  // row 0's backpointers are never followed, so a tile stages rows
  // [max(j0, 1), j1)
  auto rows = [&](int i, int& j0, int& j1) {
    j1 = P - i * R;
    j0 = j1 - R > 0 ? j1 - R : 0;
  };
  auto stage_tile = [&](int i) {
    int j0, j1;
    rows(i, j0, j1);
    const int jl = j0 > 1 ? j0 : 1;
    if (j1 > jl)
      stage_async(smem_b + (i & 1) * bw, bp_c + static_cast<size_t>(jl) * S,
                  (j1 - jl) * S, tid, kBtThreads);
    cp_async_commit();
  };
  const int ntiles = (P + R - 1) / R;
  int st = final_state[c];                          // state at row j1 - 1
  stage_tile(0);
  for (int i = 0; i < ntiles; ++i) {
    int j0, j1;
    rows(i, j0, j1);
    const int jl = j0 > 1 ? j0 : 1;
    if (i + 1 < ntiles) {
      stage_tile(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int* tile = smem_b + (i & 1) * bw +
                      stage_offset(bp_c + static_cast<size_t>(jl) * S);
    // state at row j - 1 from the state x at row j >= 1
    auto step = [&](int j, int x) { return tile[(j - jl) * S + x]; };
    if (G == 1) {
      // one thread walks the tile: a row pointer stepped down, so that a
      // step is one address add and one shared-memory load
      if (tid == 0) {
        const int* row = tile + (j1 - 1 - jl) * S;
        int* out = st_tile + (j1 - 1 - j0);
#pragma unroll 4
        for (int j = j1 - 1; j >= jl; --j) {
          *out-- = st;
          st = row[st];
          row -= S;
        }
        if (j0 == 0) st_tile[0] = st;
      }
    } else {
      // segmented: segment g holds rows [j0 + g * seg, j0 + (g+1) seg)
      // Each lane maps every state at its segment's top row through the
      // segment (S walks at once), one thread chains the maps from the
      // tile's top, then each lane walks its segment from its entry.
      // an odd segment length puts the lanes' rows (seg * S words apart,
      // S even) on different banks: at most 2 lanes share one
      const int seg = (j1 - j0 + G - 1) / G | 1;
      const int a = j0 + tid * seg, b = min(j1, a + seg);
      if (tid < G) {
        // 16 of the S walks at a time, in registers
        for (int e0 = 0; e0 < S; e0 += 16) {
          int x[16];
#pragma unroll
          for (int q = 0; q < 16; ++q) x[q] = e0 + q < S ? e0 + q : 0;
          for (int j = b - 1; j >= a && j > 0; --j) {
            const int* row = tile + (j - jl) * S;
#pragma unroll
            for (int q = 0; q < 16; ++q) x[q] = row[x[q]];
          }
#pragma unroll
          for (int q = 0; q < 16; ++q)
            if (e0 + q < S) seg_map[tid * S + e0 + q] = x[q];
        }
      }
      __syncthreads();
      if (tid == 0) {
        for (int g = G - 1; g >= 0; --g) {
          seg_in[g] = st;
          st = seg_map[g * S + st];
        }
      }
      __syncthreads();
      if (tid < G) {
        int x = seg_in[tid];
        for (int j = b - 1; j >= a; --j) {
          st_tile[j - j0] = x;
          if (j > 0) x = step(j, x);
        }
      }
    }
    __syncthreads();
    for (int x = tid; x < j1 - j0; x += kBtThreads) st_c[j0 + x] = st_tile[x];
  }
}

// streaming multiprocessors of the current device (asked once a device)
cudaError_t sm_count(int* sms) {
  static int known[64] = {};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device < 64 && known[device] > 0) {
    *sms = known[device];
    return cudaSuccess;
  }
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess && device < 64) known[device] = *sms;
  return e;
}

// allow ``smem`` bytes of dynamic shared memory (needed above 48 KB)
template <typename F>
cudaError_t allow_smem(F kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int K>
cudaError_t prepare(int S, int G, int per_sm, Geometry* geo) {
  *geo = geometry<K>(S, G, per_sm);
  cudaError_t e = cudaFuncSetAttribute(
      dpk_forward<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(geo->smem));
  if (e != cudaSuccess) return e;
  if (G > 8)
    e = cudaFuncSetAttribute(dpk_forward<K>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  return e;
}

void cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                    const Geometry& geo, int C, int G, cudaStream_t stream) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(static_cast<unsigned>(C) * G, 1, 1);
  cfg->blockDim = dim3(geo.warps * 32, 1, 1);
  cfg->dynamicSmemBytes = geo.smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = G;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

template <int K>
int launch_forward(const void* cand, const void* node, const void* planes,
                   const void* counts, void* bp, void* final_cost, int C,
                   int P, int S, int G, float switch_cost, float affine_cost,
                   cudaStream_t stream) {
  if constexpr (K <= 2) {
    constexpr int M = Small<K>::M;
    if (G != 1 || S != Small<K>::S)
      return static_cast<int>(cudaErrorInvalidValue);
    // the largest tile (down to 32 positions) at which the chains' warps
    // each SM has to hold all fit its shared memory at once
    int sms = 0;
    cudaError_t e = sm_count(&sms);
    if (e != cudaSuccess) return static_cast<int>(e);
    const size_t per_sm = (static_cast<size_t>(C) + sms - 1) / sms;
    int T = P < kWarpTileMax ? P : kWarpTileMax;
    while (T > 32 && per_sm * sizeof(int) * warp_tiles(T, M, S).words >
                         kSmemPerSm)
      T = (T + 1) / 2;
    const size_t smem = sizeof(int) * warp_tiles(T, M, S).words;
    e = allow_smem(dpk_forward_warp<K>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    dpk_forward_warp<K><<<C, 32, smem, stream>>>(
        static_cast<const int*>(cand), static_cast<const float*>(node),
        static_cast<const unsigned*>(counts), static_cast<int*>(bp),
        static_cast<float*>(final_cost), P, T, switch_cost, affine_cost);
    return static_cast<int>(cudaGetLastError());
  } else {
    // CTAs each SM holds: as many as keep all C*G CTAs resident at once,
    // but no more than its shared memory fits.  With several, each CTA
    // runs fewer warps (the register file sets how many warps an SM
    // holds).
    cudaFuncAttributes fa;
    int device = 0, sms = 0;
    cudaError_t e = cudaFuncGetAttributes(&fa, dpk_forward<K>);
    if (e == cudaSuccess) e = cudaGetDevice(&device);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (e != cudaSuccess) return static_cast<int>(e);
    const long ctas = static_cast<long>(C) * G;
    int per_sm = static_cast<int>((ctas + sms - 1) / sms);
    Geometry geo;
    e = prepare<K>(S, G, per_sm, &geo);
    if (e == cudaSuccess && per_sm > 1) {
      int fit = 0;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, dpk_forward<K>,
                                                        32, geo.smem);
      if (e == cudaSuccess && fit < per_sm) {
        per_sm = fit > 1 ? fit : 1;
        e = prepare<K>(S, G, per_sm, &geo);
      }
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    const int sm_warps = 65536 / (32 * (fa.numRegs > 0 ? fa.numRegs : 1));
    const int cap = sm_warps / per_sm;
    geo.warps = geo.warps < cap ? geo.warps : (cap > 1 ? cap : 1);
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cluster_config(&cfg, &attr, geo, C, G, stream);
    e = cudaLaunchKernelEx(
        &cfg, dpk_forward<K>, static_cast<const int*>(cand),
        static_cast<const float*>(node), static_cast<const int8_t*>(planes),
        static_cast<const unsigned*>(counts), static_cast<int*>(bp),
        static_cast<float*>(final_cost), P, S, G, geo.Tc, geo.SP,
        switch_cost, affine_cost);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
  }
}

template <int K>
int max_clusters(int S, int G, int* out) {
  Geometry geo;
  cudaError_t e = prepare<K>(S, G, 1, &geo);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, geo, 1, G, nullptr);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(out, dpk_forward<K>, &cfg));
}

}  // namespace

extern "C" {

// Ploidy k = M / 2 selects the instantiation; S and the cluster size G
// are runtime arguments.  Returns a cudaError_t (cudaErrorInvalidValue for
// an M the build has no instantiation for).
int ahsoka_dpk_forward(const void* cand, const void* node, const void* planes,
                       const void* counts, void* bp, void* final_cost, int C,
                       int P, int S, int M, int G, float switch_cost,
                       float affine_cost, void* stream) {
  if (C <= 0 || P <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (M) {
#define AHSOKA_CASE(K)                                                      \
  case 2 * K:                                                               \
    return launch_forward<K>(cand, node, planes, counts, bp, final_cost, C, \
                             P, S, G, switch_cost, affine_cost, st);
    AHSOKA_CASE(1)
    AHSOKA_CASE(2)
    AHSOKA_CASE(3)
    AHSOKA_CASE(4)
    AHSOKA_CASE(5)
#undef AHSOKA_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Clusters of G CTAs of the forward kernel at (M, S) that the current
// device holds at once (cudaOccupancyMaxActiveClusters), into *out.
int ahsoka_dpk_max_clusters(int M, int S, int G, int* out) {
  *out = 0;
  switch (M) {
    case 6: return max_clusters<3>(S, G, out);
    case 8: return max_clusters<4>(S, G, out);
    case 10: return max_clusters<5>(S, G, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Backtrace of C chains: a CTA a chain, R rows a staged tile, R as large
// as lets the CTAs each SM has to hold fit its shared memory at once; a
// segmented walk (G = 32 segments) where S <= kBtSegStates and a tile
// has at least 2G rows.
int ahsoka_dpk_backtrace(const void* bp, const void* final_state,
                         void* states, int C, int P, int S, void* stream) {
  if (C <= 0 || P <= 0) return static_cast<int>(cudaSuccess);
  int sms = 0;
  cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t per_sm = (static_cast<size_t>(C) + sms - 1) / sms;
  size_t budget = kSmemPerSm / per_sm;
  if (budget > kSmemPerCta) budget = kSmemPerCta;
  const int G = S <= kBtSegStates ? kBtSegments : 1;
  int R = P < kBtRowsMax ? P : kBtRowsMax;
  while (R > 1 && bt_smem_bytes(R, S, G) > budget) R = (R + 1) / 2;
  const int g = R >= 2 * G ? G : 1;
  const size_t smem = bt_smem_bytes(R, S, g);
  e = allow_smem(dpk_backtrace, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dpk_backtrace<<<C, kBtThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(bp), static_cast<const int*>(final_state),
      static_cast<int*>(states), P, S, R, g);
  return static_cast<int>(cudaGetLastError());
}

const char* ahsoka_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
