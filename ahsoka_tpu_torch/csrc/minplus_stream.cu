// General-ploidy haplotype-threading DP on Hopper (sm_90a): min-plus
// forward pass over the multiset state space, and its backtrace.
//
// Replaces the TPU Pallas kernels that compute this forward pass:
//   dpk_forward   <- _stream_kernel_ge (ahsoka_tpu/ops/minplus_stream.py,
//                    minplus_forward_streamed, ge=True: the default)
//                 <- _stream_kernel    (same file, ge=False)
//                 <- _dp_kernel        (ahsoka_tpu/ops/minplus.py,
//                    minplus_forward: all positions resident in VMEM)
//   dpk_backtrace <- the reverse XLA scan of thread_batch_pallas_streamed
//                    (ahsoka_tpu/thread/dp_pallas.py:127-133)
// The three Pallas bodies differ only in how they stage memory on a TPU
// (MXU GE-matmul or M min-and-add sweeps for the intersection; VMEM
// resident or HBM streamed); one kernel covers all three.
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
// k <= 2 (S = 2, 10) runs dpk_forward_small instead: one warp a chain on
// the CUDA cores, which measured faster there than 16 x 8 tensor-core
// tiles of mostly padding.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kFwdMaxWarps = 16;     // forward: at most 512 threads a CTA
constexpr int kFwdTargetWarps = 16;  // split the source range up to this
constexpr int kSmallThreads = 32;    // k <= 2: one warp, thread per state
constexpr int kAhead = 4;            // positions prefetched ahead
constexpr int kNodeRing = kAhead + 1;
constexpr int kCandRing = kAhead + 2;
constexpr int kBtThreads = 128;      // backtrace: chains per block

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

// k <= 2 (S = 2, 10): one warp per chain, a thread per destination state
// and a serial loop over the sources on the CUDA cores, slot counts as
// bytes four to a word.  At these sizes the tensor-core path pays for
// 16 x 8 tiles of mostly padding and a longer per-position chain.
template <int K>
__global__ void __launch_bounds__(kSmallThreads)
dpk_forward_small(const int* __restrict__ cand,         // [C, P, M]
                  const float* __restrict__ node,       // [C, P, S]
                  const unsigned* __restrict__ counts,  // [S, 1] byte-packed
                  int* __restrict__ bp,                 // [C, P, S]
                  float* __restrict__ final_cost,       // [C, S]
                  int P, int S, float switch_cost, float affine_cost) {
  constexpr int M = 2 * K;
  static_assert(M <= 4, "one count word a state");
  __shared__ unsigned cnt[kSmallThreads];
  __shared__ float cost[2][kSmallThreads];
  __shared__ int eqm[2][M];
  const int t = threadIdx.x;
  const size_t PS = static_cast<size_t>(P) * S;
  const size_t c = blockIdx.x;
  const int* cand_c = cand + c * P * M;
  const float* node_c = node + c * PS;
  int* bp_c = bp + c * PS;
  const float af1 = __fmul_rn(affine_cost, 1.0f);
  const float af0 = __fmul_rn(affine_cost, 0.0f);
  auto eq_mask = [&](int j, int mp) {
    const int prev = cand_c[(j - 1) * M + mp];
    int mask = 0;
    if (prev >= 0)
      for (int mc = 0; mc < M; ++mc)
        if (cand_c[j * M + mc] == prev) mask |= 1 << mc;
    return mask;
  };
  if (t < S) {
    cnt[t] = counts[t];
    cost[0][t] = node_c[t];
    bp_c[t] = 0;
  }
  if (P > 1 && t < M) eqm[1][t] = eq_mask(1, t);
  __syncthreads();
  int ct[M];
#pragma unroll
  for (int m = 0; m < M; ++m)
    ct[m] = t < S ? static_cast<int>((cnt[t] >> (8 * m)) & 0xffu) : 0;
  for (int j = 1; j < P; ++j) {
    const float* cprev = cost[(j - 1) & 1];
    const int* em = eqm[j & 1];
    if (j + 1 < P && t < M) eqm[(j + 1) & 1][t] = eq_mask(j + 1, t);
    if (t < S) {
      int mapped[M];
#pragma unroll
      for (int mp = 0; mp < M; ++mp) {
        int v = 0;
#pragma unroll
        for (int mc = 0; mc < M; ++mc) v += ((em[mp] >> mc) & 1) * ct[mc];
        mapped[mp] = v;
      }
      float best = 0.0f;
      int best_s = 0;
      for (int s = 0; s < S; ++s) {
        const unsigned w = cnt[s];
        int inter = 0;
#pragma unroll
        for (int mp = 0; mp < M; ++mp)
          inter += min(static_cast<int>((w >> (8 * mp)) & 0xffu), mapped[mp]);
        const int sw = K - inter;
        const float trans =
            __fadd_rn(__fmul_rn(switch_cost, static_cast<float>(sw)),
                      sw > 0 ? af1 : af0);
        const float total = __fadd_rn(cprev[s], trans);
        if (s == 0 || total < best) {
          best = total;
          best_s = s;
        }
      }
      const size_t row = static_cast<size_t>(j) * S;
      cost[j & 1][t] = __fadd_rn(best, node_c[row + t]);
      bp_c[row + t] = best_s;
    }
    __syncthreads();
  }
  if (t < S) final_cost[c * S + t] = cost[(P - 1) & 1][t];
}

__global__ void __launch_bounds__(kBtThreads)
dpk_backtrace(const int* __restrict__ bp,           // [C, P, S]
              const int* __restrict__ final_state,  // [C]
              int* __restrict__ states,             // [C, P]
              int C, int P, int S) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const int* bp_c = bp + static_cast<size_t>(c) * P * S;
  int* st_c = states + static_cast<size_t>(c) * P;
  int st = final_state[c];
  for (int j = P - 1; j >= 0; --j) {
    st_c[j] = st;
    if (j > 0) st = bp_c[static_cast<size_t>(j) * S + st];
  }
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
    if (G != 1 || S > kSmallThreads)
      return static_cast<int>(cudaErrorInvalidValue);
    dpk_forward_small<K><<<C, kSmallThreads, 0, stream>>>(
        static_cast<const int*>(cand), static_cast<const float*>(node),
        static_cast<const unsigned*>(counts), static_cast<int*>(bp),
        static_cast<float*>(final_cost), P, S, switch_cost, affine_cost);
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

int ahsoka_dpk_backtrace(const void* bp, const void* final_state,
                         void* states, int C, int P, int S, void* stream) {
  if (C > 0 && P > 0) {
    const int blocks = (C + kBtThreads - 1) / kBtThreads;
    dpk_backtrace<<<blocks, kBtThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(bp), static_cast<const int*>(final_state),
        static_cast<int*>(states), C, P, S);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* ahsoka_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
