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
// State s is a multiset of `k` candidate slots out of M = 2k, given by its
// slot counts counts[s][0..M-1] (ahsoka_tpu/thread/states.py
// full_state_counts); S = C(3k-1, k): 2, 10, 56, 330, 2002 for k = 1..5.
// Per position j >= 1 and destination state t:
//   eq[mp][mc] = cand[j-1][mp] == cand[j][mc] and cand[j-1][mp] >= 0
//   mapped[mp] = sum_mc counts[t][mc] * eq[mp][mc]
//   inter(s)   = sum_mp min(counts[s][mp], mapped[mp])
//   sw         = k - inter(s)
//   trans      = switch * sw + affine * [sw > 0]
//   cost'[t]   = min_s (cost[s] + trans) + node[j][t],  bp[j][t] = argmin
// Every term is a small integer, exact in float32.  trans is built from
// __fmul_rn/__fadd_rn, and cost + trans and min + node are one IEEE
// rounding each, as in the plain PyTorch version (ops/minplus.py; the
// build passes --fmad=false).  The argmin keeps the first minimum (strict <
// over ascending source states), like torch.argmin and jnp.argmin.
// bp[:, 0] = 0.  Invalid states carry the finite node cost 1e30 from the
// caller; the kernel adds no sentinel of its own.  Positions run to exactly
// P: unlike minplus_forward_streamed, nothing pads P to a block multiple.
//
// Design: one thread block per chain, threads strided over destination
// states.  The block keeps in shared memory the count table (slot counts
// as bytes, four to a word: 24 KB at k=5), the cost carry double-buffered
// ([2][S] floats: 16 KB at k=5) and, per position, one bitmask per
// previous slot of the current slots it matches (double-buffered, built by
// M threads one position ahead), so one __syncthreads() per position
// suffices.  Each thread holds mapped[] in registers (M is a template
// parameter, so the slot loops unroll) and runs a serial loop over the S
// source states, whose counts and costs every thread of a warp reads at
// the same address (a shared-memory broadcast).  Inputs and outputs keep
// the public [C, P, X] layout: node costs and backpointers of one
// position are contiguous in t, so the block's reads and writes coalesce.
//
// What bounds it: ~S*S*M integer operations per position and chain
// (871k at k=4, 40M at k=5) on one SM, with a block of at most 512
// threads; a launch fills min(C, 132) SMs.  At config3c's group (k=4,
// C=20) 20 of 132 SMs work.  Spreading a chain over several blocks and
// moving the 0/1 intersection onto the tensor cores (what the GE-matmul
// TPU body does on the MXU) are later work.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kMaxThreads = 512;     // forward: threads per block
constexpr int kBtThreads = 128;      // backtrace: chains per block

__device__ __forceinline__ int eq_mask(const int* cand_c, int j, int mp,
                                       int M) {
  const int prev = cand_c[(j - 1) * M + mp];
  int mask = 0;
  if (prev >= 0) {
    for (int mc = 0; mc < M; ++mc)
      if (cand_c[j * M + mc] == prev) mask |= 1 << mc;
  }
  return mask;
}

// counts of one state: M bytes, four to a word
template <int M>
__device__ __forceinline__ void unpack_counts(const unsigned* row,
                                              int (&out)[M]) {
  unsigned words[(M + 3) / 4];
#pragma unroll
  for (int w = 0; w < (M + 3) / 4; ++w) words[w] = row[w];
#pragma unroll
  for (int m = 0; m < M; ++m)
    out[m] = static_cast<int>((words[m / 4] >> (8 * (m % 4))) & 0xffu);
}

template <int M>
__global__ void __launch_bounds__(kMaxThreads)
dpk_forward(const int* __restrict__ cand,        // [C, P, M]
            const float* __restrict__ node,      // [C, P, S]
            const unsigned* __restrict__ counts, // [S, W] byte-packed
            int* __restrict__ bp,                // [C, P, S]
            float* __restrict__ final_cost,      // [C, S]
            int P, int S, int k, float switch_cost, float affine_cost) {
  constexpr int W = (M + 3) / 4;
  extern __shared__ unsigned smem[];
  unsigned* cnt = smem;                                        // [S * W]
  float* cost = reinterpret_cast<float*>(cnt + S * W);         // [2][S]
  int* eqm = reinterpret_cast<int*>(cost + 2 * S);             // [2][M]

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const size_t PS = static_cast<size_t>(P) * S;
  const size_t c = blockIdx.x;
  const int* cand_c = cand + c * P * M;
  const float* node_c = node + c * PS;
  int* bp_c = bp + c * PS;

  for (int i = tid; i < S * W; i += nthr) cnt[i] = counts[i];
  for (int s = tid; s < S; s += nthr) {
    cost[s] = node_c[s];
    bp_c[s] = 0;
  }
  if (P > 1 && tid < M) eqm[M + tid] = eq_mask(cand_c, 1, tid, M);
  __syncthreads();

  for (int j = 1; j < P; ++j) {
    const float* cprev = cost + ((j - 1) & 1) * S;
    float* cnext = cost + (j & 1) * S;
    const int* em = eqm + (j & 1) * M;
    if (j + 1 < P && tid < M)
      eqm[((j + 1) & 1) * M + tid] = eq_mask(cand_c, j + 1, tid, M);
    const size_t row = static_cast<size_t>(j) * S;

    for (int t = tid; t < S; t += nthr) {
      int ct[M];
      unpack_counts<M>(cnt + t * W, ct);
      int mapped[M];
#pragma unroll
      for (int mp = 0; mp < M; ++mp) {
        const int mask = em[mp];
        int v = 0;
#pragma unroll
        for (int mc = 0; mc < M; ++mc) v += ((mask >> mc) & 1) * ct[mc];
        mapped[mp] = v;
      }

      float best = 0.0f;
      int best_s = 0;
      for (int s = 0; s < S; ++s) {
        int cs[M];
        unpack_counts<M>(cnt + s * W, cs);
        int inter = 0;
#pragma unroll
        for (int mp = 0; mp < M; ++mp) inter += min(cs[mp], mapped[mp]);
        const int sw = k - inter;
        const float trans = __fadd_rn(
            __fmul_rn(switch_cost, static_cast<float>(sw)),
            __fmul_rn(affine_cost, sw > 0 ? 1.0f : 0.0f));
        const float total = __fadd_rn(cprev[s], trans);
        if (s == 0 || total < best) {
          best = total;
          best_s = s;
        }
      }
      cnext[t] = __fadd_rn(best, node_c[row + t]);
      bp_c[row + t] = best_s;
    }
    __syncthreads();
  }

  const float* cfin = cost + ((P - 1) & 1) * S;
  for (int s = tid; s < S; s += nthr)
    final_cost[c * S + s] = cfin[s];
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

template <int M>
int launch_forward(const void* cand, const void* node, const void* counts,
                   void* bp, void* final_cost, int C, int P, int S, int k,
                   float switch_cost, float affine_cost,
                   cudaStream_t stream) {
  constexpr int W = (M + 3) / 4;
  const size_t smem = sizeof(unsigned) * static_cast<size_t>(S) * W +
                      sizeof(float) * 2 * static_cast<size_t>(S) +
                      sizeof(int) * 2 * M;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dpk_forward<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int threads = ((S + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  dpk_forward<M><<<C, threads, smem, stream>>>(
      static_cast<const int*>(cand), static_cast<const float*>(node),
      static_cast<const unsigned*>(counts), static_cast<int*>(bp),
      static_cast<float*>(final_cost), P, S, k, switch_cost, affine_cost);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// M = 2k candidate slots selects the instantiation; k and S are runtime
// arguments.  Returns a cudaError_t (cudaErrorInvalidValue for an M the
// build has no instantiation for).
int ahsoka_dpk_forward(const void* cand, const void* node, const void* counts,
                       void* bp, void* final_cost, int C, int P, int S, int M,
                       int k, float switch_cost, float affine_cost,
                       void* stream) {
  if (C <= 0 || P <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (M) {
    case 2:
      return launch_forward<2>(cand, node, counts, bp, final_cost, C, P, S,
                               k, switch_cost, affine_cost, st);
    case 4:
      return launch_forward<4>(cand, node, counts, bp, final_cost, C, P, S,
                               k, switch_cost, affine_cost, st);
    case 6:
      return launch_forward<6>(cand, node, counts, bp, final_cost, C, P, S,
                               k, switch_cost, affine_cost, st);
    case 8:
      return launch_forward<8>(cand, node, counts, bp, final_cost, C, P, S,
                               k, switch_cost, affine_cost, st);
    case 10:
      return launch_forward<10>(cand, node, counts, bp, final_cost, C, P, S,
                                k, switch_cost, affine_cost, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
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
