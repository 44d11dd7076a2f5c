// Diploid haplotype-threading DP on Hopper (sm_90a): min-plus forward
// pass and backtrace, one CUDA thread per chain.
//
// Replaces the TPU Pallas kernels of ahsoka_tpu/ops/minplus_diploid.py:
//   dp2_forward   <- _dp2_kernel  (minplus_forward_diploid_raw)
//   dp2_backtrace <- _bt2_kernel  (backtrace_diploid)
//
// The TPU kernel packs 1024 chains into one [8, 128] vreg and streams
// position blocks through double-buffered VMEM.  Here every chain is one
// thread: its 10-entry cost carry and its 4 previous candidate ids stay
// in registers across all P positions, and nothing is staged in shared
// memory.  Inputs come in a chain-minor layout ([P, 4, C] candidates,
// [P, 10, C] node costs, [P, 10, C] backpointers, written by the Python
// wrapper), so the 32 threads of a warp read and write 32 neighbouring
// words at every access.  Any C and any P: the launch covers
// ceil(C / 128) blocks and each thread checks its chain index; positions
// run to exactly P (no padding positions).
//
// What bounds it on the card: per position a thread reads 56 bytes and
// writes 40, and does ~600 integer/float operations, so the kernel is
// neither HBM- nor ALU-bound at the main path's shapes.  At config4
// (C ~ 1000 chains) the launch fills ~8 blocks of 128 threads on 132
// SMs: it is latency-bound, one dependent chain of loads and a 100-way
// min per position.  Making it fast (more chains per SM, splitting the
// 10 target states across threads, overlapping loads) is later work.
//
// Arithmetic.  State s is the multiset (U(s), V(s)) of candidate slots,
// in itertools.combinations_with_replacement(range(4), 2) order.  The
// transition cost is the general multiset form of
// ahsoka_tpu/thread/dp_jax.py:110-118:
//   mapped[mp]  = #copies in the target state of a current slot whose id
//                 equals prev slot mp's id (ids >= 0 only)
//   inter       = sum_mp min(count_prev[mp], mapped[mp])
//   switches    = 2 - inter
//   trans       = switch * switches + affine * [switches > 0]
// Every term is a small integer, exact in float32.  total = cost + trans
// and new = min(total) + node are single IEEE roundings, as in the plain
// PyTorch version (built with --fmad=false).  The argmin keeps the lowest
// source state on a tie (strict <), like jnp.argmin / torch.argmin.
// bp[0] = 0.  Node costs carry the JAX package's finite sentinel 1e30 for
// invalid states; the kernel adds no sentinel of its own.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kM = 4;          // candidate slots (2 * ploidy)
constexpr int kS = 10;         // diploid states C(4 + 2 - 1, 2)
constexpr int kThreads = 128;  // threads (chains) per block

// state s -> (U(s), V(s)): 0:(0,0) 1:(0,1) 2:(0,2) 3:(0,3) 4:(1,1)
// 5:(1,2) 6:(1,3) 7:(2,2) 8:(2,3) 9:(3,3)
__host__ __device__ constexpr int state_u(int s) {
  return s < 4 ? 0 : (s < 7 ? 1 : (s < 9 ? 2 : 3));
}
__host__ __device__ constexpr int state_v(int s) {
  return s < 4 ? s : (s < 7 ? s - 3 : (s < 9 ? s - 5 : 3));
}

__global__ void __launch_bounds__(kThreads)
dp2_forward(const int* __restrict__ cand,    // [P, M, C]
            const float* __restrict__ node,  // [P, S, C]
            int* __restrict__ bp,            // [P, S, C]
            float* __restrict__ final_cost,  // [S, C]
            int C, int P, float switch_cost, float affine_cost) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const size_t Cz = static_cast<size_t>(C);

  float cost[kS];
  int prev[kM];
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    cost[s] = node[s * Cz + c];
    bp[s * Cz + c] = 0;
  }
#pragma unroll
  for (int m = 0; m < kM; ++m) prev[m] = cand[m * Cz + c];

  for (int j = 1; j < P; ++j) {
    const size_t jc = static_cast<size_t>(j);
    int cur[kM];
#pragma unroll
    for (int m = 0; m < kM; ++m) cur[m] = cand[(jc * kM + m) * Cz + c];

    // eq[mp][mc]: previous slot mp carries the same (real) cluster as
    // current slot mc
    int eq[kM][kM];
#pragma unroll
    for (int mp = 0; mp < kM; ++mp) {
#pragma unroll
      for (int mc = 0; mc < kM; ++mc)
        eq[mp][mc] = (prev[mp] == cur[mc] && prev[mp] >= 0) ? 1 : 0;
    }

    float next[kS];
#pragma unroll
    for (int t = 0; t < kS; ++t) {
      const int a = state_u(t), b = state_v(t);
      int mapped[kM];
#pragma unroll
      for (int mp = 0; mp < kM; ++mp) mapped[mp] = eq[mp][a] + eq[mp][b];

      float best = 0.0f;
      int best_s = 0;
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        const int u = state_u(s), v = state_v(s);
        const int inter = (u == v)
                              ? min(2, mapped[u])
                              : min(1, mapped[u]) + min(1, mapped[v]);
        const int sw = 2 - inter;
        const float trans = __fadd_rn(
            __fmul_rn(switch_cost, static_cast<float>(sw)),
            __fmul_rn(affine_cost, sw > 0 ? 1.0f : 0.0f));
        const float total = __fadd_rn(cost[s], trans);
        if (s == 0 || total < best) {
          best = total;
          best_s = s;
        }
      }
      next[t] = __fadd_rn(best, node[(jc * kS + t) * Cz + c]);
      bp[(jc * kS + t) * Cz + c] = best_s;
    }
#pragma unroll
    for (int s = 0; s < kS; ++s) cost[s] = next[s];
#pragma unroll
    for (int m = 0; m < kM; ++m) prev[m] = cur[m];
  }
#pragma unroll
  for (int s = 0; s < kS; ++s) final_cost[s * Cz + c] = cost[s];
}

__global__ void __launch_bounds__(kThreads)
dp2_backtrace(const int* __restrict__ bp,           // [P, S, C]
              const int* __restrict__ final_state,  // [C]
              int* __restrict__ states,             // [P, C]
              int C, int P) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const size_t Cz = static_cast<size_t>(C);
  int st = final_state[c];
  for (int j = P - 1; j >= 0; --j) {
    const size_t jc = static_cast<size_t>(j);
    states[jc * Cz + c] = st;
    if (j > 0) st = bp[(jc * kS + st) * Cz + c];
  }
}

}  // namespace

extern "C" {

int ahsoka_dp2_forward(const void* cand, const void* node, void* bp,
                       void* final_cost, int C, int P, float switch_cost,
                       float affine_cost, void* stream) {
  if (C > 0 && P > 0) {
    const int blocks = (C + kThreads - 1) / kThreads;
    dp2_forward<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(cand), static_cast<const float*>(node),
        static_cast<int*>(bp), static_cast<float*>(final_cost), C, P,
        switch_cost, affine_cost);
  }
  return static_cast<int>(cudaGetLastError());
}

int ahsoka_dp2_backtrace(const void* bp, const void* final_state,
                         void* states, int C, int P, void* stream) {
  if (C > 0 && P > 0) {
    const int blocks = (C + kThreads - 1) / kThreads;
    dp2_backtrace<<<blocks, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(bp), static_cast<const int*>(final_state),
        static_cast<int*>(states), C, P);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* ahsoka_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
