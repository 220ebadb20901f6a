// Fused MoE router for Hopper: logits x.W in float32, expert mask,
// softmax, top-k with ties to the lowest expert index, renormalised
// weights, each routed (token, k) pair's stable within-expert rank, the
// per-expert pair counts and the router-loss statistics.
//
// Replaces: src/repro/kernels/router_topk/kernel.py,
//           router_topk_fused_kernel (body _router_fused_kernel, shared
//           math _tile_topk), entry router_topk_fused; and
//           router_topk_kernel (body _router_kernel), entry router_topk,
//           which launches the gate kernel alone (weights and indices).
//
// What bounds it on H100: at serving shapes (N <= a few hundred tokens,
// D 768..2048, E <= 128) the work is tiny: N*D*E*2 FLOPs and one read of
// x and W. It is bound by launch and latency, not by bytes or FLOPs.
//
// Design. The Pallas kernel carries the rank base and the loss sums from
// tile to tile in a resident output block, which relies on the TPU
// running its grid in order. CUDA blocks run in no fixed order, so the
// work is three launches on one stream:
//   1. router_gate_kernel: one block of 1024 threads per token. Thread
//      (slice, e) accumulates expert e's logit over every slices-th row
//      of W in float32 (coalesced: neighbouring threads read neighbouring
//      columns), so each thread issues only D / slices dependent loads;
//      the slices are summed by a fixed tree in shared memory. Warp 0 then
//      does the softmax with shuffles (lanes over experts, E <= 128) and
//      k rounds of (max, lowest index among equal maxima). It writes the
//      weights, the indices and, for the fused entry, the token's
//      probabilities and lse^2 (router_topk passes null for both).
//   2. router_tile_kernel: per tile of 64 tokens and per expert (one
//      thread each), the tile's pair count, prob mass and sum of lse^2,
//      each summed in token order.
//   3. router_rank_kernel: each tile's rank base is the sum of the counts
//      of the tiles before it (an exclusive scan over tiles); ranks are
//      then assigned in flattened (token, k) order, which is what a stable
//      argsort by expert gives. Block 0 writes the totals, again summed in
//      tile order, so repeated runs give the same bits (no float atomics).
#include "common.cuh"

#define GATE_THREADS 1024
#define TILE_TOKENS 64
#define MAX_K 8
#define MAX_E 128

template <typename T>
__global__ void router_gate_kernel(const T* __restrict__ x,
                                   const T* __restrict__ w, int D, int E,
                                   int e_pad, int k, int valid_experts,
                                   float* __restrict__ vals,
                                   int* __restrict__ idx,
                                   float* __restrict__ probs,
                                   float* __restrict__ lse2) {
  // thread (slice, e): expert e's partial logit over rows d = slice
  // (mod slices); e_pad is E rounded up to a power of two
  __shared__ float partial[GATE_THREADS];
  const int n = blockIdx.x;
  const int e_own = threadIdx.x % e_pad, slice = threadIdx.x / e_pad;
  const int slices = GATE_THREADS / e_pad;
  const int lane = threadIdx.x % 32;
  const T* xr = x + (size_t)n * D;

  float acc = 0.f;
  if (e_own < E) {
#pragma unroll 8
    for (int d = slice; d < D; d += slices)
      acc = fmaf(to_f32(xr[d]), to_f32(w[(size_t)d * E + e_own]), acc);
  }
  partial[threadIdx.x] = acc;
  for (int stride = slices / 2; stride > 0; stride >>= 1) {  // fixed tree
    __syncthreads();
    if (slice < stride) partial[threadIdx.x] += partial[threadIdx.x +
                                                        stride * e_pad];
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;

  float logit[4], p[4];
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int e = lane + 32 * j;
    logit[j] = -INFINITY;
    if (e < E) logit[j] = e < valid_experts ? partial[e] : -1e9f;
    m = fmaxf(m, logit[j]);
  }
  m = warp_max(m);
  float psum = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    p[j] = (lane + 32 * j < E) ? expf(logit[j] - m) : 0.f;
    psum += p[j];
  }
  psum = warp_sum(psum);
  float work[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int e = lane + 32 * j;
    p[j] = p[j] / psum;
    work[j] = e < E ? p[j] : -INFINITY;
    if (e < E && probs != nullptr) probs[(size_t)n * E + e] = p[j];
  }
  if (lane == 0 && lse2 != nullptr) {
    const float lse = m + logf(psum);
    lse2[n] = lse * lse;
  }

  float top_v[MAX_K];
  int top_i[MAX_K];
  float total = 0.f;
  for (int r = 0; r < k; ++r) {
    float bv = -INFINITY;
    int bi = 1 << 30;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (work[j] > bv) {   // j ascending: the first maximum is the lowest
        bv = work[j];
        bi = lane + 32 * j;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    top_v[r] = bv;
    top_i[r] = bi;
    total += bv;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (lane + 32 * j == bi) work[j] = -1.f;
  }
  total = fmaxf(total, 1e-9f);
  if (lane == 0) {
    for (int r = 0; r < k; ++r) {
      vals[(size_t)n * k + r] = top_v[r] / total;
      idx[(size_t)n * k + r] = top_i[r];
    }
  }
}

__global__ void router_tile_kernel(const int* __restrict__ idx,
                                   const float* __restrict__ probs,
                                   const float* __restrict__ lse2, int N,
                                   int E, int k, int* __restrict__ tile_counts,
                                   float* __restrict__ tile_prob,
                                   float* __restrict__ tile_z) {
  const int b = blockIdx.x, e = threadIdx.x;
  const int n0 = b * TILE_TOKENS;
  const int n1 = min(N, n0 + TILE_TOKENS);
  if (e < E) {
    int c = 0;
    float ps = 0.f;
    for (int n = n0; n < n1; ++n) {
      for (int j = 0; j < k; ++j) c += idx[(size_t)n * k + j] == e;
      ps += probs[(size_t)n * E + e];
    }
    tile_counts[(size_t)b * E + e] = c;
    tile_prob[(size_t)b * E + e] = ps;
  }
  if (e == 0) {
    float z = 0.f;
    for (int n = n0; n < n1; ++n) z += lse2[n];
    tile_z[b] = z;
  }
}

__global__ void router_rank_kernel(const int* __restrict__ idx,
                                   const int* __restrict__ tile_counts,
                                   const float* __restrict__ tile_prob,
                                   const float* __restrict__ tile_z, int N,
                                   int E, int k, int ntiles,
                                   int* __restrict__ pos,
                                   int* __restrict__ counts,
                                   float* __restrict__ stats) {
  const int b = blockIdx.x, e = threadIdx.x;
  if (e >= E) return;
  int rank = 0;
  for (int t = 0; t < b; ++t) rank += tile_counts[(size_t)t * E + e];
  const int n0 = b * TILE_TOKENS;
  const int n1 = min(N, n0 + TILE_TOKENS);
  for (int n = n0; n < n1; ++n)
    for (int j = 0; j < k; ++j)
      if (idx[(size_t)n * k + j] == e) pos[(size_t)n * k + j] = rank++;
  if (b == 0) {
    int c = 0;
    float ps = 0.f, z = 0.f;
    for (int t = 0; t < ntiles; ++t) {
      c += tile_counts[(size_t)t * E + e];
      ps += tile_prob[(size_t)t * E + e];
      z += tile_z[t];
    }
    counts[e] = c;
    stats[e] = ps;
    stats[E + e] = z;
  }
}

extern "C" int router_topk_fused(const void* x, const void* w, int dtype,
                                 int N, int D, int E, int k,
                                 int valid_experts, void* vals, void* idx,
                                 void* pos, void* counts, void* stats,
                                 void* probs_scratch, void* lse2_scratch,
                                 void* tile_counts, void* tile_prob,
                                 void* tile_z, void* stream) {
  if (N < 1 || E < 1 || E > MAX_E || k < 1 || k > MAX_K || k > E)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ntiles = (N + TILE_TOKENS - 1) / TILE_TOKENS;
  float* probs = static_cast<float*>(probs_scratch);
  float* lse2 = static_cast<float*>(lse2_scratch);
  int e_pad = 1;
  while (e_pad < E) e_pad <<= 1;
  if (dtype == REPRO_F32) {
    router_gate_kernel<float><<<N, GATE_THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), D, E,
        e_pad, k, valid_experts, static_cast<float*>(vals),
        static_cast<int*>(idx), probs, lse2);
  } else if (dtype == REPRO_BF16) {
    router_gate_kernel<__nv_bfloat16><<<N, GATE_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), D, E, e_pad, k, valid_experts,
        static_cast<float*>(vals), static_cast<int*>(idx), probs, lse2);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  router_tile_kernel<<<ntiles, MAX_E, 0, s>>>(
      static_cast<const int*>(idx), probs, lse2, N, E, k,
      static_cast<int*>(tile_counts), static_cast<float*>(tile_prob),
      static_cast<float*>(tile_z));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  router_rank_kernel<<<ntiles, MAX_E, 0, s>>>(
      static_cast<const int*>(idx), static_cast<const int*>(tile_counts),
      static_cast<const float*>(tile_prob), static_cast<const float*>(tile_z),
      N, E, k, ntiles, static_cast<int*>(pos), static_cast<int*>(counts),
      static_cast<float*>(stats));
  return static_cast<int>(cudaGetLastError());
}

// Gating only: the weights and indices of router_topk_kernel, one launch.
extern "C" int router_topk(const void* x, const void* w, int dtype, int N,
                           int D, int E, int k, int valid_experts,
                           void* vals, void* idx, void* stream) {
  if (N < 1 || E < 1 || E > MAX_E || k < 1 || k > MAX_K || k > E)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int e_pad = 1;
  while (e_pad < E) e_pad <<= 1;
  if (dtype == REPRO_F32) {
    router_gate_kernel<float><<<N, GATE_THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), D, E,
        e_pad, k, valid_experts, static_cast<float*>(vals),
        static_cast<int*>(idx), nullptr, nullptr);
  } else if (dtype == REPRO_BF16) {
    router_gate_kernel<__nv_bfloat16><<<N, GATE_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), D, E, e_pad, k, valid_experts,
        static_cast<float*>(vals), static_cast<int*>(idx), nullptr, nullptr);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT_ERROR_STRING
