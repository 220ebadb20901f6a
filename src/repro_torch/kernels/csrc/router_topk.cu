// Fused MoE router for Hopper: logits x.W (summed in float64, rounded to
// float32), expert mask,
// softmax, top-k with ties to the lowest expert index, renormalised
// weights, each routed (token, k) pair's stable within-expert rank, the
// per-expert pair counts and the router-loss statistics, in one launch.
//
// Replaces: src/repro/kernels/router_topk/kernel.py,
//           router_topk_fused_kernel (body _router_fused_kernel, shared
//           math _tile_topk), entry router_topk_fused; and
//           router_topk_kernel (body _router_kernel), entry router_topk,
//           the same launch without ranks, counts and statistics.
//
// What bounds it on H100: at serving shapes (N <= a few hundred tokens,
// D 768..2048, E <= 128) the work is tiny: 2 N D E FLOPs and one read of
// x and W (a few KB to 0.5 MB). It is bound by latency: the launches, and
// how many dependent round trips to memory each one waits for. At decode
// (N = 4) one block per token left 4 of 132 SMs to read all of W.
//
// Design. One launch, grid (slice of D, tile of tokens); the host's plan
// (kernels/router_topk/ops.py, router_plan) picks the tile from N and E
// and enough slices to spread W over the SMs: at decode one tile and up
// to 32 slices, so W is read once in all, by many SMs at once; at 1024+
// tokens 16-64 tiles and few slices.
//   - Product: each thread accumulates micro-tiles of 4 tokens x 4
//     experts over its rows of the slice, read straight from x and W with
//     several rows' loads in flight (phases of the rows when the tile has
//     fewer micro-tiles than threads, summed in phase order through
//     shared memory): one round trip to memory, where staging the slice
//     in shared memory cost one per 32 rows.
//   - With several slices, each writes its partial logits; the last slice
//     block of a tile (an atomic ticket) sums them in slice order.
//   - The logits are summed in float64 and rounded to float32 once. A
//     float32 sum in any order but the plain version's (cuBLAS) misorders
//     experts whose logits lie a few ulps apart (seen on the card: two of
//     8 x 4096 top-8 indices, experts 2.4e-7 apart in 2.95); the rounded
//     exact sum orders them as the plain version does unless the plain
//     version's own rounding error crosses the gap. The extra float64
//     work is small at these sizes (latency-bound).
//   - That block finishes the tile: a warp per token does the softmax and
//     k rounds of (max, lowest index) with shuffles; one thread per
//     expert counts the tile's pairs, ranks them in flattened (token, k)
//     order and sums the probabilities in token order.
//   - With several tiles, the last tile to finish (a second ticket) scans
//     the tile counts in tile order into rank bases, adds them to the
//     other tiles' ranks, and sums the totals in tile order. Repeated runs
//     give the same bits (no float atomics).
//   - Tickets live in the wrapper's per-device workspace, which is zero
//     between launches: each last block resets the ticket it used.
#include "common.cuh"

#define THREADS 256
#define WARPS (THREADS / 32)
#define MAX_E 128
#define MAX_K 8
#define MAX_TILE 64
#define DC 32                      // fewest rows of D a slice takes
#define LG_FLOATS 4096             // a tile's logits: tile x E4
#define BATCH 16                   // global loads a merge keeps in flight

struct RouterArgs {
  const void* x;
  const void* w;
  int N, D, E, k, valid;
  int tile, slices, slice_len;   // the host's plan
  int fused;                     // 0: gating only (vals, idx)
  float* vals;
  int* idx;
  int* pos;
  int* counts;
  float* stats;        // probs_sum (E), then z_sq_sum
  double* part;        // (slices, N, E) partial logits, when slices > 1
  int* tile_counts;    // (ntiles, E), fused with several tiles
  float* tile_prob;    // (ntiles, E)
  float* tile_z;       // (ntiles,)
  int* tickets;        // [0]: tiles finished; [1 + t]: slices of tile t
};

// acc += the outer product of 4 tokens x 4 experts over rows d0 + ph,
// d0 + ph + step, ... < d1 for micro-tile m, read straight from x and W
// (four rows' loads in flight); products and sums in float64 (a float32
// product is exact there)
template <typename T>
__device__ __forceinline__ void micro(double (&acc)[4][4], const T* x,
                                      const T* w, int D, int E, int nt,
                                      int EG, int m, int d0, int d1, int ph,
                                      int step) {
  const int ng = m / EG, eg = m % EG;
  const T* xr[4];
  bool nok[4], eok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    nok[i] = 4 * ng + i < nt;
    xr[i] = x + (size_t)(nok[i] ? 4 * ng + i : 0) * D;
    eok[i] = 4 * eg + i < E;
  }
#pragma unroll 4
  for (int d = d0 + ph; d < d1; d += step) {
    double xa[4], wa[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      xa[i] = nok[i] ? to_f32(xr[i][d]) : 0.0;
      wa[i] = eok[i] ? to_f32(w[(size_t)d * E + 4 * eg + i]) : 0.0;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fma(xa[i], wa[j], acc[i][j]);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) router_kernel(const RouterArgs a) {
  __shared__ __align__(16) double red[THREADS * 8];   // phase sums
  __shared__ __align__(16) float lg[LG_FLOATS];   // logits, then probs
  __shared__ int idx_s[MAX_TILE * MAX_K];
  __shared__ float lse2_s[MAX_TILE];
  __shared__ int s_last;
  const int s = blockIdx.x, t = blockIdx.y, ntiles = gridDim.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int E = a.E, E4 = (E + 3) / 4 * 4, k = a.k;
  const int n0 = t * a.tile, nt = min(a.tile, a.N - n0);
  const int d0 = s * a.slice_len, d1 = min(a.D, d0 + a.slice_len);
  const T* x = static_cast<const T*>(a.x);
  const T* w = static_cast<const T*>(a.w);

  // ---- partial logits of this tile over rows [d0, d1)
  const int NG = (nt + 3) / 4, EG = E4 / 4, MT = NG * EG;
  // phases of the rows: no more than the slice has rows
  const int P = MT >= THREADS ? 1 : min(THREADS / MT, d1 - d0);
  const int m0 = MT > THREADS ? tid : tid % MT;
  const int ph = MT > THREADS ? 0 : tid / MT;
  const bool has0 = ph < P, has1 = MT > THREADS && tid + THREADS < MT;
  double acc0[4][4], acc1[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc0[i][j] = acc1[i][j] = 0.0;
  if (has0)
    micro(acc0, x + (size_t)n0 * a.D, w, a.D, E, nt, EG, m0, d0, d1, ph, P);
  if (has1)
    micro(acc1, x + (size_t)n0 * a.D, w, a.D, E, nt, EG, m0 + THREADS, d0,
          d1, 0, 1);
  // this block's sum for (token n, expert e) of the tile: with one slice
  // the logit, rounded once to float32; else a float64 partial
  auto put = [&](int n, int e, double v) {
    if (a.slices == 1)
      lg[n * E4 + e] = static_cast<float>(v);
    else if (n < nt && e < E)
      a.part[((size_t)s * a.N + n0 + n) * E + e] = v;
  };
  if (P == 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (has0) put(4 * (m0 / EG) + i, 4 * (m0 % EG) + j, acc0[i][j]);
        if (has1)
          put(4 * ((m0 + THREADS) / EG) + i, 4 * ((m0 + THREADS) % EG) + j,
              acc1[i][j]);
      }
  } else {   // sum the phases in order, half a micro-tile at a time
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      __syncthreads();
      if (has0)
#pragma unroll
        for (int q = 0; q < 8; ++q)
          red[(ph * MT + m0) * 8 + q] = acc0[2 * half + q / 4][q % 4];
      __syncthreads();
      for (int o = tid; o < MT * 8; o += THREADS) {
        const int m = o / 8, q = o % 8;
        double v = 0.0;
        for (int p = 0; p < P; ++p) v += red[(p * MT + m) * 8 + q];
        put(4 * (m / EG) + 2 * half + q / 4, 4 * (m % EG) + q % 4, v);
      }
    }
  }
  __syncthreads();

  // ---- several slices: the tile's last slice block sums them in order
  if (a.slices > 1) {
    __threadfence();
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(a.tickets + 1 + t, 1) == a.slices - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    for (int o = tid; o < nt * E; o += THREADS) {
      const int n = o / E, e = o % E;
      const double* pp = a.part + (size_t)(n0 + n) * E + e;
      double v = 0.0;
      for (int q0 = 0; q0 < a.slices; q0 += BATCH) {   // BATCH loads at once
        double pv[BATCH];
#pragma unroll
        for (int j = 0; j < BATCH; ++j)
          pv[j] = q0 + j < a.slices ? __ldcg(pp + (size_t)(q0 + j) * a.N * E)
                                    : 0.0;
#pragma unroll
        for (int j = 0; j < BATCH; ++j)
          if (q0 + j < a.slices) v += pv[j];   // in slice order
      }
      lg[n * E4 + e] = static_cast<float>(v);
    }
    if (tid == 0) a.tickets[1 + t] = 0;
    __syncthreads();
  }

  // ---- softmax and top-k, a warp per token
  for (int n = warp; n < nt; n += WARPS) {
    float* row = lg + n * E4;
    float logit[4], p[4];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = lane + 32 * j;
      logit[j] = -INFINITY;
      if (e < E) logit[j] = e < a.valid ? row[e] : -1e9f;
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
      if (e < E) row[e] = p[j];
    }
    if (lane == 0) {
      const float lse = m + logf(psum);
      lse2_s[n] = lse * lse;
    }
    float top_v[MAX_K];
    int top_i[MAX_K];
    float total = 0.f;
    for (int r = 0; r < k; ++r) {
      float bv = -INFINITY;
      int bi = 1 << 30;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (work[j] > bv) {   // j ascending: the first maximum is lowest
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
      const size_t at = (size_t)(n0 + n) * k;
      for (int r = 0; r < k; ++r) {
        a.vals[at + r] = top_v[r] / total;
        a.idx[at + r] = top_i[r];
        idx_s[n * k + r] = top_i[r];
      }
    }
  }
  if (!a.fused) return;
  __syncthreads();

  // ---- the tile's counts, ranks (flattened (token, k) order) and sums
  int c = 0;
  float ps = 0.f, z = 0.f;
  if (tid < E) {
    for (int n = 0; n < nt; ++n) {
      for (int j = 0; j < k; ++j)
        if (idx_s[n * k + j] == tid) a.pos[(size_t)(n0 + n) * k + j] = c++;
      ps += lg[n * E4 + tid];
    }
  }
  if (tid == MAX_E)
    for (int n = 0; n < nt; ++n) z += lse2_s[n];
  if (ntiles == 1) {
    if (tid < E) {
      a.counts[tid] = c;
      a.stats[tid] = ps;
    }
    if (tid == MAX_E) a.stats[E] = z;
    return;
  }
  if (tid < E) {
    a.tile_counts[(size_t)t * E + tid] = c;
    a.tile_prob[(size_t)t * E + tid] = ps;
  }
  if (tid == MAX_E) a.tile_z[t] = z;

  // ---- several tiles: the last one scans the counts into rank bases
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(a.tickets, 1) == ntiles - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (tid < E) {   // BATCH tiles' loads at once, sums in tile order
    int base = 0;
    float psum = 0.f;
    for (int q0 = 0; q0 < ntiles; q0 += BATCH) {
      int cq[BATCH];
      float pq[BATCH];
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const bool ok = q0 + j < ntiles;
        const size_t at = (size_t)(q0 + j) * E + tid;
        cq[j] = ok ? __ldcg(a.tile_counts + at) : 0;
        pq[j] = ok ? __ldcg(a.tile_prob + at) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        if (q0 + j >= ntiles) continue;
        a.tile_counts[(size_t)(q0 + j) * E + tid] = base;   // exclusive scan
        base += cq[j];
        psum += pq[j];
      }
    }
    a.counts[tid] = base;
    a.stats[tid] = psum;
  }
  if (tid == MAX_E) {
    float zs = 0.f;
    for (int q0 = 0; q0 < ntiles; q0 += BATCH) {
      float zq[BATCH];
#pragma unroll
      for (int j = 0; j < BATCH; ++j)
        zq[j] = q0 + j < ntiles ? __ldcg(a.tile_z + q0 + j) : 0.f;
#pragma unroll
      for (int j = 0; j < BATCH; ++j)
        if (q0 + j < ntiles) zs += zq[j];
    }
    a.stats[E] = zs;
  }
  __threadfence();
  __syncthreads();
  // the other tiles' ranks get their bases (tile 0's base is 0)
  for (int p0 = a.tile * k + tid; p0 < a.N * k; p0 += BATCH * THREADS) {
    int e[BATCH], r[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int p = p0 + j * THREADS;
      e[j] = p < a.N * k ? __ldcg(a.idx + p) : 0;
      r[j] = p < a.N * k ? __ldcg(a.pos + p) : 0;
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int p = p0 + j * THREADS;
      if (p < a.N * k)
        r[j] += __ldcg(a.tile_counts + (size_t)(p / k / a.tile) * E + e[j]);
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int p = p0 + j * THREADS;
      if (p < a.N * k) a.pos[p] = r[j];
    }
  }
  if (tid == 0) a.tickets[0] = 0;
}

static int launch(RouterArgs& a, int dtype, void* stream) {
  if (a.N < 1 || a.E < 1 || a.E > MAX_E || a.k < 1 || a.k > MAX_K ||
      a.k > a.E || a.tile < 1 || a.tile > MAX_TILE || a.tile % 4 != 0 ||
      a.tile * ((a.E + 3) / 4 * 4) > LG_FLOATS || a.slices < 1 ||
      a.slice_len < 1 || (long long)a.slices * a.slice_len < a.D ||
      (long long)(a.slices - 1) * a.slice_len >= a.D)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ntiles = (a.N + a.tile - 1) / a.tile;
  if (ntiles > 65535 || a.slices > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(a.slices, ntiles);
  if (dtype == REPRO_F32)
    router_kernel<float><<<grid, THREADS, 0, s>>>(a);
  else if (dtype == REPRO_BF16)
    router_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(a);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The plan (tile, slices, slice_len) comes from the wrapper
// (kernels/router_topk/ops.py, router_plan). part: slices x N x E floats
// when slices > 1; tile_counts / tile_prob / tile_z: ntiles x E, ntiles x E
// and ntiles when ntiles > 1; tickets: 1 + ntiles zeros. part is float64.
extern "C" int router_topk_fused(const void* x, const void* w, int dtype,
                                 int N, int D, int E, int k,
                                 int valid_experts, int tile, int slices,
                                 int slice_len, void* vals, void* idx,
                                 void* pos, void* counts, void* stats,
                                 void* part, void* tile_counts,
                                 void* tile_prob, void* tile_z,
                                 void* tickets, void* stream) {
  RouterArgs a{x, w, N, D, E, k, valid_experts, tile, slices, slice_len, 1,
               static_cast<float*>(vals), static_cast<int*>(idx),
               static_cast<int*>(pos), static_cast<int*>(counts),
               static_cast<float*>(stats), static_cast<double*>(part),
               static_cast<int*>(tile_counts),
               static_cast<float*>(tile_prob), static_cast<float*>(tile_z),
               static_cast<int*>(tickets)};
  return launch(a, dtype, stream);
}

// Gating only: the weights and indices of router_topk_kernel, one launch.
extern "C" int router_topk(const void* x, const void* w, int dtype, int N,
                           int D, int E, int k, int valid_experts, int tile,
                           int slices, int slice_len, void* vals, void* idx,
                           void* part, void* tickets, void* stream) {
  RouterArgs a{x, w, N, D, E, k, valid_experts, tile, slices, slice_len, 0,
               static_cast<float*>(vals), static_cast<int*>(idx), nullptr,
               nullptr, nullptr, static_cast<double*>(part), nullptr,
               nullptr, nullptr, static_cast<int*>(tickets)};
  return launch(a, dtype, stream);
}

REPRO_EXPORT_ERROR_STRING
