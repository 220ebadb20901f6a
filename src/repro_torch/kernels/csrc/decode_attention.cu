// GQA flash-decode for Hopper: one new query token per batch row attends
// over its KV cache with an online softmax in float32.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py,
//           decode_attention_kernel (body _decode_kernel).
//
// q (B, N, G, D), k/v (B, T, N, D) with any batch and T strides (the last
// two axes contiguous), valid_len (B,) int32 -> out (B, N, G, D). Slots at
// or past valid_len[b] are masked; scores are scaled by D^-1/2; the
// output is acc / max(l, 1e-30). The Pallas kernel masks a score to
// -1e30, so a row with valid_len 0 weighs all T slots alike
// (p = exp(0) = 1): its output is the mean of V over the T rows passed
// in, and so it is here.
//
// What bounds it on H100: one pass over the valid K and V rows, so bytes
// (2 * valid * N * D * bytes per element, 0.5 MB at gpt2-moe decode:
// 0.16 us at 3.35 TB/s). At serving sizes (a few slots, up to a few
// hundred positions) it is bound by latency: how many round trips to HBM
// a block waits for one after another.
//
// Design. One block of 4 warps per (kv head, batch row [, split]) walks
// its valid positions in chunks of 32. All K and V rows of a chunk are
// issued at once as 16-byte cp.async copies into shared memory, double
// buffered, so chunk c+1 is in flight while chunk c is computed and a
// block waits on HBM about once per chunk; q and the first chunk go out
// before valid_len[b] is read, so the first wait covers all three. Within
// a chunk each warp takes the rows warp, warp + 4, ... and keeps its own
// running (m, l, acc) for the G query heads: scores from shared memory
// (lanes over D, shuffle sum), the online softmax in the warp, then acc
// over the warp's rows (lanes over (g, d)). Two barriers per chunk; the
// four warps' states are merged in warp order at the end. A shape whose
// rows are not whole 16-byte chunks (or whose strides are not) loads the
// same buffers element by element.
//
// Split-KV: when B x N blocks are few against the SMs and the cache is
// long, the wrapper splits the positions across `splits` blocks per
// (b, n). Each writes its partial (m, l, acc) to scratch; the last block
// to finish (an atomic ticket per (b, n)) merges all of them in split
// order, so a call is one launch and its bits do not depend on which block
// finished first.
#include "common.cuh"

#define THREADS 128
#define WARPS (THREADS / 32)
#define CHUNK 32                    // positions per chunk
#define RPW (CHUNK / WARPS)         // rows per warp per chunk
#define MAX_D 256
#define MAX_GD 1024                 // G * D
#define MAX_G 16
#define PAIRS (MAX_GD / 32)         // (g, d) accumulators per lane

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* valid_len;
  long long k_sb, k_st, v_sb, v_st;   // batch and T strides, in elements
  int N, G, D, T;
  float scale;
  int splits, per_split;              // positions per split
  int aligned;                        // rows and strides in 16-byte chunks
  void* out;
  float* part;     // (B, N, splits, 2G + GD): m, l, acc of each split
  int* ticket;     // (B, N) zeros, when splits > 1
};

static __host__ __device__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// dynamic shared memory: K and V chunks [2][2][CHUNK][D] and q [G][D] in
// the input type, then (16-byte aligned) the warps' p [WARPS][MAX_G][RPW]
// and m, l and alpha [WARPS][MAX_G] in float32
static __host__ __device__ size_t stats_offset(int G, int D, size_t elem) {
  return (4 * (size_t)CHUNK * D * elem + (size_t)G * D * elem + 15) / 16 * 16;
}
static size_t smem_bytes(int G, int D, size_t elem) {
  return stats_offset(G, D, elem) + sizeof(float) * WARPS * MAX_G * (RPW + 3);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_attn_kernel(const DecodeArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  const int n = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int D = p.D, G = p.G, GD = G * D;
  const size_t tile = (size_t)CHUNK * D;       // elements of a K or V chunk
  T* kv = reinterpret_cast<T*>(smem);
  T* qs = kv + 4 * tile;
  float* pw = reinterpret_cast<float*>(smem + stats_offset(G, D, sizeof(T)));
  float* mw = pw + WARPS * MAX_G * RPW;
  float* lw = mw + WARPS * MAX_G;
  float* aw = lw + WARPS * MAX_G;
  const T* kb = static_cast<const T*>(p.k) + (size_t)b * p.k_sb +
                (size_t)n * D;
  const T* vb = static_cast<const T*>(p.v) + (size_t)b * p.v_sb +
                (size_t)n * D;
  T* ob = static_cast<T*>(p.out) + ((size_t)b * p.N + n) * GD;
  const int r_begin = split * p.per_split;
  const int r_cap = min(p.T, r_begin + p.per_split);

  // chunk c's K and V rows [r_begin + 32 c, lim) into buffer c % 2
  auto load = [&](int c, int lim) {
    T* kd = kv + (c & 1) * 2 * tile;
    T* vd = kd + tile;
    const int r0 = r_begin + c * CHUNK, width = min(CHUNK, lim - r0);
    if (p.aligned) {
      constexpr int EPC = 16 / sizeof(T);
      const int cpr = D / EPC;
      for (int i = threadIdx.x; i < width * cpr; i += THREADS) {
        const int r = i / cpr, d = (i % cpr) * EPC;
        cp_async16(kd + r * D + d, kb + (size_t)(r0 + r) * p.k_st + d);
        cp_async16(vd + r * D + d, vb + (size_t)(r0 + r) * p.v_st + d);
      }
    } else {
      for (int i = threadIdx.x; i < width * D; i += THREADS) {
        const int r = i / D, d = i % D;
        kd[r * D + d] = kb[(size_t)(r0 + r) * p.k_st + d];
        vd[r * D + d] = vb[(size_t)(r0 + r) * p.v_st + d];
      }
    }
  };

  // q and the first chunk are in flight before valid_len[b] is known (its
  // rows past valid_len are never used), so the block waits on HBM once
  // for all three
  const T* qb = static_cast<const T*>(p.q) + ((size_t)b * p.N + n) * GD;
  if (p.aligned) {
    constexpr int EPC = 16 / sizeof(T);
    for (int i = threadIdx.x * EPC; i < GD; i += THREADS * EPC)
      cp_async16(qs + i, qb + i);
  } else {
    for (int i = threadIdx.x; i < GD; i += THREADS) qs[i] = qb[i];
  }
  if (r_cap > r_begin) load(0, r_cap);
  cp_async_commit();
  const int tv = max(0, min(p.valid_len[b], p.T));

  if (tv == 0) {   // every slot masked: the mean of V over all T rows
    cp_async_wait<0>();
    if (split != 0) return;
    for (int i = threadIdx.x; i < GD; i += THREADS) {
      const int d = i % D;
      float a = 0.f;
      for (int tt = 0; tt < p.T; ++tt) a += to_f32(vb[(size_t)tt * p.v_st + d]);
      ob[i] = from_f32<T>(a / fmaxf((float)p.T, 1e-30f));
    }
    return;
  }

  if (threadIdx.x < WARPS * MAX_G) {
    mw[threadIdx.x] = -INFINITY;
    lw[threadIdx.x] = 0.f;
  }
  const int r_end = min(tv, r_cap);
  const int nchunks = r_end > r_begin ? cdiv(r_end - r_begin, CHUNK) : 0;

  float acc[PAIRS];
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) acc[i] = 0.f;

  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks) load(c + 1, r_end);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* kc = kv + (c & 1) * 2 * tile;
    const T* vc = kc + tile;
    const int width = min(CHUNK, r_end - (r_begin + c * CHUNK));
    // scores of this warp's rows and its online softmax, per query head
    for (int g = 0; g < G; ++g) {
      float s[RPW], smax = -INFINITY;
#pragma unroll
      for (int j = 0; j < RPW; ++j) {
        const int r = warp + WARPS * j;
        float part = 0.f;
        if (r < width) {
#pragma unroll
          for (int jd = 0; jd < MAX_D / 32; ++jd) {
            const int d = lane + 32 * jd;
            if (d < D)
              part = fmaf(to_f32(qs[g * D + d]), to_f32(kc[r * D + d]), part);
          }
        }
        part = warp_sum(part);
        s[j] = r < width ? part * p.scale : -INFINITY;
        smax = fmaxf(smax, s[j]);
      }
      float* st = mw + warp * MAX_G + g;
      const float m_old = *st;
      const float m_new = fmaxf(m_old, smax);
      const bool none = m_new == -INFINITY;    // no row of this warp yet
      __syncwarp();                            // every lane has read m_old
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < RPW; ++j) {
        const float pj = none ? 0.f : expf(s[j] - m_new);
        psum += pj;
        if (lane == 0) pw[(warp * MAX_G + g) * RPW + j] = pj;
      }
      if (lane == 0) {
        const float alpha = none ? 1.f : expf(m_old - m_new);
        aw[warp * MAX_G + g] = alpha;
        lw[warp * MAX_G + g] = lw[warp * MAX_G + g] * alpha + psum;
        *st = m_new;
      }
    }
    __syncwarp();
    // acc over this warp's rows: lane owns (g, d) pairs lane + 32 i
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      const int pp = lane + 32 * i;
      if (pp < GD) {
        const int g = pp / D, d = pp % D;
        const float* pr = pw + (warp * MAX_G + g) * RPW;
        float a = acc[i] * aw[warp * MAX_G + g];
#pragma unroll
        for (int j = 0; j < RPW; ++j) {
          const int r = warp + WARPS * j;
          if (r < width) a = fmaf(pr[j], to_f32(vc[r * D + d]), a);
        }
        acc[i] = a;
      }
    }
    __syncthreads();   // the buffer is refilled two chunks on
  }

  // merge the warps in warp order; their acc goes through the K/V buffers
  cp_async_wait<0>();
  __syncthreads();
  float* accw = reinterpret_cast<float*>(smem);   // [WARPS][GD]
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) {
    const int pp = lane + 32 * i;
    if (pp < GD) accw[warp * GD + pp] = acc[i];
  }
  __syncthreads();
  const size_t rec = 2 * G + GD;                     // one split's record
  float* mine = p.part + (((size_t)b * p.N + n) * p.splits + split) * rec;
  for (int pp = threadIdx.x; pp < GD; pp += THREADS) {
    const int g = pp / D;
    float M = -INFINITY;
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, mw[w * MAX_G + g]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      const float m = mw[w * MAX_G + g];
      const float f = m == -INFINITY ? 0.f : expf(m - M);
      L = fmaf(f, lw[w * MAX_G + g], L);
      A = fmaf(f, accw[w * GD + pp], A);
    }
    if (p.splits == 1) {
      ob[pp] = from_f32<T>(A / fmaxf(L, 1e-30f));
    } else {
      mine[2 * G + pp] = A;
      if (pp % D == 0) {
        mine[g] = M;
        mine[G + g] = L;
      }
    }
  }
  if (p.splits == 1) return;

  // split-KV: the last block of this (b, n) merges the splits in order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(p.ticket + (size_t)b * p.N + n, 1) == p.splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* recs = p.part + ((size_t)b * p.N + n) * p.splits * rec;
  for (int pp = threadIdx.x; pp < GD; pp += THREADS) {
    const int g = pp / D;
    float M = -INFINITY;
    for (int s = 0; s < p.splits; ++s) M = fmaxf(M, __ldcg(recs + s * rec + g));
    float L = 0.f, A = 0.f;
    for (int s = 0; s < p.splits; ++s) {
      const float m = __ldcg(recs + s * rec + g);
      const float f = m == -INFINITY ? 0.f : expf(m - M);
      L = fmaf(f, __ldcg(recs + s * rec + G + g), L);
      A = fmaf(f, __ldcg(recs + s * rec + 2 * G + pp), A);
    }
    ob[pp] = from_f32<T>(A / fmaxf(L, 1e-30f));
  }
}

template <typename T>
static int launch(DecodeArgs a, int B, cudaStream_t st) {
  static bool attr = false;
  const size_t smem = smem_bytes(a.G, a.D, sizeof(T));
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes(MAX_GD / MAX_D, MAX_D, sizeof(float))));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr = true;
  }
  auto al = [](long long x) { return (x * (long long)sizeof(T)) % 16 == 0; };
  auto ap = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  a.aligned = al(a.D) && al(a.k_sb) && al(a.k_st) && al(a.v_sb) &&
              al(a.v_st) && ap(a.q) && ap(a.k) && ap(a.v);
  const dim3 grid(a.N, B, a.splits);
  decode_attn_kernel<T><<<grid, THREADS, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* valid_len, int dtype, int B,
                                int N, int G, int D, int T, long long k_sb,
                                long long k_st, long long v_sb,
                                long long v_st, float scale, int splits,
                                void* part, void* ticket, void* out,
                                void* stream) {
  if (B < 1 || B > 65535 || N < 1 || G < 1 || G > MAX_G || D < 1 ||
      D > MAX_D || G * D > MAX_GD || splits < 1 || splits > 65535 ||
      (splits > 1 && (part == nullptr || ticket == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  DecodeArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.valid_len = static_cast<const int*>(valid_len);
  a.k_sb = k_sb;
  a.k_st = k_st;
  a.v_sb = v_sb;
  a.v_st = v_st;
  a.N = N;
  a.G = G;
  a.D = D;
  a.T = T;
  a.scale = scale;
  a.splits = splits;
  a.per_split = cdiv(cdiv(T > 0 ? T : 1, CHUNK), splits) * CHUNK;
  a.out = out;
  a.part = static_cast<float*>(part);
  a.ticket = static_cast<int*>(ticket);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_F32) return launch<float>(a, B, st);
  if (dtype == REPRO_BF16) return launch<__nv_bfloat16>(a, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

REPRO_EXPORT_ERROR_STRING
