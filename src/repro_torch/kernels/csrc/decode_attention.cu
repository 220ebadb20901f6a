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
// What bounds it on H100: one pass over the valid K and V rows; it is
// bound by bytes (2 * valid * N * D * bytes per element per row), and at
// serving sizes (a few slots, up to a few hundred positions) by latency.
//
// Design. One block of 128 threads per (kv head, batch row) loops over
// the valid positions in chunks of 64 with the running (m, l, acc) for
// its G query heads: warps score one position each (lanes over D,
// shuffle sum), then one warp per query head updates (m, l) over the
// chunk, then each thread updates its (g, d) accumulators against V. The
// loop stops at valid_len[b], so masked slots are never read. The kernel
// reads k and v through their strides, so the ragged-decode slice
// cache[:, :kv_len] costs no copy. Split-KV comes in a later change. (A
// variant with one thread per position, each reading its whole K row,
// measured slower on the H100: 24 us against 20 us at gpt2-moe decode
// shapes, 37 us against 21 us at qwen2-moe's.)
#include "common.cuh"

#define THREADS 128
#define WARPS (THREADS / 32)
#define CHUNK_T 64
#define MAX_D 256
#define MAX_GD 1024                  // G * D
#define MAX_G 16
#define PAIRS (MAX_GD / THREADS)     // (g, d) accumulators per thread

template <typename T>
__global__ void decode_attn_kernel(const T* __restrict__ q,
                                   const T* __restrict__ k,
                                   const T* __restrict__ v,
                                   const int* __restrict__ valid_len,
                                   long long k_sb, long long k_st,
                                   long long v_sb, long long v_st, int N,
                                   int G, int D, int T_len, float scale,
                                   T* __restrict__ out) {
  __shared__ float qs[MAX_GD];
  __shared__ float s[MAX_G][CHUNK_T];
  __shared__ float m_s[MAX_G], l_s[MAX_G], a_s[MAX_G];
  const int n = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int GD = G * D;
  const T* qb = q + ((size_t)b * N + n) * GD;
  for (int i = threadIdx.x; i < GD; i += THREADS) qs[i] = to_f32(qb[i]);
  if (threadIdx.x < G) {
    m_s[threadIdx.x] = -INFINITY;
    l_s[threadIdx.x] = 0.f;
  }
  const int tv = max(0, min(valid_len[b], T_len));
  const T* kb = k + (size_t)b * k_sb + (size_t)n * D;
  const T* vb = v + (size_t)b * v_sb + (size_t)n * D;
  float acc[PAIRS];
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int t0 = 0; t0 < tv; t0 += CHUNK_T) {
    const int width = min(CHUNK_T, tv - t0);
    // scores: one position per warp at a time, lanes over D
    for (int i = warp; i < CHUNK_T; i += WARPS) {
      if (i < width) {
        const T* kr = kb + (size_t)(t0 + i) * k_st;
        float kd[MAX_D / 32];
#pragma unroll
        for (int j = 0; j < MAX_D / 32; ++j) {
          const int d = lane + 32 * j;
          kd[j] = d < D ? to_f32(kr[d]) : 0.f;
        }
        for (int g = 0; g < G; ++g) {
          float part = 0.f;
#pragma unroll
          for (int j = 0; j < MAX_D / 32; ++j) {
            const int d = lane + 32 * j;
            if (d < D) part = fmaf(qs[g * D + d], kd[j], part);
          }
          part = warp_sum(part);
          if (lane == 0) s[g][i] = part * scale;
        }
      } else if (lane == 0) {
        for (int g = 0; g < G; ++g) s[g][i] = -INFINITY;
      }
    }
    __syncthreads();
    // online softmax over the chunk: one warp per query head
    for (int g = warp; g < G; g += WARPS) {
      const float s0 = s[g][lane], s1 = s[g][lane + 32];
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      s[g][lane] = p0;
      s[g][lane + 32] = p1;
      const float psum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + psum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // acc update: each thread owns (g, d) pairs threadIdx.x + THREADS * i
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      const int p = threadIdx.x + THREADS * i;
      if (p < GD) {
        const int g = p / D, d = p % D;
        float a = acc[i] * a_s[g];
        for (int tt = 0; tt < width; ++tt)
          a = fmaf(s[g][tt], to_f32(vb[(size_t)(t0 + tt) * v_st + d]), a);
        acc[i] = a;
      }
    }
    __syncthreads();
  }
  if (tv == 0) {   // every slot masked: the mean of V over all T rows
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      const int p = threadIdx.x + THREADS * i;
      if (p < GD) {
        const int d = p % D;
        float a = 0.f;
        for (int tt = 0; tt < T_len; ++tt)
          a += to_f32(vb[(size_t)tt * v_st + d]);
        acc[i] = a;
      }
    }
    if (threadIdx.x < G) l_s[threadIdx.x] = (float)T_len;
    __syncthreads();
  }
  T* ob = out + ((size_t)b * N + n) * GD;
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) {
    const int p = threadIdx.x + THREADS * i;
    if (p < GD) ob[p] = from_f32<T>(acc[i] / fmaxf(l_s[p / D], 1e-30f));
  }
}

extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* valid_len, int dtype, int B,
                                int N, int G, int D, int T, long long k_sb,
                                long long k_st, long long v_sb,
                                long long v_st, float scale, void* out,
                                void* stream) {
  if (B < 1 || B > 65535 || N < 1 || G < 1 || G > MAX_G || D < 1 ||
      D > MAX_D || G * D > MAX_GD)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(N, B);
  if (dtype == REPRO_F32) {
    decode_attn_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const int*>(valid_len),
        k_sb, k_st, v_sb, v_st, N, G, D, T, scale, static_cast<float*>(out));
  } else if (dtype == REPRO_BF16) {
    decode_attn_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<const int*>(valid_len), k_sb, k_st, v_sb, v_st, N, G, D,
        T, scale, static_cast<__nv_bfloat16*>(out));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT_ERROR_STRING
