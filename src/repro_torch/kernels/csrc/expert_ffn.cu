// Expert FFN on dense capacity buffers for Hopper.
//
// Replaces: src/repro/kernels/expert_ffn/kernel.py, expert_ffn_kernel
//           (body _ffn_kernel).
//
// Per expert e over its (C, D) capacity buffer (built by the dense
// executor, repro_torch.models.moe.dispatch_tokens; empty slots are zero):
//     swiglu: out = (silu(x Wg[e]) * (x Wu[e])) Wd[e]
//     gelu:   out = gelu_tanh(x Wg[e]) Wd[e]
// Inputs (float32 or bfloat16) are read as float32, h stays in float32,
// sums are float32, and the output is cast to the buffer's type once.
// There are no biases, so a zero slot gives an exact zero row.
//
// What bounds it on H100: at the runtime's capture shape (gpt2-moe,
// E 4, C 320, D 768, F 3072, float32) it does 12.1 GFLOP on 83 MB, so it
// is bound by operations: 0.18 ms at the 67 TFLOP/s float32 rate outside
// the tensor cores. In bfloat16 the same shape is bound by bytes.
//
// Design. The TPU kernel walks (expert, capacity block, ffn block) in
// order and carries a float32 accumulator across the ffn axis in VMEM.
// CUDA blocks run in no order, so the work is two launches on one stream,
// each a tiled product with one block per (64 x 64 output tile, expert):
//   1. up:   h (E, C, F) = act(x Wg [, x Wu]) into a float32 scratch
//            the wrapper allocates; the activation is fused into the
//            store.
//   2. down: out (E, C, D) = h Wd, cast to the buffer's type.
// A block stages 16-deep slices of both operands in shared memory; each
// of its 256 threads keeps a 4 x 4 register tile (two for SwiGLU). Ragged
// edges (C, D or F not a multiple of 64 or 16) are zero-filled on load
// and masked on store, so no padding copy is made. This is the simple
// first kernel: it runs on the CUDA cores, not the tensor cores.
#include "common.cuh"

#define BM 64        // output rows per block
#define BN 64        // output columns per block
#define BK 16        // reduction depth staged per step
#define THREADS 256  // 16 x 16 threads, each 4 x 4 outputs
#define TM 4
#define TN 4

enum Epilogue { EPI_STORE = 0, EPI_GELU = 1, EPI_SWIGLU = 2 };

static int cdiv(int a, int b) { return (a + b - 1) / b; }

// out[e] (M, N) = epi(a[e] (M, K) @ b[e] (K, N) [, a[e] @ b2[e]]) for
// e = blockIdx.z; all row-major and contiguous.
template <typename TA, typename TB, typename TO, int EPI>
__global__ void __launch_bounds__(THREADS)
ffn_gemm_kernel(const TA* __restrict__ a, const TB* __restrict__ b,
                const TB* __restrict__ b2, int M, int K, int N,
                TO* __restrict__ out) {
  __shared__ float as[BK][BM + 1];   // transposed; +1 keeps stores apart
  __shared__ float bs[BK][BN];
  __shared__ float bs2[BK][BN];
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const TA* ae = a + (size_t)e * M * K;
  const TB* be = b + (size_t)e * K * N;
  const TB* b2e = EPI == EPI_SWIGLU ? b2 + (size_t)e * K * N : nullptr;

  float acc[TM][TN], acc2[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = acc2[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int l = threadIdx.x; l < BM * BK; l += THREADS) {
      const int r = l / BK, kk = l % BK;
      const int gm = m0 + r, gk = k0 + kk;
      as[kk][r] = (gm < M && gk < K) ? to_f32(ae[(size_t)gm * K + gk]) : 0.f;
    }
    for (int l = threadIdx.x; l < BK * BN; l += THREADS) {
      const int kk = l / BN, c = l % BN;
      const int gk = k0 + kk, gn = n0 + c;
      const bool in = gk < K && gn < N;
      bs[kk][c] = in ? to_f32(be[(size_t)gk * N + gn]) : 0.f;
      if (EPI == EPI_SWIGLU)
        bs2[kk][c] = in ? to_f32(b2e[(size_t)gk * N + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN], bv2[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        bv[j] = bs[kk][tx + 16 * j];
        if (EPI == EPI_SWIGLU) bv2[j] = bs2[kk][tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
          if (EPI == EPI_SWIGLU) acc2[i][j] = fmaf(av[i], bv2[j], acc2[i][j]);
        }
    }
    __syncthreads();
  }

  TO* oe = out + (size_t)e * M * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= N) continue;
      float v = acc[i][j];
      if (EPI == EPI_GELU) v = gelu_tanh_f(v);
      if (EPI == EPI_SWIGLU) v = silu_f(v) * acc2[i][j];
      oe[(size_t)gm * N + gn] = from_f32<TO>(v);
    }
  }
}

template <typename T>
static int launch(const void* buf, const void* wg, const void* wu,
                  const void* wd, int E, int C, int D, int F, float* h,
                  void* out, cudaStream_t s) {
  const T* x = static_cast<const T*>(buf);
  const dim3 up_grid(cdiv(F, BN), cdiv(C, BM), E);
  if (wu != nullptr) {
    ffn_gemm_kernel<T, T, float, EPI_SWIGLU><<<up_grid, THREADS, 0, s>>>(
        x, static_cast<const T*>(wg), static_cast<const T*>(wu), C, D, F, h);
  } else {
    ffn_gemm_kernel<T, T, float, EPI_GELU><<<up_grid, THREADS, 0, s>>>(
        x, static_cast<const T*>(wg), nullptr, C, D, F, h);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 down_grid(cdiv(D, BN), cdiv(C, BM), E);
  ffn_gemm_kernel<float, T, T, EPI_STORE><<<down_grid, THREADS, 0, s>>>(
      h, static_cast<const T*>(wd), nullptr, C, F, D, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int expert_ffn(const void* buf, const void* w_gate,
                          const void* w_up, const void* w_down, int dtype,
                          int E, int C, int D, int F, void* h, void* out,
                          void* stream) {
  if (E < 1 || E > 65535 || C < 1 || D < 1 || F < 1 ||
      cdiv(C, BM) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* hf = static_cast<float*>(h);
  if (dtype == REPRO_F32)
    return launch<float>(buf, w_gate, w_up, w_down, E, C, D, F, hf, out, s);
  if (dtype == REPRO_BF16)
    return launch<__nv_bfloat16>(buf, w_gate, w_up, w_down, E, C, D, F, hf,
                                 out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

REPRO_EXPORT_ERROR_STRING
