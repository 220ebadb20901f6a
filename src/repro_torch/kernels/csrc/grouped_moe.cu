// Dropless ragged grouped expert FFN for Hopper.
//
// Replaces: src/repro/kernels/grouped_moe/kernel.py, grouped_moe_kernel
//           (body _grouped_ffn_kernel).
//
// Layout (built by repro_torch.models.moe.grouped_dispatch_from_fused):
// token rows sorted by expert into x (R, D), each expert's group padded
// with zero rows to a multiple of 8, so row tile t (8 rows) belongs to
// expert tile_expert[t]. Per tile:
//     swiglu: out = (silu(x Wg[e]) * (x Wu[e])) Wd[e]
//     gelu:   out = gelu_tanh(x Wg[e]) Wd[e]
// with float32 accumulation; inputs and outputs are float32 or bfloat16.
//
// What bounds it on H100: at serving shapes each active expert's weights
// are read for a handful of rows, so it is bound by weight bytes. At
// gpt2-moe decode one expert is 2 x 768 x 3072 x 4 B = 18.9 MB in float32;
// with up to 4 active experts a layer moves about 75 MB, 22 us at
// 3.35 TB/s. FLOPs are 2 per weight element per row: far below the
// card's rate.
//
// Design. The TPU kernel walks (row tile, ffn tile) in order and keeps a
// float32 accumulator across the ffn axis in VMEM. A decode step has only
// a few row tiles, so one block per (tile, column block) leaves most of
// the card idle and few loads in flight; the products are therefore split
// along their reduction axis as well (split-K), into enough blocks to
// fill the card, with partial sums reduced in a fixed order (no atomics,
// so repeated runs give the same bits). Three launches on one stream:
//   1. grouped_up_kernel: block (tile t, 256 ffn columns, slice s of D);
//      one thread per column streams its column of Wg (and Wu) over the
//      slice, coalesced across the warp, with x staged in shared memory,
//      and writes the 8 rows' partial sums.
//   2. grouped_down_kernel: block (tile t, 256 output columns, slice s of
//      F); it stages h = act(sum of the up partials) for its slice in
//      shared memory and streams its column of Wd against it.
//   3. grouped_reduce_kernel: out = sum of the down partials, cast to
//      the output type.
// A block loads its own tile_expert[t] (the TPU kernel's scalar
// prefetch). A block whose staged slice of x (or h) is all zero reads no
// weight and writes zero partials: the group padding rows and the tiles
// past the last group cost no weight bytes, and they come out as zeros
// (FFN(0) = 0 without biases).
#include "common.cuh"

#define ROWS 8            // block_rows of the grouped layout
#define COLS 256          // threads per block = columns per block
#define CHUNK 256         // staged width of x or h
#define SLICE_MIN 64      // shortest reduction slice a block takes
#define TARGET_BLOCKS 528 // 4 blocks for each of the 132 SMs

// Reduction slices for a product over K with `blocks` blocks of output.
static int splits_for(int blocks, int K) {
  const int want = (TARGET_BLOCKS + blocks - 1) / blocks;
  const int most = K / SLICE_MIN > 1 ? K / SLICE_MIN : 1;
  return want < most ? want : most;
}

static int cdiv(int a, int b) { return (a + b - 1) / b; }

template <typename T, bool SWIGLU>
__global__ void grouped_up_kernel(const T* __restrict__ x,
                                  const int* __restrict__ tile_expert,
                                  const T* __restrict__ wg,
                                  const T* __restrict__ wu, int R, int D,
                                  int F, int E, int slice,
                                  float* __restrict__ part_g,
                                  float* __restrict__ part_u) {
  __shared__ float xs[ROWS][CHUNK];
  const int t = blockIdx.x, s = blockIdx.z;
  const int f = blockIdx.y * COLS + threadIdx.x;
  const int e = min(max(tile_expert[t], 0), E - 1);
  const T* xt = x + (size_t)t * ROWS * D;
  const T* g_col = wg + (size_t)e * D * F + f;
  const T* u_col = SWIGLU ? wu + (size_t)e * D * F + f : nullptr;
  const int d_begin = s * slice, d_end = min(D, d_begin + slice);

  float acc_g[ROWS], acc_u[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc_g[r] = acc_u[r] = 0.f;

  for (int d0 = d_begin; d0 < d_end; d0 += CHUNK) {
    const int width = min(CHUNK, d_end - d0);
    __syncthreads();
    int nonzero = 0;
    for (int i = threadIdx.x; i < ROWS * CHUNK; i += COLS) {
      const int r = i / CHUNK, dd = i % CHUNK;
      const float v = dd < width ? to_f32(xt[(size_t)r * D + d0 + dd]) : 0.f;
      xs[r][dd] = v;
      nonzero |= v != 0.f;
    }
    if (!__syncthreads_or(nonzero) || f >= F) continue;
#pragma unroll 8
    for (int dd = 0; dd < width; ++dd) {
      const float wgv = to_f32(g_col[(size_t)(d0 + dd) * F]);
      float wuv = 0.f;
      if (SWIGLU) wuv = to_f32(u_col[(size_t)(d0 + dd) * F]);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        acc_g[r] = fmaf(xs[r][dd], wgv, acc_g[r]);
        if (SWIGLU) acc_u[r] = fmaf(xs[r][dd], wuv, acc_u[r]);
      }
    }
  }
  if (f >= F) return;
  const size_t base = ((size_t)s * R + (size_t)t * ROWS) * F + f;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    part_g[base + (size_t)r * F] = acc_g[r];
    if (SWIGLU) part_u[base + (size_t)r * F] = acc_u[r];
  }
}

template <typename T, bool SWIGLU>
__global__ void grouped_down_kernel(const int* __restrict__ tile_expert,
                                    const T* __restrict__ wd,
                                    const float* __restrict__ part_g,
                                    const float* __restrict__ part_u,
                                    int R, int D, int F, int E, int up_splits,
                                    int slice, float* __restrict__ part_o) {
  __shared__ float hs[ROWS][CHUNK];
  const int t = blockIdx.x, s = blockIdx.z;
  const int c = blockIdx.y * COLS + threadIdx.x;
  const int e = min(max(tile_expert[t], 0), E - 1);
  const T* d_col = wd + (size_t)e * F * D + c;
  const int f_begin = s * slice, f_end = min(F, f_begin + slice);
  const size_t up_stride = (size_t)R * F;

  float acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
  for (int f0 = f_begin; f0 < f_end; f0 += CHUNK) {
    const int width = min(CHUNK, f_end - f0);
    __syncthreads();
    int nonzero = 0;
    for (int i = threadIdx.x; i < ROWS * CHUNK; i += COLS) {
      const int r = i / CHUNK, ff = i % CHUNK;
      float h = 0.f;
      if (ff < width) {
        const size_t at = ((size_t)t * ROWS + r) * F + f0 + ff;
        float g = 0.f, u = 0.f;
        for (int k = 0; k < up_splits; ++k) {   // fixed order
          g += part_g[k * up_stride + at];
          if (SWIGLU) u += part_u[k * up_stride + at];
        }
        h = SWIGLU ? silu_f(g) * u : gelu_tanh_f(g);
      }
      hs[r][ff] = h;
      nonzero |= h != 0.f;
    }
    if (!__syncthreads_or(nonzero) || c >= D) continue;
#pragma unroll 8
    for (int ff = 0; ff < width; ++ff) {
      const float wv = to_f32(d_col[(size_t)(f0 + ff) * D]);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(hs[r][ff], wv, acc[r]);
    }
  }
  if (c >= D) return;
  const size_t base = ((size_t)s * R + (size_t)t * ROWS) * D + c;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) part_o[base + (size_t)r * D] = acc[r];
}

template <typename T>
__global__ void grouped_reduce_kernel(const float* __restrict__ part_o,
                                      int splits, size_t n,
                                      T* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = 0.f;
  for (int k = 0; k < splits; ++k) v += part_o[k * n + i];   // fixed order
  out[i] = from_f32<T>(v);
}

struct Plan {
  int up_splits, up_slice, down_splits, down_slice;
  size_t up_floats, down_floats;
};

static Plan plan_for(int ntiles, int D, int F, bool swiglu) {
  Plan p;
  const size_t R = (size_t)ntiles * ROWS;
  p.up_splits = splits_for(ntiles * cdiv(F, COLS), D);
  p.up_slice = cdiv(D, p.up_splits);
  p.down_splits = splits_for(ntiles * cdiv(D, COLS), F);
  p.down_slice = cdiv(F, p.down_splits);
  p.up_floats = (swiglu ? 2 : 1) * (size_t)p.up_splits * R * F;
  p.down_floats = (size_t)p.down_splits * R * D;
  return p;
}

template <typename T>
static int launch(const void* x, const void* tile_expert, const void* wg,
                  const void* wu, const void* wd, int ntiles, int D, int F,
                  int E, float* scratch, void* out, cudaStream_t s) {
  const bool swiglu = wu != nullptr;
  const Plan p = plan_for(ntiles, D, F, swiglu);
  const int R = ntiles * ROWS;
  float* part_g = scratch;
  float* part_u = swiglu ? scratch + p.up_floats / 2 : nullptr;
  float* part_o = scratch + p.up_floats;
  const T* xp = static_cast<const T*>(x);
  const int* te = static_cast<const int*>(tile_expert);
  const dim3 up_grid(ntiles, cdiv(F, COLS), p.up_splits);
  const dim3 down_grid(ntiles, cdiv(D, COLS), p.down_splits);
  if (swiglu) {
    grouped_up_kernel<T, true><<<up_grid, COLS, 0, s>>>(
        xp, te, static_cast<const T*>(wg), static_cast<const T*>(wu), R, D, F,
        E, p.up_slice, part_g, part_u);
  } else {
    grouped_up_kernel<T, false><<<up_grid, COLS, 0, s>>>(
        xp, te, static_cast<const T*>(wg), nullptr, R, D, F, E, p.up_slice,
        part_g, nullptr);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (swiglu) {
    grouped_down_kernel<T, true><<<down_grid, COLS, 0, s>>>(
        te, static_cast<const T*>(wd), part_g, part_u, R, D, F, E,
        p.up_splits, p.down_slice, part_o);
  } else {
    grouped_down_kernel<T, false><<<down_grid, COLS, 0, s>>>(
        te, static_cast<const T*>(wd), part_g, nullptr, R, D, F, E,
        p.up_splits, p.down_slice, part_o);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n = (size_t)R * D;
  grouped_reduce_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      part_o, p.down_splits, n, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Float32 scratch the wrapper must allocate for these shapes.
extern "C" long long grouped_moe_scratch_floats(int ntiles, int D, int F,
                                                int swiglu) {
  const Plan p = plan_for(ntiles, D, F, swiglu != 0);
  return static_cast<long long>(p.up_floats + p.down_floats);
}

extern "C" int grouped_moe_ffn(const void* x, const void* tile_expert,
                               const void* w_gate, const void* w_up,
                               const void* w_down, int dtype, int ntiles,
                               int D, int F, int E, void* scratch, void* out,
                               void* stream) {
  if (ntiles < 1 || ntiles > 65535 || D < 1 || F < 1 || E < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  if (dtype == REPRO_F32)
    return launch<float>(x, tile_expert, w_gate, w_up, w_down, ntiles, D, F,
                         E, sc, out, s);
  if (dtype == REPRO_BF16)
    return launch<__nv_bfloat16>(x, tile_expert, w_gate, w_up, w_down, ntiles,
                                 D, F, E, sc, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

REPRO_EXPORT_ERROR_STRING
