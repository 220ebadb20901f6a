// Dropless ragged grouped expert FFN for Hopper.
//
// Replaces: src/repro/kernels/grouped_moe/kernel.py, grouped_moe_kernel
//           (body _grouped_ffn_kernel).
//
// Layout (built by repro_torch.models.moe.grouped_dispatch_from_fused):
// token rows sorted by expert into x (R, D), each expert's group padded
// with zero rows to a multiple of 8, so row tile t (8 rows) belongs to
// expert tile_expert[t]; tiles past the last group are zero. Per tile:
//     swiglu: out = (silu(x Wg[e]) * (x Wu[e])) Wd[e]
//     gelu:   out = gelu_tanh(x Wg[e]) Wd[e]
// with float32 sums; inputs and outputs are float32 or bfloat16, h (the up
// product's output) is float32, and the output is cast once.
//
// What bounds it on H100: at serving shapes each active expert's weights
// are read for a handful of rows, so it is bound by weight bytes: at
// gpt2-moe decode about 57 MB in float32 (17 us at 3.35 TB/s), at
// qwen2-moe decode 484 MB. A plain read of the same bytes (one torch.sum)
// takes 0.030 and 0.166 ms on the H100 from a clean L2, so fixed latency
// counts at decode: each launch spends about 7 us outside its stream
// (staging, cluster barriers, merge). Only at prompts of hundreds of
// tokens per expert do the products' operations count.
//
// Two launches on one stream, up then down, and two paths; the wrapper's
// plan (grouped_moe/ops.py, grouped_plan) picks the path, the splits and
// the cluster size from the shapes alone:
//
// Short groups (decode and short prompts: a few rows per expert). A block
// of 128 threads owns (K slice, row tile, column block); each thread owns
// 16 bytes of columns (4 float32 or 8 bfloat16) and, where the block's
// warps do not all fit across the columns, every 2nd or 4th row of the
// slice. Each thread streams its own weight rows into its own ring of 6
// shared-memory stages with 16-byte cp.async copies (5 stages, 40 KB a
// block, in flight) and reads them back itself, so the stream needs no
// barrier (rows that are not whole 16-byte chunks are read element by
// element instead). The block's rows of x (or h) are staged once; only
// the rows that are not all zero get multiply-adds (the kernel is
// instantiated for 1..8 such rows), and a tile or a slice with none reads
// no weight. The K slices of a column block are one thread-block cluster
// (up to 8 blocks): each block leaves its float32 sums in its shared
// memory and every block merges a share of them, adding all blocks' sums
// in a fixed order through distributed shared memory (so repeated runs
// give the same bits), then stores h (activation fused) or the output
// (cast; the all-zero rows as exact zeros, FFN(0) = 0 without biases). No
// partial sums go to global memory and there is no reduce launch.
//
// Long groups (prompts: tens to hundreds of rows per expert) run on the
// tensor cores with the capacity FFN's core (ffn_wgmma.cuh, grouped_
// wgmma_kernel): 64-row slabs from each expert's first row, float32 as
// 3xTF32 and bfloat16 as a bf16 up product and a down product of h (hi /
// lo) against the weights, with the same cluster merges.
//
// Between the launches: the down launch is a programmatic dependent launch
// (griddepcontrol): its blocks start while the up launch finishes and put
// their first weight stages in flight (the weights do not depend on h)
// before they wait for h. h (R x F float32) and one live-row mask per
// tile (short path) live in a per-device workspace that the wrapper grows
// on demand, so a call allocates only its output.
#include "ffn_wgmma.cuh"

#define ROWS 8            // block_rows of the grouped layout
#define SHORT_THREADS 128
#define SHORT_STAGES 6    // each thread's ring of weight stages
#define STAGE_ROWS 4      // weight rows x matrices a thread copies a stage
#define MAX_SLICE 768     // longest K slice a short block stages
#define MAX_CLUSTER GROUPED_MAX_CLUSTER
#define PLAN_INTS 19      // path, then 9 per product (up, down)

// One product as the wrapper's plan gives it.
struct Product {
  int threads, cols, col_blocks, row_blocks, splits, slice, rows_per_stage,
      stages, smem;
};

struct ShortArgs {
  const void* a;            // up: x (R, K) in T; down: h (R, K) float32
  const void* b;            // (E, K, N) weights in T
  const void* b2;           // SwiGLU's W_up, else null
  const void* x;            // the layout's rows (R, x_cols) in T
  const int* tile_expert;   // (R / 8,)
  int* tile_mask;           // (R / 8,) rows of each tile that are not zero
  void* out;                // up: h (R, N) float32; down: (R, N) in T
  int E, K, N, x_cols, slice, cols;
  int bulk;                 // weight rows are whole, aligned 16-byte chunks
};

// A thread's weight rows per ring stage: 16 bytes of each of STAGE_ROWS
// rows (of half as many rows of both matrices for SwiGLU's up product).
static __host__ __device__ int rows_per_thread(int nb) {
  return STAGE_ROWS / nb;
}

// Row groups of a short block: its 4 warps split the columns (cols / (32
// x VEC) warps across) and the rows of the slice (the rest).
static __host__ __device__ int row_groups(int cols, int vec) {
  return SHORT_THREADS * vec / cols;
}

// Shared memory of a short-path block: the threads' weight rings (48 KB),
// then the staged rows of x or h (float32, 8 rows of the slice); the row
// groups' sums (groups x NB x 8 rows x cols float32) reuse it from the
// start.
static size_t short_smem(int nb, int elem, int cols, int slice) {
  const size_t ring = (size_t)SHORT_STAGES * STAGE_ROWS * SHORT_THREADS * 16;
  const size_t need = ring + (size_t)ROWS * slice * 4;
  const size_t sums =
      (size_t)row_groups(cols, 16 / elem) * nb * ROWS * cols * 4;
  return need > sums ? need : sums;
}

template <typename T, int VEC>
__device__ __forceinline__ void unpack(uint4 w, float (&v)[VEC]);
template <>
__device__ __forceinline__ void unpack<float, 4>(uint4 w, float (&v)[4]) {
  v[0] = __uint_as_float(w.x);
  v[1] = __uint_as_float(w.y);
  v[2] = __uint_as_float(w.z);
  v[3] = __uint_as_float(w.w);
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16, 8>(uint4 w,
                                                         float (&v)[8]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(u[i] << 16);
    v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// The state of one short-path thread and block, shared by the phases.
// Thread (group g, column col) takes rows g, g + groups, ... of the slice,
// RPT of them per stage, and its 16 bytes of each: it copies them into its
// own ring slots with cp.async and reads them back itself, so the stream
// needs no barrier.
template <typename T, bool DUAL>
struct ShortBlock {
  static constexpr int VEC = 16 / sizeof(T), NB = DUAL ? 2 : 1;
  static constexpr int RPT = STAGE_ROWS / NB;
  ShortArgs p;
  unsigned char* smem;
  int e, t, c0, k_begin, len;
  int groups, group, col;   // row groups; this thread's group and column
  int nst;                  // this thread's ring stages

  __device__ uint4* slot(int s, int j, int m) const {
    return reinterpret_cast<uint4*>(smem) +
           (((s % SHORT_STAGES) * RPT + j) * NB + m) * SHORT_THREADS +
           threadIdx.x;
  }
  __device__ const T* weights(int m) const {
    return static_cast<const T*>(m == 0 ? p.b : p.b2) + (size_t)e * p.K * p.N;
  }
  __device__ float* staged() const {
    return reinterpret_cast<float*>(
        smem + SHORT_STAGES * STAGE_ROWS * SHORT_THREADS * 16);
  }
  __device__ int row(int s, int j) const {   // in the slice, or -1
    const int k = group + groups * (s * RPT + j);
    return k < len ? k : -1;
  }
  // stage s of this thread's ring (one commit group, maybe empty)
  __device__ void issue(int s) const {
    if (p.bulk && c0 + col < p.N)
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const int k = row(s, j);
        if (k < 0) break;
#pragma unroll
        for (int m = 0; m < NB; ++m)
          cp_async16(slot(s, j, m),
                     weights(m) + (size_t)(k_begin + k) * p.N + c0 + col);
      }
    cp_async_commit();
  }
  __device__ void prologue() const {
    for (int s = 0; s < SHORT_STAGES - 1; ++s) issue(s);
  }
  // this thread's weights of row j of stage s: from its ring, or (rows
  // that are not whole 16-byte chunks) element by element, zero past N
  __device__ void weights_of(int s, int j, int m, float (&w)[VEC]) const {
    if (p.bulk) {
      unpack<T, VEC>(*slot(s, j, m), w);
    } else {
      const T* src = weights(m) + (size_t)(k_begin + row(s, j)) * p.N + c0;
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        w[v] = c0 + col + v < p.N ? to_f32(src[col + v]) : 0.f;
    }
  }
  // this thread's sums of row `r`, matrix m
  __device__ float* sums_of(int m, int r) const {
    return reinterpret_cast<float*>(smem) +
           (((size_t)group * NB + m) * ROWS + r) * p.cols + col;
  }

  // Stream the thread's rows against the NR live rows (their staged rows
  // at arow[j]), then leave the group's sums of all 8 rows in shared
  // memory (zeros for the rows without work).
  template <int NR>
  __device__ void run(const int* arow, const int* rows_of, int mask) const {
    float acc[NB][NR][VEC];
#pragma unroll
    for (int m = 0; m < NB; ++m)
#pragma unroll
      for (int j = 0; j < NR; ++j)
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[m][j][v] = 0.f;
    const float* xr[NR];
#pragma unroll
    for (int j = 0; j < NR; ++j) xr[j] = staged() + arow[j] * p.slice;
    for (int s = 0; s < nst; ++s) {
      cp_async_wait<SHORT_STAGES - 2>();   // stage s has landed
      issue(s + SHORT_STAGES - 1);         // into the slot of stage s - 1
#pragma unroll
      for (int jj = 0; jj < RPT; ++jj) {
        const int k = row(s, jj);
        if (k < 0) break;
        float w[NB][VEC];
#pragma unroll
        for (int m = 0; m < NB; ++m) weights_of(s, jj, m, w[m]);
#pragma unroll
        for (int j = 0; j < NR; ++j) {
          const float a = xr[j][k];
#pragma unroll
          for (int m = 0; m < NB; ++m)
#pragma unroll
            for (int v = 0; v < VEC; ++v)
              acc[m][j][v] = fmaf(a, w[m][v], acc[m][j][v]);
        }
      }
    }
    __syncthreads();   // every ring is idle: the sums take their place
#pragma unroll
    for (int m = 0; m < NB; ++m) {
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        float* d = sums_of(m, rows_of[j]);
#pragma unroll
        for (int v = 0; v < VEC; v += 4)
          *reinterpret_cast<float4*>(d + v) = make_float4(
              acc[m][j][v], acc[m][j][v + 1], acc[m][j][v + 2],
              acc[m][j][v + 3]);
      }
      for (int r = 0; r < ROWS; ++r) {
        if (mask >> r & 1) continue;
        float* d = sums_of(m, r);
#pragma unroll
        for (int v = 0; v < VEC; v += 4)
          *reinterpret_cast<float4*>(d + v) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }

  __device__ void zero_sums() const {
    float* sums = reinterpret_cast<float*>(smem);
    for (int i = threadIdx.x; i < groups * NB * ROWS * p.cols;
         i += blockDim.x)
      sums[i] = 0.f;
  }
};

// n values through load(i, v) then put(i, v) (the up launch's rows of x).
// Up to 8 a thread, one at a time (the weight stream, started first,
// hides them; at gpt2-moe widths this was faster on the H100 than 8 loads
// in flight, which compete with the stream's copies); more, 8 a thread at
// a time, all 8 in flight before the first is used (faster at qwen2-moe's
// slices of 300-700 rows). The down launch stages its rows of h one at a
// time: 8 in flight made it slower at 16-token prompts.
template <typename Load, typename Put>
__device__ __forceinline__ void stage_rows(int n, Load load, Put put) {
  if (n <= 8 * (int)blockDim.x) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      float v;
      load(i, v);
      put(i, v);
    }
    return;
  }
  for (int base = 0; base < n; base += 8 * (int)blockDim.x) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = base + u * blockDim.x + threadIdx.x;
      v[u] = 0.f;
      if (i < n) load(i, v[u]);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = base + u * blockDim.x + threadIdx.x;
      if (i < n) put(i, v[u]);
    }
  }
}

// Whether the first (up to) 32 values of a row are not all zero (warp 0;
// the layout puts a tile's live rows first, so this tells a tile with
// work from an empty one before its rows are staged).
template <typename T>
__device__ bool row_starts_nonzero(const T* row, int n) {
  const bool nz = (int)threadIdx.x < n && to_f32(row[threadIdx.x]) != 0.f;
  return __any_sync(~0u, nz);
}

// Short-path product: up (x -> h, activation fused) or down (h -> out).
// blockIdx = (K slice = cluster rank, row tile, column block).
template <typename T, bool UP, bool DUAL>
__global__ void __launch_bounds__(SHORT_THREADS)
grouped_short_kernel(const ShortArgs p) {
  namespace cg = cooperative_groups;
  using B = ShortBlock<T, DUAL>;
  constexpr int VEC = B::VEC, NB = B::NB;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_mask, s_guess, s_arow[ROWS], s_rows[ROWS];
  if (UP) griddep_launch_dependents();
  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x, t = blockIdx.y, c0 = blockIdx.z * p.cols;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col_warps = p.cols / (32 * VEC);
  const int k_begin = split * p.slice;
  B b{p,
      smem,
      min(max(p.tile_expert[t], 0), p.E - 1),
      t,
      c0,
      k_begin,
      min(p.K, k_begin + p.slice) - k_begin,
      SHORT_THREADS / 32 / col_warps,
      warp / col_warps,
      (warp % col_warps) * 32 * VEC + lane * VEC,
      0};
  const int my_rows = b.len > b.group ? cdiv(b.len - b.group, b.groups) : 0;
  b.nst = cdiv(my_rows, B::RPT);
  float* a_s = b.staged();

  // The weight stream starts on a guess (the first values of the tile's
  // first row: of this slice of x for up, of x for down, whose h is not
  // ready yet), before the rows are staged and before the up launch is
  // waited for; the rows then say which rows get work.
  if (warp == 0) {
    const T* row0 = static_cast<const T*>(p.x) + (size_t)t * ROWS * p.x_cols;
    const bool guess = UP ? row_starts_nonzero(row0 + k_begin,
                                               min(b.len, 32))
                          : row_starts_nonzero(row0, min(p.x_cols, 32));
    if (lane == 0) {
      s_guess = guess;
      s_mask = 0;
    }
  }
  __syncthreads();
  const bool guess = s_guess;
  if (guess) b.prologue();

  int mask;          // rows of the tile this block multiplies
  if (UP) {
    // stage this slice of the tile's rows of x; a row that is zero here
    // gets no work from this block
    const T* xt = static_cast<const T*>(p.a) + (size_t)t * ROWS * p.K;
    int m = 0;
    stage_rows(ROWS * b.len, [&](int i, float& v) {
      const int r = i / b.len, k = i - r * b.len;
      v = to_f32(xt[(size_t)r * p.K + k_begin + k]);
    }, [&](int i, float v) {
      const int r = i / b.len, k = i - r * b.len;
      a_s[r * p.slice + k] = v;
      if (v != 0.f) m |= 1 << r;
    });
    if (m) atomicOr(&s_mask, m);
    __syncthreads();
    mask = s_mask;
  } else {
    griddep_wait();
    mask = p.tile_mask[t];   // written by the up launch
    // stage the slice of h of the live rows, packed
    const float* ht = static_cast<const float*>(p.a) + (size_t)t * ROWS * p.K;
    for (int i = threadIdx.x; i < __popc(mask) * b.len; i += blockDim.x) {
      const int j = i / b.len, k = i - j * b.len;
      const int r = __fns(mask, 0, j + 1);   // the j-th set bit
      a_s[j * p.slice + k] = ht[(size_t)r * p.K + k_begin + k];
    }
  }
  if (mask && !guess) b.prologue();
  if (threadIdx.x == 0) {
    int j = 0;
    for (int r = 0; r < ROWS; ++r)
      if (mask >> r & 1) {
        s_rows[j] = r;
        s_arow[j] = UP ? r : j;
        ++j;
      }
  }
  __syncthreads();

  switch (__popc(mask)) {
    case 1: b.template run<1>(s_arow, s_rows, mask); break;
    case 2: b.template run<2>(s_arow, s_rows, mask); break;
    case 3: b.template run<3>(s_arow, s_rows, mask); break;
    case 4: b.template run<4>(s_arow, s_rows, mask); break;
    case 5: b.template run<5>(s_arow, s_rows, mask); break;
    case 6: b.template run<6>(s_arow, s_rows, mask); break;
    case 7: b.template run<7>(s_arow, s_rows, mask); break;
    case 8: b.template run<8>(s_arow, s_rows, mask); break;
    default:
      // nothing to multiply; copies started on the guess land first
      cp_async_wait<0>();
      __syncthreads();
      b.zero_sums();
  }

  // merge the cluster's sums: every block a share; the blocks' sums in
  // rank order, each block's row groups in order
  cluster.sync();
  const int cs = cluster.num_blocks(), rank = cluster.block_rank();
  int rows_live = mask;
  if (UP) {   // every warp: lane k reads block k's rows
    const int m = lane < cs ? *cluster.map_shared_rank(&s_mask, lane) : 0;
    rows_live = (int)__reduce_or_sync(~0u, (unsigned)m);
  }
  if (UP && rank == 0 && blockIdx.z == 0 && threadIdx.x == 0)
    p.tile_mask[t] = rows_live;
  const float* sums = reinterpret_cast<const float*>(smem);
  const int quads = p.cols / 4;
  const size_t group_floats = (size_t)NB * ROWS * p.cols;
  for (int i = rank * blockDim.x + threadIdx.x; i < ROWS * quads;
       i += cs * blockDim.x) {
    const int r = i / quads, c = 4 * (i % quads);
    if (c0 + c >= p.N) continue;
    const bool live = rows_live >> r & 1;
    if (UP && !live) continue;   // no h row: the down launch skips it
    float4 g = make_float4(0.f, 0.f, 0.f, 0.f), u = g;
    if (live)
      for (int gr = 0; gr < b.groups; ++gr) {
        // all blocks' sums of this group in flight, then added in order
        float4 v[MAX_CLUSTER], w[MAX_CLUSTER];
#pragma unroll
        for (int k = 0; k < MAX_CLUSTER; ++k)
          if (k < cs) {
            const float* src = cluster.map_shared_rank(sums, k) +
                               gr * group_floats + r * p.cols + c;
            v[k] = *reinterpret_cast<const float4*>(src);
            if (DUAL) w[k] = *reinterpret_cast<const float4*>(src + ROWS * p.cols);
          }
#pragma unroll
        for (int k = 0; k < MAX_CLUSTER; ++k)
          if (k < cs) {
            add4(g, v[k]);
            if (DUAL) add4(u, w[k]);
          }
      }
    const size_t at = (size_t)(t * ROWS + r) * p.N + c0 + c;
    const int n = min(4, p.N - c0 - c);
    const float gs[4] = {g.x, g.y, g.z, g.w}, us[4] = {u.x, u.y, u.z, u.w};
    if (UP) {
      float h[4];
#pragma unroll
      for (int v = 0; v < 4; ++v)
        h[v] = DUAL ? silu_f(gs[v]) * us[v] : gelu_tanh_f(gs[v]);
      float* o = static_cast<float*>(p.out) + at;
      if (p.bulk) {
        *reinterpret_cast<float4*>(o) = make_float4(h[0], h[1], h[2], h[3]);
      } else {
        for (int v = 0; v < n; ++v) o[v] = h[v];
      }
    } else {
      T* o = static_cast<T*>(p.out) + at;
      if (p.bulk) {
        store4<T>(o, g);
      } else {
        for (int v = 0; v < n; ++v) o[v] = from_f32<T>(gs[v]);
      }
    }
  }
  cluster.sync();   // no block leaves while another reads its sums
}

// ------------------------------------------------------------- launching

// The dynamic shared memory a kernel has been allowed so far (one entry
// per kernel; the library has twelve).
static int allowed_smem(const void* kernel, int bytes) {
  static const void* kernels[32];
  static int allowed[32];
  int i = 0;
  while (i < 32 && kernels[i] != nullptr && kernels[i] != kernel) ++i;
  if (i == 32) return static_cast<int>(cudaErrorUnknown);
  if (kernels[i] == kernel && allowed[i] >= bytes) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernels[i] = kernel;
  allowed[i] = bytes;
  return 0;
}

template <typename K, typename... Args>
static int launch_ex(K kernel, const Product& pp, bool dependent,
                     cudaStream_t s, Args... args) {
  int status = allowed_smem(reinterpret_cast<const void*>(kernel), pp.smem);
  if (status != 0) return status;
  cudaError_t err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pp.splits, pp.row_blocks, pp.col_blocks);
  cfg.blockDim = dim3(pp.threads);
  cfg.dynamicSmemBytes = pp.smem;
  cfg.stream = s;
  cudaLaunchAttribute at[2];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = pp.splits;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  at[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  at[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = at;
  cfg.numAttrs = dependent ? 2 : 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// the plan's split of K into slices: whole stages, no empty split, one
// cluster of at most MAX_CLUSTER blocks
static bool valid_split(const Product& pp, int K, int bk) {
  return pp.splits >= 1 && pp.splits <= MAX_CLUSTER &&
         pp.rows_per_stage == bk && pp.slice % bk == 0 && pp.slice > 0 &&
         cdiv(K, pp.slice) == pp.splits;
}

template <typename T, bool UP, bool DUAL>
static int launch_short(const ShortArgs& a, const Product& pp, int ntiles,
                        cudaStream_t s) {
  const int elem = sizeof(T), vec = 16 / elem, nb = DUAL ? 2 : 1;
  const int col_warps = pp.cols / (32 * vec);
  if (pp.threads != SHORT_THREADS || pp.cols % (32 * vec) != 0 ||
      (col_warps != 1 && col_warps != 2 && col_warps != 4) ||
      pp.col_blocks != cdiv(a.N, pp.cols) || pp.row_blocks != ntiles ||
      !valid_split(pp, a.K,
                   rows_per_thread(nb) * row_groups(pp.cols, vec)) ||
      pp.slice > MAX_SLICE || pp.stages != SHORT_STAGES ||
      (size_t)pp.smem < short_smem(nb, elem, pp.cols, pp.slice))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  ShortArgs args = a;
  args.slice = pp.slice;
  args.cols = pp.cols;
  return launch_ex(grouped_short_kernel<T, UP, DUAL>, pp, !UP, s, args);
}

template <int MODE, int EPI, typename TO>
static int launch_long(GemmArgs args, const Product& pp, cudaStream_t s) {
  using C = Tile<MODE, EPI>;
  if (pp.threads != 128 || pp.cols != C::BN || pp.stages != STAGES ||
      pp.col_blocks != cdiv(args.N, C::BN) || pp.row_blocks < 1 ||
      !valid_split(pp, args.K, C::BK) || pp.smem < C::smem(1) ||
      (size_t)args.ntiles * 4 > (size_t)C::smem(1) - 1024)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t ea = sizeof(typename C::TA), eb = sizeof(typename C::TB);
  auto al = [](const void* q) {
    return q == nullptr || reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  if (!al(args.a) || !al(args.b) || !al(args.b2) || !al(args.x) ||
      (args.K * ea) % 16 != 0 || (args.N * eb) % 16 != 0 ||
      args.x_row_bytes % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  args.slice = pp.slice;
  args.tma = 1;
  args.part = nullptr;
  CUtensorMap map_a, map_b, map_b2;
  memset(&map_a, 0, sizeof(map_a));
  memset(&map_b, 0, sizeof(map_b));
  memset(&map_b2, 0, sizeof(map_b2));
  int err = encode_3d(&map_a, args.a, ea, args.K, args.M, 1, C::BK, 64,
                      CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0)
    err = encode_3d(&map_b, args.b, eb, args.N, args.K, args.E, C::BN, C::BK,
                    CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err == 0 && args.b2 != nullptr)
    err = encode_3d(&map_b2, args.b2, eb, args.N, args.K, args.E, C::BN,
                    C::BK, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != 0) return err;
  return launch_ex(grouped_wgmma_kernel<MODE, EPI, TO>, pp,
                   args.wait_for_a != 0, s, args, map_a, map_b, map_b2);
}

template <typename T>
static int launch(const void* x, const int* te, const void* wg,
                  const void* wu, const void* wd, int ntiles, int D, int F,
                  int E, const int* plan, float* work, void* out,
                  cudaStream_t s) {
  Product up, down;
  memcpy(&up, plan + 1, sizeof(up));
  memcpy(&down, plan + 1 + sizeof(up) / sizeof(int), sizeof(down));
  const int R = ntiles * ROWS;
  float* h = work;
  int* tile_mask = reinterpret_cast<int*>(work + (size_t)R * F);
  const bool swiglu = wu != nullptr;
  int err;
  if (plan[0] == 0) {   // short groups
    const bool bulk =
        (D * sizeof(T)) % 16 == 0 && (F * sizeof(T)) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(wg) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(wu) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(wd) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(out) % 16 == 0;
    ShortArgs a{x, wg, wu, x, te, tile_mask, h, E, D, F, D, 0, 0, bulk};
    err = swiglu ? launch_short<T, true, true>(a, up, ntiles, s)
                 : launch_short<T, true, false>(a, up, ntiles, s);
    if (err != 0) return err;
    ShortArgs d{h, wd, nullptr, x, te, tile_mask, out, E, F, D, D, 0, 0, bulk};
    return launch_short<T, false, false>(d, down, ntiles, s);
  }
  if (plan[0] != 1) return static_cast<int>(cudaErrorInvalidValue);
  // long groups
  GemmArgs a{};
  a.a = x;
  a.b = wg;
  a.b2 = wu;
  a.E = E;
  a.M = R;
  a.K = D;
  a.N = F;
  a.out = h;
  a.tile_expert = te;
  a.x = x;
  a.x_row_bytes = D * sizeof(T);
  a.ntiles = ntiles;
  a.wait_for_a = 0;
  err = swiglu ? launch_long<Ffn<T>::UP, EPI_SWIGLU, float>(a, up, s)
               : launch_long<Ffn<T>::UP, EPI_GELU, float>(a, up, s);
  if (err != 0) return err;
  GemmArgs d = a;
  d.a = h;
  d.b = wd;
  d.b2 = nullptr;
  d.K = F;
  d.N = D;
  d.out = out;
  d.wait_for_a = 1;
  return launch_long<Ffn<T>::DOWN, EPI_STORE, T>(d, down, s);
}

// plan: PLAN_INTS ints from grouped_plan (path 0 short / 1 long, then up
// and down as Product); work: the float32 workspace (h, R x F, then one
// int per tile)
extern "C" int grouped_moe_ffn(const void* x, const void* tile_expert,
                               const void* w_gate, const void* w_up,
                               const void* w_down, int dtype, int ntiles,
                               int D, int F, int E, const int* plan,
                               void* work, void* out, void* stream) {
  if (ntiles < 1 || ntiles > 65535 || D < 1 || F < 1 || E < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* te = static_cast<const int*>(tile_expert);
  float* w = static_cast<float*>(work);
  if (dtype == REPRO_F32)
    return launch<float>(x, te, w_gate, w_up, w_down, ntiles, D, F, E, plan,
                         w, out, s);
  if (dtype == REPRO_BF16)
    return launch<__nv_bfloat16>(x, te, w_gate, w_up, w_down, ntiles, D, F,
                                 E, plan, w, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int grouped_moe_plan_ints() { return PLAN_INTS; }

REPRO_EXPORT_ERROR_STRING
