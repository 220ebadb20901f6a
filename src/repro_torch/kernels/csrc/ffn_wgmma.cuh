// The tensor-core core of the port's FFN kernels, shared by the capacity
// FFN (expert_ffn.cu, B4) and the long-group path of the grouped FFN
// (grouped_moe.cu, B2): tile geometry, the K-major swizzled staging of B
// (split into TF32 hi and lo), the hi / lo split of A on its way into the
// wgmma fragment, and the TMA ring with its main loop (ffn_tile).
// expert_ffn.cu describes the arithmetic and the data movement.
//
// ffn_wgmma_kernel is B4's kernel: one (E, M, K) operand A, blocks over
// (N tile, M tile, split x E), split partials to global memory.
// grouped_wgmma_kernel is B2's long-group path over the sorted
// ragged-group layout: blocks over (split, slab, N tile), where a slab is
// up to 64 rows (8 row tiles) of one expert's run of tiles, starting at
// the run's first row; the A rows past the slab (the next expert's) are
// zeroed in the fragment and never stored; the splits of a tile are one
// thread-block cluster, merged in rank order through distributed shared
// memory, and the epilogue (activation into h, or the cast into the
// output) stores the slab's rows.
#pragma once

#include <cooperative_groups.h>
#include <dlfcn.h>
#include <string.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

#define STAGES 4       // TMA ring
#define GROUPED_MAX_CLUSTER 8   // blocks of a grouped tile's cluster

enum Mode { M_3XTF32 = 0, M_2XTF32 = 1, M_BF16 = 2 };
enum Epilogue { EPI_STORE = 0, EPI_GELU = 1, EPI_SWIGLU = 2 };

static __host__ __device__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// the modes of the two products for float32 or bfloat16 data: h (the up
// product's output) is float32 either way
template <typename T>
struct Ffn {
  static constexpr int UP = std::is_same<T, float>::value ? M_3XTF32 : M_BF16;
  static constexpr int DOWN =
      std::is_same<T, float>::value ? M_3XTF32 : M_2XTF32;
};

// Compile-time geometry of one product. 3XTF32: A and B float32.
// 2XTF32: A float32 (h), B bfloat16 (exact in TF32, no residual). BF16: A
// and B bfloat16.
template <int MODE, int EPI>
struct Tile {
  using TA = typename std::conditional<MODE == M_BF16, __nv_bfloat16,
                                       float>::type;
  using TB = typename std::conditional<MODE == M_3XTF32, float,
                                       __nv_bfloat16>::type;
  static constexpr bool DUAL = EPI == EPI_SWIGLU;   // x Wg and x Wu
  static constexpr int NB = DUAL ? 2 : 1;           // B matrices
  static constexpr int BN = DUAL ? 64 : 128;
  static constexpr int PARTS = MODE == M_3XTF32 ? 2 : 1;   // B hi (+ lo)
  static constexpr int OPE = MODE == M_BF16 ? 2 : 4;       // operand bytes
  static constexpr int BK = 128 / OPE;   // K of one stage: 128-byte rows
  static constexpr int OP_BYTES = BN * 128;         // one K-major B tile
  static constexpr int KSTEPS = 128 / 32;           // wgmma k is 32 bytes
  static constexpr int B_RAW = BK * BN * (int)sizeof(TB);
  static constexpr int OPS = 2 * NB * PARTS * OP_BYTES;     // double buffer
  __host__ __device__ static int a_bytes(int wg) { return 64 * wg * 128; }
  // shared memory: operand tiles, A ring, B ring, all 1024-byte aligned
  // (the swizzle atom); + 1024 to align the start
  static int smem(int wg) {
    return 1024 + OPS + STAGES * (a_bytes(wg) + NB * B_RAW);
  }
};

struct GemmArgs {
  const void* a;      // (E, M, K)
  const void* b;      // (E, K, N)
  const void* b2;     // (E, K, N), SwiGLU's up weights, else null
  int E, M, K, N;
  int slice;          // reduction length of one split, a multiple of BK
  int tma;            // rows and bases in 16-byte units: the tensor maps
  void* out;          // (E, M, N), written when part is null
  float* part;        // (splits [x2 for SwiGLU], E, M, N) partial sums
  // GROUPED only (the sorted ragged-group layout; A is (M, K) rows)
  const int* tile_expert;   // (M / 8,) expert of each 8-row tile
  const void* x;            // the layout's input rows: a slab whose rows
  int x_row_bytes;          //   are all zero there reads no weight
  int ntiles;
  int wait_for_a;           // A is the previous launch's output (h)
};

template <int EPI>
__device__ __forceinline__ float epilogue(float g, float u) {
  if (EPI == EPI_GELU) return gelu_tanh_f(g);
  if (EPI == EPI_SWIGLU) return silu_f(g) * u;
  return g;
}

__device__ __forceinline__ uint32_t tf32_hi(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r & 0xffffe000u;
}

// hi = TF32(v), lo = TF32(v - hi)
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_hi(v);
  lo = tf32_hi(v - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t bits(float v) { return __float_as_uint(v); }

// Byte offset of element k of row r in a tile of 128-byte rows with the
// 128-byte swizzle (16-byte chunk c of row r stored at chunk c ^ (r % 8)),
// as TMA writes it
template <typename T>
__device__ __forceinline__ int sw128(int r, int k) {
  const int byte = k * (int)sizeof(T);
  return r * 128 + (((byte >> 4) ^ (r & 7)) << 4) + (byte & 15);
}

// The element-wise staging of a shape no tensor map describes: A (rows of
// K) into the swizzled layout, B (BK x BN) dense; zeros past the edges.
template <typename T>
__device__ void stage_a_elementwise(unsigned char* dst, const T* src,
                                    size_t ld, int rows, int cols, int r_lim,
                                    int c_lim) {
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    const int r = i / cols, c = i % cols;
    *reinterpret_cast<T*>(dst + sw128<T>(r, c)) =
        (r < r_lim && c < c_lim) ? src[r * ld + c] : from_f32<T>(0.f);
  }
}
template <typename T>
__device__ void stage_b_elementwise(T* dst, const T* src, size_t ld,
                                    int rows, int cols, int r_lim,
                                    int c_lim) {
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    const int r = i / cols, c = i % cols;
    dst[i] = (r < r_lim && c < c_lim) ? src[r * ld + c] : from_f32<T>(0.f);
  }
}

// Rewrite the raw (BK, BN) B tiles of one stage K-major into op, split
// into TF32 hi and lo (3XTF32), widened to float32 (2XTF32) or kept
// bfloat16 (BF16). Row n is 128 bytes with the 128-byte swizzle (eight
// threads writing one chunk of eight rows hit distinct banks, and so do
// the tensor cores reading). An item is one 16-byte chunk: (matrix, chunk
// c, row n); a thread takes its items four at a time, loads first.
template <int MODE, int EPI>
__device__ __forceinline__ void convert_b(const unsigned char* raw_stage,
                                          unsigned char* op) {
  using C = Tile<MODE, EPI>;
  using TB = typename C::TB;
  constexpr int ITEMS = C::NB * C::BN * 8, PER = 16 / C::OPE, GROUP = 4;
  for (int j0 = 0; j0 * blockDim.x < ITEMS; j0 += GROUP) {
    float v[GROUP][PER];
#pragma unroll
    for (int jj = 0; jj < GROUP; ++jj) {
      const int i = threadIdx.x + (j0 + jj) * blockDim.x;
      const int mat = i / (C::BN * 8), n = i % C::BN, c = (i / C::BN) % 8;
      const TB* raw = reinterpret_cast<const TB*>(raw_stage + mat * C::B_RAW);
#pragma unroll
      for (int j = 0; j < PER; ++j)
        v[jj][j] = i < ITEMS ? to_f32(raw[(PER * c + j) * C::BN + n]) : 0.f;
    }
#pragma unroll
    for (int jj = 0; jj < GROUP; ++jj) {
      const int i = threadIdx.x + (j0 + jj) * blockDim.x;
      if (i >= ITEMS) continue;
      const int mat = i / (C::BN * 8), n = i % C::BN, c = (i / C::BN) % 8;
      unsigned char* dst = op + mat * C::PARTS * C::OP_BYTES + n * 128 +
                           ((c ^ (n % 8)) * 16);
      uint4 hi;
      if (MODE == M_BF16) {   // bf16 -> float32 -> bf16 is exact
        uint32_t w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          w[j] = __bfloat16_as_ushort(__float2bfloat16(v[jj][2 * j])) |
                 ((uint32_t)__bfloat16_as_ushort(
                      __float2bfloat16(v[jj][2 * j + 1])) << 16);
        hi = make_uint4(w[0], w[1], w[2], w[3]);
      } else if (MODE == M_3XTF32) {
        uint4 lo;
        split_tf32(v[jj][0], hi.x, lo.x);
        split_tf32(v[jj][1], hi.y, lo.y);
        split_tf32(v[jj][2], hi.z, lo.z);
        split_tf32(v[jj][3], hi.w, lo.w);
        *reinterpret_cast<uint4*>(dst + C::OP_BYTES) = lo;
      } else {   // bfloat16 widened: exact in TF32
        hi = make_uint4(bits(v[jj][0]), bits(v[jj][1]), bits(v[jj][2]),
                        bits(v[jj][3]));
      }
      *reinterpret_cast<uint4*>(dst) = hi;
    }
  }
}

// The products of k step s (32 bytes of K) of one stage into d, which the
// first step overwrites: a_lo b_hi + a_hi b_lo + a_hi b_hi (3XTF32),
// a_lo b + a_hi b (2XTF32) or a b (BF16). bm is the stage's K-major B (hi,
// then lo).
template <int MODE, int EPI>
__device__ __forceinline__ void issue_step(
    float (&d)[Tile<MODE, EPI>::BN / 2], const uint32_t (&ahi)[4],
    const uint32_t (&alo)[4], const unsigned char* bm, int s) {
  using C = Tile<MODE, EPI>;
  const uint64_t dhi = kmajor_sw128_desc(bm + s * 32);
  if (MODE == M_BF16) {
    wgmma_bf16<C::BN>(d, ahi, dhi, s > 0);
  } else {
    wgmma_tf32<C::BN>(d, alo, dhi, s > 0);
    if (MODE == M_3XTF32)
      wgmma_tf32<C::BN>(d, ahi, kmajor_sw128_desc(bm + C::OP_BYTES + s * 32),
                        1);
    wgmma_tf32<C::BN>(d, ahi, dhi, 1);
  }
}

template <typename TO>
__device__ __forceinline__ void store2(TO* p, float v0, float v1, bool two,
                                       bool vec);
template <>
__device__ __forceinline__ void store2<float>(float* p, float v0, float v1,
                                              bool two, bool vec) {
  if (two && vec) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    p[0] = v0;
    if (two) p[1] = v1;
  }
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p,
                                                      float v0, float v1,
                                                      bool two, bool vec) {
  if (two && vec) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  } else {
    p[0] = __float2bfloat16(v0);
    if (two) p[1] = __float2bfloat16(v1);
  }
}


// The products of one output tile over one K split into acc (and acc2,
// SwiGLU's x Wu), float32: a ring of STAGES TMA stages (A and B, in the
// dynamic shared memory from its first 1024-byte boundary), B
// rewritten K-major into the double-buffered operand tiles while the
// tensor cores run the previous stage. (e, m0, n0) place the tile; for a
// GROUPED tile, A rows at or past mv (the next expert's) are zeroed in the
// fragment, kbase counts the ring stages this block used before (the
// mbarrier phases run on), and with p.wait_for_a the first stages' B are
// in flight before the previous launch (which writes A) is waited for.
template <int MODE, int EPI, bool GROUPED>
__device__ __forceinline__ void ffn_tile(
    const GemmArgs& p, const CUtensorMap& map_a, const CUtensorMap& map_b,
    const CUtensorMap& map_b2, int e, int split, int m0, int n0, int mv,
    int kbase, bool first, float (&acc)[Tile<MODE, EPI>::BN / 2],
    float (&acc2)[Tile<MODE, EPI>::BN / 2]) {
  using C = Tile<MODE, EPI>;
  using TA = typename C::TA;
  using TB = typename C::TB;
  constexpr int BN = C::BN, BK = C::BK, ACC = BN / 2;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];
  unsigned char* smem = smem_raw + ((1024 - reinterpret_cast<uintptr_t>(
                                                smem_raw) % 1024) % 1024);
  const int wg_count = blockDim.x / 128, BM = 64 * wg_count;
  const int k_begin = split * p.slice;
  const int k_end = min(p.K, k_begin + p.slice);
  const int ktiles = cdiv(k_end - k_begin, BK);
  const int a_stage = C::a_bytes(wg_count);

  unsigned char* op = smem;                          // [2][NB][PARTS] tiles
  unsigned char* araw = smem + C::OPS;               // [STAGES] A
  unsigned char* braw = araw + STAGES * a_stage;     // [STAGES][NB] B
  auto op_of = [&](int kt) {
    return op + (kt & 1) * C::NB * C::PARTS * C::OP_BYTES;
  };
  auto a_of = [&](int kt) {
    return araw + ((kbase + kt) % STAGES) * a_stage;
  };
  auto b_of = [&](int kt) {
    return braw + ((kbase + kt) % STAGES) * C::NB * C::B_RAW;
  };
  auto bar_of = [&](int kt) { return &full[(kbase + kt) % STAGES]; };

  // stage kt into its ring slot: TMA from one thread, or element-wise
  const int tx_bytes = a_stage + C::NB * C::B_RAW;
  auto load_b = [&](int kt) {
    const int k0 = k_begin + kt * BK;
    tma_load_3d(b_of(kt), &map_b, bar_of(kt), n0, k0, e);
    if (C::DUAL) tma_load_3d(b_of(kt) + C::B_RAW, &map_b2, bar_of(kt), n0, k0, e);
  };
  auto load_a = [&](int kt) {
    tma_load_3d(a_of(kt), &map_a, bar_of(kt), k_begin + kt * BK, m0,
                GROUPED ? 0 : e);
  };
  auto load = [&](int kt) {
    const int k0 = k_begin + kt * BK;
    if (p.tma) {
      if (threadIdx.x == 0) {
        mbar_expect_tx(bar_of(kt), tx_bytes);
        load_a(kt);
        load_b(kt);
      }
    } else {
      stage_a_elementwise<TA>(a_of(kt),
                              static_cast<const TA*>(p.a) +
                                  ((size_t)e * p.M + m0) * p.K + k0,
                              p.K, BM, BK, p.M - m0, k_end - k0);
      const TB* bs[2] = {static_cast<const TB*>(p.b),
                         static_cast<const TB*>(p.b2)};
#pragma unroll
      for (int mat = 0; mat < C::NB; ++mat)
        stage_b_elementwise<TB>(
            reinterpret_cast<TB*>(b_of(kt) + mat * C::B_RAW),
            bs[mat] + ((size_t)e * p.K + k0) * p.N + n0, p.N, BK, BN,
            k_end - k0, p.N - n0);
    }
  };
  // wait until stage kt has landed (the element-wise path is followed by
  // the barrier that ends every stage)
  auto landed = [&](int kt) {
    if (p.tma) mbar_wait(bar_of(kt), ((kbase + kt) / STAGES) & 1);
  };

  const int wgi = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  const int a_row = 64 * wgi + 16 * warp + g;     // this thread's A rows

  // A fragment of k step s of stage kt: TF32 hi / lo (or a bf16 pair),
  // read from the swizzled rows a_row and a_row + 8
  auto fragment = [&](int kt, int s, uint32_t(&ahi)[4], uint32_t(&alo)[4]) {
    const unsigned char* ar = a_of(kt);
    const int k = C::OPE == 4 ? 8 * s + q : 16 * s + 2 * q;
    const int kk = C::OPE == 4 ? k + 4 : k + 8;
    auto word = [&](int r, int kc) {
      return *reinterpret_cast<const uint32_t*>(ar + sw128<TA>(r, kc));
    };
    uint32_t w0 = word(a_row, k), w1 = word(a_row + 8, k);
    uint32_t w2 = word(a_row, kk), w3 = word(a_row + 8, kk);
    if (GROUPED) {   // the next expert's rows
      if (a_row >= mv) w0 = w2 = 0u;
      if (a_row + 8 >= mv) w1 = w3 = 0u;
    }
    if (MODE == M_BF16) {
      ahi[0] = w0;
      ahi[1] = w1;
      ahi[2] = w2;
      ahi[3] = w3;
    } else {
      split_tf32(__uint_as_float(w0), ahi[0], alo[0]);
      split_tf32(__uint_as_float(w1), ahi[1], alo[1]);
      split_tf32(__uint_as_float(w2), ahi[2], alo[2]);
      split_tf32(__uint_as_float(w3), ahi[3], alo[3]);
    }
  };

  float t[ACC], t2[ACC];   // t2: SwiGLU's x Wu
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = acc2[i] = t[i] = t2[i] = 0.f;

  // Prologue: stages 0 .. STAGES-2 in flight; stage 0's operands and
  // fragments ready.
  if (first && threadIdx.x == 0)
    for (int i = 0; i < STAGES; ++i) mbar_init(&full[i]);
  __syncthreads();
  if (GROUPED && p.wait_for_a && first) {
    // the weights of the first stages need nothing from the previous
    // launch: they are in flight before its output (A) is waited for
    if (threadIdx.x == 0)
      for (int i = 0; i < STAGES - 1 && i < ktiles; ++i) {
        mbar_expect_tx(bar_of(i), tx_bytes);
        load_b(i);
      }
    griddep_wait();
    if (threadIdx.x == 0)
      for (int i = 0; i < STAGES - 1 && i < ktiles; ++i) load_a(i);
  } else {
    for (int i = 0; i < STAGES - 1 && i < ktiles; ++i) load(i);
  }
  __syncthreads();
  landed(0);
  uint32_t a0hi[C::KSTEPS][4], a0lo[C::KSTEPS][4];
  uint32_t a1hi[C::KSTEPS][4], a1lo[C::KSTEPS][4];
  convert_b<MODE, EPI>(b_of(0), op_of(0));
#pragma unroll
  for (int s = 0; s < C::KSTEPS; ++s) fragment(0, s, a0hi[s], a0lo[s]);
  fence_proxy_async();
  __syncthreads();

  // Stage kt: its products run on the tensor cores while the block stages
  // kt+1 (B into the other operand buffer, A into the other set of
  // fragment registers, a0 / a1: the loop is unrolled by two) and one
  // thread refills the ring; then the tile sum is added.
  auto stage = [&](int kt, uint32_t(&ahi)[C::KSTEPS][4],
                   uint32_t(&alo)[C::KSTEPS][4],
                   uint32_t(&nhi)[C::KSTEPS][4],
                   uint32_t(&nlo)[C::KSTEPS][4]) {
    const unsigned char* opk = op_of(kt);
    wgmma_fence_operands(t);
    if (C::DUAL) wgmma_fence_operands(t2);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < C::KSTEPS; ++s) {
      issue_step<MODE, EPI>(t, ahi[s], alo[s], opk, s);
      if (C::DUAL)
        issue_step<MODE, EPI>(t2, ahi[s], alo[s],
                              opk + C::PARTS * C::OP_BYTES, s);
    }
    wgmma_commit();
    // the ring slot of stage kt-1 was last read during stage kt-2
    if (kt + STAGES - 1 < ktiles) load(kt + STAGES - 1);
    if (kt + 1 < ktiles) {
      landed(kt + 1);
      convert_b<MODE, EPI>(b_of(kt + 1), op_of(kt + 1));
      fence_proxy_async();
#pragma unroll
      for (int s = 0; s < C::KSTEPS; ++s) fragment(kt + 1, s, nhi[s], nlo[s]);
    }
    wgmma_wait_all();
    wgmma_fence_operands(t);
    if (C::DUAL) wgmma_fence_operands(t2);
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      acc[i] += t[i];
      if (C::DUAL) acc2[i] += t2[i];
    }
    __syncthreads();
  };
  for (int kt = 0; kt < ktiles; kt += 2) {
    stage(kt, a0hi, a0lo, a1hi, a1lo);
    if (kt + 1 < ktiles) stage(kt + 1, a1hi, a1lo, a0hi, a0lo);
  }
}

// out[e] (M, N) = epi(a[e] (M, K) b[e] (K, N) [, a[e] b2[e]]) over one
// output tile and one K split: blockIdx = (N tile, M tile, split * E + e),
// 128 threads per warpgroup, 64 rows per warpgroup. The maps describe a
// (E, M, K), b and b2 (E, K, N) when p.tma is set.
template <int MODE, int EPI, typename TO>
__global__ void __launch_bounds__(256, 1)
ffn_wgmma_kernel(const GemmArgs p, const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b,
                 const __grid_constant__ CUtensorMap map_b2) {
  using C = Tile<MODE, EPI>;
  constexpr int BN = C::BN, ACC = BN / 2;
  const int BM = 64 * (blockDim.x / 128);
  const int e = blockIdx.z % p.E, split = blockIdx.z / p.E;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[ACC], acc2[ACC];   // acc2: SwiGLU's x Wu
  ffn_tile<MODE, EPI, false>(p, map_a, map_b, map_b2, e, split, m0, n0, BM,
                             0, true, acc, acc2);

  // epilogue: activation (or cast) and store, or float32 partials
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int a_row = 64 * (threadIdx.x / 128) + 16 * warp + g;
  const bool vec = (p.N % 2) == 0;
  const size_t MN = (size_t)p.M * p.N;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * q;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = m0 + a_row + 8 * hf;
      if (row >= p.M || col >= p.N) continue;
      const bool two = col + 1 < p.N;
      const float g0 = acc[4 * j + 2 * hf], g1 = acc[4 * j + 2 * hf + 1];
      const float u0 = C::DUAL ? acc2[4 * j + 2 * hf] : 0.f;
      const float u1 = C::DUAL ? acc2[4 * j + 2 * hf + 1] : 0.f;
      const size_t at = (size_t)row * p.N + col;
      if (p.part != nullptr) {
        const size_t splits = gridDim.z / p.E;
        float* pg = p.part + (size_t)blockIdx.z * MN + at;
        store2<float>(pg, g0, g1, two, vec);
        if (C::DUAL) store2<float>(pg + splits * p.E * MN, u0, u1, two, vec);
      } else {
        store2<TO>(static_cast<TO*>(p.out) + e * MN + at,
                   epilogue<EPI>(g0, u0), epilogue<EPI>(g1, u1), two, vec);
      }
    }
  }
}

// ------------------------------------------------ the grouped layout (B2)

// Where slab j of the layout lies: expert e, first row tile t0, nt (1..8)
// row tiles. Each run of equal (clamped) tile_expert is cut into slabs of
// up to 8 tiles from the run's first tile. Warp 0 scans the labels staged
// in shared memory 32 tiles at a time: a ballot marks run starts, each
// tile's run start is the highest one at or below it, and a second ballot
// ranks the slab starts. `total` gets the number of slabs.
struct Slab {
  int e, t0, nt, found, total;
};

__device__ void find_slab(const int* te_s, int ntiles, int j, Slab* out) {
  const int lane = threadIdx.x % 32;
  int carry_start = 0, carry_rank = 0;
  for (int base = 0; base < ntiles; base += 32) {
    const int t = base + lane;
    const bool valid = t < ntiles;
    const int v = valid ? te_s[t] : -1;
    const bool is_start = valid && (t == 0 || te_s[t - 1] != v);
    const unsigned starts = __ballot_sync(~0u, is_start);
    const unsigned upto = starts & ((2u << lane) - 1u);   // lanes <= lane
    const int st = upto ? base + 31 - __clz(upto) : carry_start;
    const bool slab_start = valid && (t - st) % 8 == 0;
    const unsigned slabs = __ballot_sync(~0u, slab_start);
    const int rank = carry_rank + __popc(slabs & ((1u << lane) - 1u));
    if (slab_start && rank == j) {
      int nt = 1;
      while (nt < 8 && t + nt < ntiles && te_s[t + nt] == v) ++nt;
      out->e = v;
      out->t0 = t;
      out->nt = nt;
      out->found = 1;
    }
    carry_rank += __popc(slabs);
    carry_start = __shfl_sync(~0u, st, 31);
  }
  if (lane == 0) out->total = carry_rank;
}

// Whether any of n 16-byte chunks from p is nonzero (the whole block
// calls it; 8 chunks a thread in flight, and it stops at the first round
// that finds one).
__device__ bool any_nonzero(const void* p, size_t n) {
  const uint4* q = static_cast<const uint4*>(p);
  for (size_t base = 0; base < n; base += 8 * (size_t)blockDim.x) {
    int nz = 0;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const size_t i = base + (size_t)u * blockDim.x + threadIdx.x;
      if (i < n) {
        const uint4 v = __ldg(q + i);
        nz |= (v.x | v.y | v.z | v.w) != 0u;
      }
    }
    if (__syncthreads_or(nz)) return true;
  }
  return false;
}

template <typename TO>
__device__ __forceinline__ void store4(TO* p, float4 v);
template <>
__device__ __forceinline__ void store4<float>(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* p,
                                                      float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                 *reinterpret_cast<const uint32_t*>(&hi));
}

// One product of the grouped FFN's long-group path: p.out (M, N) rows of
// each slab = epi(slab rows of a (M, K) times b[e] (K, N) [, b2[e]]).
// blockIdx = (split, slab, N tile); one warpgroup; the splits of a tile
// are one cluster. The grid has a row of blocks for each slab the layout
// can have when each expert's tiles form one run; a layout with more
// slabs than that is walked by the same blocks, gridDim.y slabs apart.
// A slab whose rows of p.x are all zero reads no weight: the up product
// skips it (its h rows stay unwritten) and the down product (p.wait_for_a)
// writes its output rows as zeros (FFN(0) = 0) without reading h.
template <int MODE, int EPI, typename TO>
__global__ void __launch_bounds__(128, 1)
grouped_wgmma_kernel(const GemmArgs p,
                     const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b,
                     const __grid_constant__ CUtensorMap map_b2) {
  namespace cg = cooperative_groups;
  using C = Tile<MODE, EPI>;
  constexpr int BN = C::BN, ACC = BN / 2;
  constexpr int LD = BN + 8;   // floats per staged row (fewer conflicts)
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ Slab slab;
  unsigned char* smem = smem_raw + ((1024 - reinterpret_cast<uintptr_t>(
                                                smem_raw) % 1024) % 1024);
  if (!p.wait_for_a) griddep_launch_dependents();
  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x, n0 = blockIdx.z * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int a_row = 16 * warp + lane / 4, q = lane % 4;
  bool first = true;
  int kbase = 0;
  for (int j = blockIdx.y;; j += gridDim.y) {
    // find the slab (the labels are staged where the ring will be)
    int* te_s = reinterpret_cast<int*>(smem);
    for (int t = threadIdx.x; t < p.ntiles; t += blockDim.x)
      te_s[t] = min(max(p.tile_expert[t], 0), p.E - 1);
    if (threadIdx.x == 0) slab.found = 0;
    __syncthreads();
    if (warp == 0) find_slab(te_s, p.ntiles, j, &slab);
    __syncthreads();
    const Slab sl = slab;
    __syncthreads();
    if (!sl.found) break;   // alike for every block of the cluster
    const int e = sl.e, m0 = 8 * sl.t0, mv = 8 * sl.nt;
    if (!any_nonzero(static_cast<const unsigned char*>(p.x) +
                         (size_t)m0 * p.x_row_bytes,
                     (size_t)mv * (p.x_row_bytes / 16))) {
      if (p.wait_for_a && split == 0)
        for (int i = threadIdx.x; i < mv * BN; i += blockDim.x) {
          const int c = n0 + i % BN;
          if (c < p.N)
            static_cast<TO*>(p.out)[(size_t)(m0 + i / BN) * p.N + c] =
                from_f32<TO>(0.f);
        }
      if (j + gridDim.y >= sl.total) break;
      continue;
    }
    float acc[ACC], acc2[ACC];
    ffn_tile<MODE, EPI, true>(p, map_a, map_b, map_b2, e, split, m0, n0, mv,
                              kbase, first, acc, acc2);
    kbase += cdiv(min(p.K, (split + 1) * p.slice) - split * p.slice, C::BK);
    first = false;

    // The splits of this tile are one cluster: each block stages its sums
    // in its shared memory (the operand tiles and the ring are idle now),
    // then every block merges a share of the tile, adding all blocks'
    // sums in rank order (the same order for every element, so repeated
    // calls give the same bits), and stores the slab's rows.
    float* ep = reinterpret_cast<float*>(smem);   // [NB][64][LD]
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int at = (a_row + 8 * hf) * LD + 8 * jj + 2 * q;
        *reinterpret_cast<float2*>(ep + at) =
            make_float2(acc[4 * jj + 2 * hf], acc[4 * jj + 2 * hf + 1]);
        if (C::DUAL)
          *reinterpret_cast<float2*>(ep + 64 * LD + at) =
              make_float2(acc2[4 * jj + 2 * hf], acc2[4 * jj + 2 * hf + 1]);
      }
    cluster.sync();
    const int cs = cluster.num_blocks(), rank = cluster.block_rank();
    constexpr int Q = BN / 4;   // 4-column groups of a row
    for (int i = rank * blockDim.x + threadIdx.x; i < 64 * Q;
         i += cs * blockDim.x) {
      const int row = i / Q, col = 4 * (i % Q);
      if (row >= mv || n0 + col >= p.N) continue;   // p.N % 4 == 0
      // all blocks' sums in flight, then added in rank order
      float4 v[GROUPED_MAX_CLUSTER], w[GROUPED_MAX_CLUSTER];
#pragma unroll
      for (int r = 0; r < GROUPED_MAX_CLUSTER; ++r)
        if (r < cs) {
          const float* src = cluster.map_shared_rank(ep, r) + row * LD + col;
          v[r] = *reinterpret_cast<const float4*>(src);
          if (C::DUAL) w[r] = *reinterpret_cast<const float4*>(src + 64 * LD);
        }
      float4 gs = make_float4(0.f, 0.f, 0.f, 0.f), us = gs;
#pragma unroll
      for (int r = 0; r < GROUPED_MAX_CLUSTER; ++r)
        if (r < cs) {
          add4(gs, v[r]);
          if (C::DUAL) add4(us, w[r]);
        }
      store4<TO>(static_cast<TO*>(p.out) + (size_t)(m0 + row) * p.N + n0 +
                     col,
                 make_float4(epilogue<EPI>(gs.x, us.x),
                             epilogue<EPI>(gs.y, us.y),
                             epilogue<EPI>(gs.z, us.z),
                             epilogue<EPI>(gs.w, us.w)));
    }
    cluster.sync();   // no block reuses or leaves its sums while read
    if (j + gridDim.y >= sl.total) break;
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// A 3-D map over (d2, d1, d0) contiguous elements of `es` bytes, boxes of
// (1, b1, b0); zeros outside.
static int encode_3d(CUtensorMap* map, const void* base, size_t es,
                     uint64_t d0, uint64_t d1, uint64_t d2, uint32_t b0,
                     uint32_t b1, CUtensorMapSwizzle swizzle) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* libcuda = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (libcuda == nullptr) libcuda = dlopen("libcuda.so.1", RTLD_NOW);
    void* fn = libcuda ? dlsym(libcuda, "cuTensorMapEncodeTiled") : nullptr;
    if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * es, d0 * d1 * es};
  const cuuint32_t box[3] = {b0, b1, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, es == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                   : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      3, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}
