// Expert FFN on dense capacity buffers, on Hopper's tensor cores.
//
// Replaces: src/repro/kernels/expert_ffn/kernel.py, expert_ffn_kernel
//           (body _ffn_kernel).
//
// Per expert e over its (C, D) capacity buffer (built by the dense
// executor, repro_torch.models.moe.dispatch_tokens; empty slots are zero):
//     swiglu: out = (silu(x Wg[e]) * (x Wu[e])) Wd[e]
//     gelu:   out = gelu_tanh(x Wg[e]) Wd[e]
// Inputs (float32 or bfloat16) are taken as they are, h stays in float32,
// sums are float32, and the output is cast to the buffer's type once.
// There are no biases, so a zero slot gives an exact zero row.
//
// What bounds it on H100: at the runtime's capture shape (gpt2-moe, E 4,
// C 320, D 768, F 3072, float32) it moves 83.4 MB and does 12.1 GFLOP:
// 0.0249 ms at 3.35 TB/s against 0.0244 ms at the 495 TFLOP/s at which
// the tensor cores multiply float32 operands (as TF32), so it is bound by
// bytes, barely. On the CUDA cores (67 TFLOP/s) it would be bound by
// operations at 0.18 ms.
//
// Arithmetic. A single TF32 product (10-bit mantissa) misses the float32
// tolerance (3e-5) at D 768 / F 3072, so float32 runs as 3xTF32: each
// operand is split into a TF32 high part (cvt.rna) and a TF32 residual,
// and a_lo b_hi + a_hi b_lo + a_hi b_hi is summed in float32 (lo lo is
// below float32's rounding). bfloat16: the up product is one bf16 product
// (bf16 x bf16 is exact in float32, as in the Pallas kernel); the down
// product takes h in float32, so it is h_hi Wd + h_lo Wd with Wd exact in
// TF32. The tensor cores' float32 sums lose low bits over a long
// reduction (enough to miss the tolerance at D 2048), so each stage's
// products go into a fresh tile sum that is added to the running sum in
// ordinary float32.
//
// Instruction. Every product is wgmma.mma_async (hopper.cuh) with A from
// registers and B from shared memory. wgmma takes float32 (TF32) operands
// only K-major, and Wg, Wu (E, D, F) and Wd (E, F, D) are N-major, so B
// is rewritten K-major (128-byte swizzled) in shared memory; that pass is
// also where it is split into hi and lo. A (x or h rows, K-major already)
// is split in registers on the way from shared memory to the A fragment.
// bf16 B goes through the same K-major pass (the transpose bit would
// spare it, but one layout keeps one descriptor).
//
// Data movement. Each block computes a (64 * wg) x BN tile of one expert
// (wg = 2 warpgroups when C > 64, else 1; BN 128, 64 for SwiGLU's two
// products), 128 bytes of operand deep per stage (32 float32 or 64 bf16
// values of K). One thread keeps a ring of 4 stages in flight with TMA
// (tensor maps encoded on the host; the hardware zero-fills past the
// edges, so ragged C, D and F need no padding copy and no masks); A lands
// 128-byte swizzled, so the fragment reads hit distinct banks. A shape
// whose rows are not whole 16-byte chunks (float32 D or F not a multiple
// of 4, bfloat16 not of 8), which a tensor map cannot describe, is staged
// into the same layout element by element. The K-major operand tiles are
// double buffered: stage k+1 is rewritten while the products of stage k
// run on the tensor cores.
//
// Grid. Two launches on one stream, up (activation fused into the store of
// h, float32, in the wrapper's scratch) then down. Keeping h on chip across
// both, as the TPU kernel does, leaves E C / 64 = 20 row blocks at the
// capture shape; the h round trip (15.7 MB, mostly in L2) costs less than
// that loss. Where a product has too few tiles for the SMs (gpt2-moe's
// down product: 72 tiles at capture, 24 at calibration) it is split along
// K: each split writes float32 partials and a second kernel sums them in
// split order (then applies the activation or the cast), so repeated calls
// give the same bits. The split count minimises waves x depth from the
// card's SM count and the kernel's occupancy.
//
// What still holds it back: the same warps issue the products and stage
// the next K step (the hi / lo rewrite of B and A's fragments), and that
// staging, not the tensor cores, sets the pace of a stage. A third,
// producer warpgroup that stages while two consumer warpgroups multiply
// was slower: at 384 threads ptxas holds every thread to 168 registers
// (setmaxnreg did not lift the consumers' allocation), and the consumers'
// two 64-register sums and fragments then spill.
#include <dlfcn.h>
#include <string.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

#define STAGES 4       // TMA ring
#define MAX_SPLITS 16
#define SPLIT_COST 4   // a split's extra cost, in stages of work

enum Mode { M_3XTF32 = 0, M_2XTF32 = 1, M_BF16 = 2 };
enum Epilogue { EPI_STORE = 0, EPI_GELU = 1, EPI_SWIGLU = 2 };

static __host__ __device__ int cdiv(int a, int b) { return (a + b - 1) / b; }

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
  using TA = typename C::TA;
  using TB = typename C::TB;
  constexpr int BN = C::BN, BK = C::BK, ACC = BN / 2;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];
  unsigned char* smem = smem_raw + ((1024 - reinterpret_cast<uintptr_t>(
                                                smem_raw) % 1024) % 1024);
  const int wg_count = blockDim.x / 128, BM = 64 * wg_count;
  const int e = blockIdx.z % p.E, split = blockIdx.z / p.E;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
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
  auto a_of = [&](int kt) { return araw + (kt % STAGES) * a_stage; };
  auto b_of = [&](int kt) { return braw + (kt % STAGES) * C::NB * C::B_RAW; };

  // stage kt into its ring slot: TMA from one thread, or element-wise
  const int tx_bytes = a_stage + C::NB * C::B_RAW;
  auto load = [&](int kt) {
    const int k0 = k_begin + kt * BK;
    if (p.tma) {
      if (threadIdx.x == 0) {
        uint64_t* bar = &full[kt % STAGES];
        mbar_expect_tx(bar, tx_bytes);
        tma_load_3d(a_of(kt), &map_a, bar, k0, m0, e);
        tma_load_3d(b_of(kt), &map_b, bar, n0, k0, e);
        if (C::DUAL) tma_load_3d(b_of(kt) + C::B_RAW, &map_b2, bar, n0, k0, e);
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
    if (p.tma) mbar_wait(&full[kt % STAGES], (kt / STAGES) & 1);
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
    const uint32_t w0 = word(a_row, k), w1 = word(a_row + 8, k);
    const uint32_t w2 = word(a_row, kk), w3 = word(a_row + 8, kk);
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

  float acc[ACC], acc2[ACC], t[ACC], t2[ACC];   // acc2, t2: SwiGLU's x Wu
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = acc2[i] = t[i] = t2[i] = 0.f;

  // Prologue: stages 0 .. STAGES-2 in flight; stage 0's operands and
  // fragments ready.
  if (threadIdx.x == 0)
    for (int i = 0; i < STAGES; ++i) mbar_init(&full[i]);
  __syncthreads();
  for (int i = 0; i < STAGES - 1 && i < ktiles; ++i) load(i);
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

  // epilogue: activation (or cast) and store, or float32 partials
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

// out[i] = epi(sum of the split partials in split order)
template <int EPI, typename TO>
__global__ void split_reduce_kernel(const float* __restrict__ part,
                                    int splits, size_t n,
                                    TO* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float g = 0.f, u = 0.f;
  for (int k = 0; k < splits; ++k) g += part[k * n + i];
  if (EPI == EPI_SWIGLU)
    for (int k = 0; k < splits; ++k) u += part[(splits + k) * n + i];
  out[i] = from_f32<TO>(epilogue<EPI>(g, u));
}

struct Plan {
  int wg, splits, slice, smem;
  size_t part_floats;
};

// Split count minimising waves x stages per block, with SPLIT_COST per
// split for the partials it writes and the reduce reads.
template <int MODE, int EPI, typename TO>
static int plan_for(int E, int M, int K, int N, Plan* plan) {
  using C = Tile<MODE, EPI>;
  auto kern = ffn_wgmma_kernel<MODE, EPI, TO>;
  static int sms = 0, occ[3] = {0, 0, 0};
  cudaError_t err;
  if (sms == 0) {
    int dev = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(
             kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
             C::smem(2))) != cudaSuccess) {
      sms = 0;
      return static_cast<int>(err);
    }
  }
  const int wg = M > 64 ? 2 : 1;
  if (occ[wg] == 0 &&
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &occ[wg], kern, 128 * wg, C::smem(wg))) != cudaSuccess)
    return static_cast<int>(err);
  if (occ[wg] < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long slots = (long)sms * occ[wg];
  const long tiles = (long)cdiv(N, C::BN) * cdiv(M, 64 * wg) * E;
  const int kt = cdiv(K, C::BK);
  int best = 1;
  long best_cost = -1;
  for (int s = 1; s <= MAX_SPLITS && s <= kt && s * E <= 65535; ++s) {
    const int per = cdiv(kt, s);
    if (cdiv(kt, per) != s) continue;     // fewer splits do the same
    const long cost = (tiles * s + slots - 1) / slots * (per + 2) +
                      (s > 1 ? SPLIT_COST * s : 0);
    if (best_cost < 0 || cost < best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  plan->wg = wg;
  plan->splits = best;
  plan->slice = cdiv(kt, best) * C::BK;
  plan->smem = C::smem(wg);
  plan->part_floats =
      best > 1 ? (size_t)C::NB * best * E * M * N : 0;
  return 0;
}

// cuTensorMapEncodeTiled, looked up in the already loaded libcuda (so the
// build needs no -lcuda)
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

template <int MODE, int EPI, typename TO>
static int gemm(const void* a, const void* b, const void* b2, int E, int M,
                int K, int N, void* out, float* part, cudaStream_t s) {
  using C = Tile<MODE, EPI>;
  Plan pl;
  int err = plan_for<MODE, EPI, TO>(E, M, K, N, &pl);
  if (err != 0) return err;
  auto al = [](const void* q) {
    return q == nullptr || reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  GemmArgs args;
  args.a = a;
  args.b = b;
  args.b2 = b2;
  args.E = E;
  args.M = M;
  args.K = K;
  args.N = N;
  args.slice = pl.slice;
  args.tma = al(a) && al(b) && al(b2) &&
             (K * sizeof(typename C::TA)) % 16 == 0 &&
             (N * sizeof(typename C::TB)) % 16 == 0;
  args.out = out;
  args.part = pl.splits > 1 ? part : nullptr;
  CUtensorMap map_a, map_b, map_b2;
  memset(&map_a, 0, sizeof(map_a));
  memset(&map_b, 0, sizeof(map_b));
  memset(&map_b2, 0, sizeof(map_b2));
  if (args.tma) {
    const size_t ea = sizeof(typename C::TA), eb = sizeof(typename C::TB);
    err = encode_3d(&map_a, a, ea, K, M, E, C::BK, 64 * pl.wg,
                    CU_TENSOR_MAP_SWIZZLE_128B);
    if (err == 0)
      err = encode_3d(&map_b, b, eb, N, K, E, C::BN, C::BK,
                      CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err == 0 && b2 != nullptr)
      err = encode_3d(&map_b2, b2, eb, N, K, E, C::BN, C::BK,
                      CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err != 0) return err;
  }
  const dim3 grid(cdiv(N, C::BN), cdiv(M, 64 * pl.wg), E * pl.splits);
  ffn_wgmma_kernel<MODE, EPI, TO><<<grid, 128 * pl.wg, pl.smem, s>>>(
      args, map_a, map_b, map_b2);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || pl.splits == 1) return static_cast<int>(e);
  const size_t n = (size_t)E * M * N;
  split_reduce_kernel<EPI, TO><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      part, pl.splits, n, static_cast<TO*>(out));
  return static_cast<int>(cudaGetLastError());
}

// the two products: up (float32 h) then down (the buffer's type)
template <typename T>
struct Ffn {
  static constexpr int UP = std::is_same<T, float>::value ? M_3XTF32 : M_BF16;
  static constexpr int DOWN =
      std::is_same<T, float>::value ? M_3XTF32 : M_2XTF32;
};

static size_t h_floats(int E, int C, int F) {
  return ((size_t)E * C * F + 3) / 4 * 4;   // partials start 16-byte aligned
}

template <typename T>
static int scratch_floats(int E, int C, int D, int F, bool swiglu,
                          long long* floats) {
  Plan up, down;
  int err = swiglu
                ? plan_for<Ffn<T>::UP, EPI_SWIGLU, float>(E, C, D, F, &up)
                : plan_for<Ffn<T>::UP, EPI_GELU, float>(E, C, D, F, &up);
  if (err == 0) err = plan_for<Ffn<T>::DOWN, EPI_STORE, T>(E, C, F, D, &down);
  if (err != 0) return err;
  const size_t part =
      up.part_floats > down.part_floats ? up.part_floats : down.part_floats;
  *floats = static_cast<long long>(h_floats(E, C, F) + part);
  return 0;
}

template <typename T>
static int launch(const void* buf, const void* wg, const void* wu,
                  const void* wd, int E, int C, int D, int F, float* scratch,
                  void* out, cudaStream_t s) {
  float* h = scratch;
  float* part = scratch + h_floats(E, C, F);
  const int err =
      wu != nullptr
          ? gemm<Ffn<T>::UP, EPI_SWIGLU, float>(buf, wg, wu, E, C, D, F, h,
                                                part, s)
          : gemm<Ffn<T>::UP, EPI_GELU, float>(buf, wg, nullptr, E, C, D, F,
                                              h, part, s);
  if (err != 0) return err;
  return gemm<Ffn<T>::DOWN, EPI_STORE, T>(h, wd, nullptr, E, C, F, D, out,
                                          part, s);
}

static bool valid_shape(int E, int C, int D, int F) {
  return E >= 1 && C >= 1 && D >= 1 && F >= 1 &&
         E <= 65535 && cdiv(C, 64) <= 65535;
}

extern "C" int expert_ffn_scratch_floats(int dtype, int E, int C, int D,
                                         int F, int swiglu,
                                         long long* floats) {
  if (!valid_shape(E, C, D, F)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == REPRO_F32)
    return scratch_floats<float>(E, C, D, F, swiglu != 0, floats);
  if (dtype == REPRO_BF16)
    return scratch_floats<__nv_bfloat16>(E, C, D, F, swiglu != 0, floats);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int expert_ffn(const void* buf, const void* w_gate,
                          const void* w_up, const void* w_down, int dtype,
                          int E, int C, int D, int F, void* scratch,
                          void* out, void* stream) {
  if (!valid_shape(E, C, D, F)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sf = static_cast<float*>(scratch);
  if (dtype == REPRO_F32)
    return launch<float>(buf, w_gate, w_up, w_down, E, C, D, F, sf, out, s);
  if (dtype == REPRO_BF16)
    return launch<__nv_bfloat16>(buf, w_gate, w_up, w_down, E, C, D, F, sf,
                                 out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

REPRO_EXPORT_ERROR_STRING
