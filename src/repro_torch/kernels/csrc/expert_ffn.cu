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
#include "ffn_wgmma.cuh"

#define MAX_SPLITS 16
#define SPLIT_COST 4   // a split's extra cost, in stages of work

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
  GemmArgs args{};
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
