// Grouped expert matmul: out[e] = x[e] @ w[e], f32 accumulation.
//
// Replaces the TPU kernel repro/kernels/moe_gmm.py:gmm (_gmm_kernel), the
// MoE FFN hot loop: x (E, C, K) capacity-padded expert buckets, w (E, K, N)
// expert weights, out (E, C, N) in x's type (f32 or bf16).
//
// What bounds it on an H100 (llama-moe-3.5b: E = 8, K/N = 4096/1376 and
// 1376/4096; 989 TFLOP/s bf16 tensor cores, 67 TFLOP/s f32 FMA, 3.35 TB/s):
//
//   * decode, C = 2: 90.2 MB of bf16 weights per projection for 0.18
//     GFLOP, bytes-bound at 27 us.  The kernel must keep enough weight
//     bytes in flight on every SM.
//   * calibration and prefill at batch 4 x 32 tokens, C = 40: 3.61 GFLOP
//     and 93 MB.  On CUDA cores that is 54 us even at the full f32 FMA
//     rate, twice the 28 us byte bound; only the tensor cores keep up
//     with the memory (3.6 us of bf16 tensor time).
//   * a real prefill, batch 4 x 2048 tokens, C = 2560: 231 GFLOP, bound by
//     operations at 0.233 ms in bf16.
//
// So bf16 runs on wgmma, fed by TMA, one kernel for every C ("wgmma"
// path).  The product is swapped so that C is wgmma's narrow dimension:
// out[e]^T (N x C) = w[e]^T (N x K) . x[e]^T (K x C).  A block owns 128
// columns n of out (two consumer warpgroups, 64 rows of w^T each) and a
// tile of BN rows c (BN = C rounded up to 8 when C <= 64, else 128, 192 or
// 256, several tiles when C > 256).  A is the w tile, M-major as w lies
// (K, N) row-major; B is the x tile, K-major as x lies.  One producer
// thread streams both through a ring of shared-memory stages with TMA
// (128-byte swizzle: a 64-column w row and a 64-deep x row are 128 bytes
// each; out-of-bounds rows and columns arrive as zeros, so ragged C, K
// and N need no masked loads) and mbarriers; the consumers run wgmma on
// each stage as it lands and hand it back.  The epilogue goes through
// shared memory so that stores of out rows coalesce.
//
// The caller (moe_gmm.gmm_depth) sets, per call, how many stages of the
// ring are in flight.  Narrow buckets are bytes-bound and stream best with
// about 6 MB requested across the card: deeper rings measured slower.  Two
// warpgroups a block (each block reads 256 contiguous bytes of every w row
// it streams) measured faster than one or four at the narrow serve shapes.
// Each block sums all of K itself, in order, so the result is the same
// from run to run and there is no second launch.  The kernel is launched
// as a programmatic dependent, so its prologue (barrier set-up,
// descriptor prefetch) overlaps the previous kernel's tail.
//
// f32 (TF32 is off by the port's rule) and bf16 shapes that TMA cannot
// take (K or N not a multiple of 8, i.e. rows not a multiple of 16 bytes,
// or a base address not 16-byte aligned) run the "fma" path: CUDA-core
// FMA tiles of 64 x 64 outputs walking K in steps of 32.  The caller
// (moe_gmm.gmm_path) picks the path from shapes and alignment before the
// launch.
#include <cuda.h>   // CUtensorMap and cuTensorMapEncodeTiled's types only
#include <dlfcn.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"
#include "wgmma_bf16.cuh"

namespace {

// -------------------------------------------------------------------- fma

constexpr int kThreads = 256;

template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__(kThreads, 2)
gmm_tiled_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 T* __restrict__ out, int C, int K, int N) {
  constexpr int TX = BN / TN;            // threads along N
  constexpr int TY = BM / TM;            // threads along C
  static_assert(TX * TY == kThreads, "thread tile must cover the block tile");
  static_assert((BM * BK) % kThreads == 0 && (BK * BN) % kThreads == 0,
                "tiles must split evenly over the threads");
  constexpr int XL = BM * BK / kThreads;  // x elements staged per thread
  constexpr int WL = BK * BN / kThreads;  // w elements staged per thread

  __shared__ float xs[BM][BK + 1];
  __shared__ float ws[BK][BN];

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const T* xe = x + (int64_t)e * C * K;
  const T* we = w + (int64_t)e * K * N;
  T* oe = out + (int64_t)e * C * N;

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const bool active = m0 + ty * TM < C;  // this thread owns a real row

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  float xr[XL];
  float wr[WL];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < XL; ++i) {
      const int idx = tid + i * kThreads;
      const int r = m0 + idx / BK, c = k0 + idx % BK;
      xr[i] = (r < C && c < K) ? to_f32(xe[(int64_t)r * K + c]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < WL; ++i) {
      const int idx = tid + i * kThreads;
      const int r = k0 + idx / BN, c = n0 + idx % BN;
      wr[i] = (r < K && c < N) ? to_f32(we[(int64_t)r * N + c]) : 0.f;
    }
  };

  const int nk = (K + BK - 1) / BK;
  load(0);
  for (int kt = 0; kt < nk; ++kt) {
#pragma unroll
    for (int i = 0; i < XL; ++i) {
      const int idx = tid + i * kThreads;
      xs[idx / BK][idx % BK] = xr[i];
    }
#pragma unroll
    for (int i = 0; i < WL; ++i) {
      const int idx = tid + i * kThreads;
      ws[idx / BN][idx % BN] = wr[i];
    }
    __syncthreads();
    if (kt + 1 < nk) load((kt + 1) * BK);  // in flight during the FMAs below
    if (active) {
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = xs[ty * TM + i][kk];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx * TN + j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + ty * TM + i;
    if (r >= C) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + tx * TN + j;
      if (c < N) oe[(int64_t)r * N + c] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
cudaError_t launch_fma(const void* x, const void* w, void* out, int E, int C,
                       int K, int N, cudaStream_t s) {
  dim3 grid((N + 63) / 64, (C + 63) / 64, E);
  gmm_tiled_kernel<T, 64, 64, 32, 4, 4><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      C, K, N);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ wgmma

constexpr int kBK = 64;          // K per stage: one 128-byte swizzle row
constexpr int kWBox = 64 * kBK * 2;  // one 64 (n) x 64 (k) bf16 w box, bytes

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 state;\n"
               "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n"
               :: "r"(bar) : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One box of a 3-d tensor map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2) : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle (byte offsets).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
         | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// Keep the compiler from moving accumulator reads across a wgmma wait.
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

constexpr int kWG = 2;   // consumer warpgroups a block, 64 columns n each

// Tile of 64 * kWG columns n by BN rows c.  Narrow tiles run two blocks an
// SM (bytes-bound: many blocks in flight); wide ones one, with all the
// shared memory a block may have for stages.
template <int BN>
struct WgmmaCfg {
  static constexpr int kM = 64 * kWG;                  // columns n per block
  static constexpr int kStage = kWG * kWBox + BN * kBK * 2;  // bytes
  static constexpr int kBlocks = BN <= 64 ? 2 : 1;     // blocks an SM
  // A block may have 227 KB, or half the SM's 228 KB less 1 KB reserved
  // when two share it; less 1 KB of alignment slack and the barriers.
  static constexpr int kStages =
      ((kBlocks == 2 ? 115712 : 232448) - 1024 - 160) / kStage;
  static constexpr int kMS = kM + 4;                   // staging row, floats
  static constexpr int kThreads = 128 * kWG + 32;      // + one producer warp
  static constexpr int kSmem = 1024 + kStages * kStage + 2 * kStages * 8;
  static_assert(kStages >= 2, "the ring needs two stages");
  static_assert(kStage % 1024 == 0, "stages must keep 1024-byte alignment");
  static_assert(BN * kMS * 4 <= kStages * kStage, "staging must fit the ring");
  static_assert(kSmem <= 232448, "more shared memory than a block may have");
};

// grid (ceil(N / kM), E * c_tiles).  Block (y, z) computes the tile
// n in [y * kM, +kM), c in [(z % c_tiles) * BN, +BN) of expert z / c_tiles.
template <int BN>
__global__ void __launch_bounds__(WgmmaCfg<BN>::kThreads, WgmmaCfg<BN>::kBlocks)
gmm_wgmma_kernel(const __grid_constant__ CUtensorMap map_w,
                 const __grid_constant__ CUtensorMap map_x,
                 __nv_bfloat16* __restrict__ out, int C, int K, int N,
                 int c_tiles, int depth) {
  using Cfg = WgmmaCfg<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t ring = smem_u32(smem);
  const uint32_t full0 = ring + Cfg::kStages * Cfg::kStage;  // full[s], empty[s]
  const uint32_t empty0 = full0 + 8 * Cfg::kStages;

  const int n0 = blockIdx.x * Cfg::kM;
  const int e = blockIdx.y / c_tiles;
  const int c0 = (blockIdx.y % c_tiles) * BN;
  const int steps = (K + kBK - 1) / kBK;
  const int tid = threadIdx.x;
  const int wg = tid / 128;

  // Launched as a programmatic dependent: the next kernel in the stream may
  // start its prologue now; it waits for this grid before reading memory.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if (tid == 0) {
    for (int s = 0; s < depth; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("prefetch.tensormap [%0];\n"
                 :: "l"(reinterpret_cast<uint64_t>(&map_w)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n"
                 :: "l"(reinterpret_cast<uint64_t>(&map_x)) : "memory");
  }
  __syncthreads();
  // The prologue above overlapped the previous kernel; every access to
  // device memory comes after this wait.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  if (wg == kWG) {
    // Producer: one thread keeps the ring full.
    if (tid == 128 * kWG) {
      for (int i = 0; i < steps; ++i) {
        const int s = i % depth;
        if (i >= depth) mbar_wait(empty0 + 8 * s, ((i / depth) - 1) & 1);
        const uint32_t bar = full0 + 8 * s, base = ring + s * Cfg::kStage;
        mbar_expect_tx(bar, Cfg::kStage);
        const int k = i * kBK;
#pragma unroll
        for (int g = 0; g < kWG; ++g)
          tma_load_3d(base + g * kWBox, &map_w, bar, n0 + 64 * g, k, e);
        tma_load_3d(base + kWG * kWBox, &map_x, bar, k, c0, e);
      }
    }
  } else {
    // Consumer warpgroup wg: 64 columns n of the tile, all BN rows c.
    float d[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;
    for (int i = 0; i < steps; ++i) {
      const int s = i % depth;
      mbar_wait(full0 + 8 * s, (i / depth) & 1);
      const uint32_t a = ring + s * Cfg::kStage + wg * kWBox;
      const uint32_t b = ring + s * Cfg::kStage + kWG * kWBox;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        // A: 16 k-rows of 128 bytes per step, 8-row groups 1024 B apart.
        // B: 32 bytes (16 k) per step inside each 128-byte c-row.
        Wgmma<BN>::mma(d, smem_desc(a + kk * 2048, kWBox, 1024),
                       smem_desc(b + kk * 32, 16, 1024));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      if (BN <= 64) {
        // Narrow: the products are short, so the stage goes back to the
        // producer at once and every stage can be in flight.
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_operands(d);
        if (tid % 128 == 0) mbar_arrive(empty0 + 8 * s);
      } else {
        // Wide: keep one group of products running behind the next wait.
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        fence_operands(d);
        if (i > 0 && tid % 128 == 0) mbar_arrive(empty0 + 8 * ((i - 1) % depth));
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_operands(d);
    // Every consumer's wgmma has read its last stage: the ring is free
    // for the f32 tile st[c][m] (n = n0 + m).
    asm volatile("bar.sync 1, %0;\n" :: "n"(128 * kWG) : "memory");
    float* st = reinterpret_cast<float*>(smem);
    const int lane = tid % 32;
    const int m = 64 * wg + 16 * ((tid % 128) / 32) + lane / 4;
#pragma unroll
    for (int q = 0; q < BN / 8; ++q)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          st[(8 * q + 2 * (lane % 4) + h) * Cfg::kMS + m + 8 * j] =
              d[4 * q + 2 * j + h];
  }
  __syncthreads();

  // Write the staged tile as bf16, 4 columns a thread, so that the stores
  // of each out row coalesce.
  const float* st = reinterpret_cast<const float*>(smem);
  for (int idx = tid; idx < BN * (Cfg::kM / 4); idx += Cfg::kThreads) {
    const int c = idx / (Cfg::kM / 4);
    const int m = (idx % (Cfg::kM / 4)) * 4;
    if (c0 + c >= C || n0 + m >= N) continue;
    const float4 acc = *reinterpret_cast<const float4*>(st + c * Cfg::kMS + m);
    const __nv_bfloat162 lo = __floats2bfloat162_rn(acc.x, acc.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(acc.z, acc.w);
    uint2 pack;
    pack.x = *reinterpret_cast<const uint32_t*>(&lo);
    pack.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(out + ((int64_t)e * C + c0 + c) * N + n0 + m) = pack;
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, which the process has loaded
// already; looked up once, no link flag needed.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// Tensor map of a contiguous bf16 (d2, d1, d0) array, boxes of b1 x b0
// (b0 * 2 = 128 bytes: the swizzle's row), zero fill out of bounds.
bool make_map(CUtensorMap* map, const void* ptr, uint64_t d0, uint64_t d1,
              uint64_t d2, uint32_t b0, uint32_t b1) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 2, d0 * d1 * 2};
  const cuuint32_t box[3] = {b0, b1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN>
cudaError_t launch_wgmma(const void* x, const void* w, void* out, int E, int C,
                         int K, int N, int depth, cudaStream_t s) {
  using Cfg = WgmmaCfg<BN>;
  depth = depth == 0 ? Cfg::kStages : std::min(depth, Cfg::kStages);
  if (depth < 2) return cudaErrorInvalidValue;
  CUtensorMap map_w, map_x;
  if (!make_map(&map_w, w, N, K, E, 64, kBK) ||
      !make_map(&map_x, x, K, C, E, kBK, BN))
    return cudaErrorInvalidValue;
  auto kernel = gmm_wgmma_kernel<BN>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int c_tiles = (C + BN - 1) / BN;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + Cfg::kM - 1) / Cfg::kM, E * c_tiles);
  cfg.blockDim = dim3(Cfg::kThreads);
  cfg.dynamicSmemBytes = Cfg::kSmem;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, map_w, map_x, static_cast<__nv_bfloat16*>(out), C, K, N,
      c_tiles, depth);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Tile by C: the C width rounded up to 8 when C <= 64, else C tiles of
// up to 256.
cudaError_t dispatch_wgmma(const void* x, const void* w, void* out, int E,
                           int C, int K, int N, int depth, cudaStream_t s) {
  switch ((C + 7) / 8) {
#define REPRO_GMM_CASE(BN) \
  case BN / 8: return launch_wgmma<BN>(x, w, out, E, C, K, N, depth, s)
    REPRO_GMM_CASE(8); REPRO_GMM_CASE(16); REPRO_GMM_CASE(24);
    REPRO_GMM_CASE(32); REPRO_GMM_CASE(40); REPRO_GMM_CASE(48);
    REPRO_GMM_CASE(56); REPRO_GMM_CASE(64);
#undef REPRO_GMM_CASE
    default: break;
  }
  if (C <= 128) return launch_wgmma<128>(x, w, out, E, C, K, N, depth, s);
  if (C <= 192) return launch_wgmma<192>(x, w, out, E, C, K, N, depth, s);
  return launch_wgmma<256>(x, w, out, E, C, K, N, depth, s);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// Plain C interface (loaded with ctypes).
//
// path 0: the FMA tiles (f32 or bf16, any shape); path 1: wgmma (bf16, K
// and N multiples of 8, x, w and out 16-byte aligned) with `depth` stages
// of the ring in flight (at least 2, at most the tile's ring; 0: all of
// it).
// Returns the launch's error: 0 when the kernel was launched.
extern "C" int repro_gmm(const void* x, const void* w, void* out, int E, int C,
                         int K, int N, int dtype, int path, int depth,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 0) {
    if (dtype == kReproF32) return launch_fma<float>(x, w, out, E, C, K, N, s);
    if (dtype == kReproBF16)
      return launch_fma<__nv_bfloat16>(x, w, out, E, C, K, N, s);
  } else if (path == 1 && dtype == kReproBF16 && K % 8 == 0 && N % 8 == 0 &&
             aligned16(x) && aligned16(w) && aligned16(out)) {
    return dispatch_wgmma(x, w, out, E, C, K, N, depth, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
