// Grouped expert matmul: out[e] = x[e] @ w[e], f32 accumulation.
//
// Replaces the TPU kernel repro/kernels/moe_gmm.py:gmm (_gmm_kernel), the
// MoE FFN hot loop: x (E, C, K) capacity-padded expert buckets, w (E, K, N)
// expert weights, out (E, C, N) in x's type (f32 or bf16).
//
// What bounds it on an H100: on the serve path's decode step C = 2, so each
// weight element is used by two rows only; the kernel must stream E*K*N
// weights (90.2 MB in bf16 per projection at K=4096, N=1376) and is bound
// by device-memory bandwidth (~27 us at 3.35 TB/s).  At prefill C = 40,
// still far below the ~295 FLOP/B where bf16 tensor cores would become the
// limit, so the plan is the same: read every weight once, keep many bytes
// in flight.  Plain FMA on CUDA cores, f32 accumulators, no TF32.
//
// Two paths, chosen by shape (ragged C/K/N edges are masked in the kernel;
// no padded copies):
//
//   * skinny (C <= 4, N a multiple of the 16-byte vector, w 16-byte
//     aligned): the decode step.  Each lane streams one 16-byte vector of a
//     weight row per step (8 bf16 or 4 f32 columns), so a warp reads 512
//     contiguous bytes per load; the block's 8 warps split its K range, and
//     K is also split over blocks (grid.y) so that ~4 blocks per SM keep
//     loads in flight.  x's rows for the K range sit in shared memory.  The
//     warps are summed in shared memory, the K splits by a second small
//     kernel in a fixed order, so the result does not depend on timing.
//   * tiled (everything else, e.g. prefill's C = 40): grid
//     (ceil(N/64), ceil(C/64), E), each block a 64 x 64 output tile walking
//     K in steps of 32; x and w tiles staged through registers into shared
//     memory as f32, the next step's loads issued before the current FMAs.
//
// wgmma/TMA tensor-core tiles for the prefill shapes are later work.
#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// ------------------------------------------------------------------ tiled

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

// ----------------------------------------------------------------- skinny

constexpr int kSkinnyMaxRows = 4;
constexpr int kMaxKSlice = 512;        // K rows one block covers, at most
constexpr int kTargetBlocks = 4 * 132; // ~4 blocks on each of 132 SMs

template <typename T> struct Vec16;    // 16 bytes of T, unpacked to f32
template <> struct Vec16<float> {
  using type = float4;
  static constexpr int n = 4;
  static __device__ __forceinline__ void unpack(const float4& v, float* f) {
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
};
template <> struct Vec16<__nv_bfloat16> {
  using type = uint4;
  static constexpr int n = 8;
  static __device__ __forceinline__ void unpack(const uint4& v, float* f) {
    // bf16 -> f32 is exact: the bf16 bits are the f32's upper half; the
    // lower-addressed element sits in the low 16 bits.
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(u[i] << 16);
      f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
};

// Partial sums of out[e, :C, n0:n0+BN] over one K slice, into
// ws[split][e][r][n] (f32).
template <typename T, int CM>
__global__ void __launch_bounds__(kThreads)
gmm_skinny_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  float* __restrict__ ws, int C, int K, int N, int k_slice) {
  using V = Vec16<T>;
  constexpr int BN = 32 * V::n;
  __shared__ float xs[CM][kMaxKSlice];
  __shared__ float red[kWarps][CM][BN];  // [warp][row][col_in_lane*32 + lane]

  const int e = blockIdx.z;
  const int split = blockIdx.y;
  const int n0 = blockIdx.x * BN;
  const int kb = split * k_slice;
  const int len = min(k_slice, K - kb);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int r = 0; r < CM; ++r)
    for (int c = tid; c < len; c += kThreads)
      xs[r][c] = r < C ? to_f32(x[((int64_t)e * C + r) * K + kb + c]) : 0.f;
  __syncthreads();

  float acc[CM][V::n];
#pragma unroll
  for (int r = 0; r < CM; ++r)
#pragma unroll
    for (int j = 0; j < V::n; ++j) acc[r][j] = 0.f;

  const int col = n0 + lane * V::n;
  if (col < N) {                          // N is a multiple of V::n
    const int64_t row_vecs = N / V::n;
    const typename V::type* wp = reinterpret_cast<const typename V::type*>(
        w + ((int64_t)e * K + kb) * N + col);
#pragma unroll 4
    for (int k = warp; k < len; k += kWarps) {
      float f[V::n];
      V::unpack(wp[k * row_vecs], f);
#pragma unroll
      for (int r = 0; r < CM; ++r) {
        const float a = xs[r][k];
#pragma unroll
        for (int j = 0; j < V::n; ++j) acc[r][j] = fmaf(a, f[j], acc[r][j]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < CM; ++r)
#pragma unroll
    for (int j = 0; j < V::n; ++j) red[warp][r][j * 32 + lane] = acc[r][j];
  __syncthreads();

  for (int idx = tid; idx < CM * BN; idx += kThreads) {
    const int r = idx / BN, c = idx % BN;           // c = lane_c * V::n + j
    const int slot = (c % V::n) * 32 + c / V::n;
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) s += red[wi][r][slot];
    if (r < C && n0 + c < N)
      ws[(((int64_t)split * gridDim.z + e) * C + r) * N + n0 + c] = s;
  }
}

// out[i] = sum over splits of ws[split][i], in split order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gmm_splitk_reduce_kernel(const float* __restrict__ ws, T* __restrict__ out,
                         int n_split, int64_t total) {
  for (int64_t i = blockIdx.x * (int64_t)kThreads + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * kThreads) {
    float s = 0.f;
    for (int sp = 0; sp < n_split; ++sp) s += ws[sp * total + i];
    out[i] = from_f32<T>(s);
  }
}

struct SkinnyPlan {
  int n_split = 0;   // 0: use the tiled path
  int k_slice = 0;
};

SkinnyPlan skinny_plan(int E, int C, int K, int N, int vec, const void* w) {
  SkinnyPlan p;
  if (C < 1 || C > kSkinnyMaxRows || K < 1 || N % vec != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return p;
  const int tiles = (N + 32 * vec - 1) / (32 * vec);
  int splits = (kTargetBlocks + tiles * E - 1) / (tiles * E);
  splits = std::min(splits, std::max(1, K / kWarps));   // >= a row per warp
  splits = std::max(splits, (K + kMaxKSlice - 1) / kMaxKSlice);
  p.k_slice = (K + splits - 1) / splits;
  p.n_split = (K + p.k_slice - 1) / p.k_slice;
  return p;
}

int vec_of(int dtype) { return dtype == kReproBF16 ? 8 : 4; }

template <typename T, int CM>
void launch_skinny(const void* x, const void* w, void* out, float* ws, int E,
                   int C, int K, int N, const SkinnyPlan& p, cudaStream_t s) {
  constexpr int BN = 32 * Vec16<T>::n;
  dim3 grid((N + BN - 1) / BN, p.n_split, E);
  gmm_skinny_kernel<T, CM><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), ws, C, K, N, p.k_slice);
  const int64_t total = (int64_t)E * C * N;
  const int blocks = (int)std::min<int64_t>((total + kThreads - 1) / kThreads, 4096);
  gmm_splitk_reduce_kernel<T><<<blocks, kThreads, 0, s>>>(
      ws, static_cast<T*>(out), p.n_split, total);
}

template <typename T>
void dispatch(const void* x, const void* w, void* out, float* ws, int E, int C,
              int K, int N, const SkinnyPlan& p, cudaStream_t s) {
  if (p.n_split > 0) {
    if (C == 1)
      launch_skinny<T, 1>(x, w, out, ws, E, C, K, N, p, s);
    else if (C == 2)
      launch_skinny<T, 2>(x, w, out, ws, E, C, K, N, p, s);
    else
      launch_skinny<T, 4>(x, w, out, ws, E, C, K, N, p, s);
    return;
  }
  dim3 grid((N + 63) / 64, (C + 63) / 64, E);
  gmm_tiled_kernel<T, 64, 64, 32, 4, 4><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      C, K, N);
}

}  // namespace

// Plain C interface (loaded with ctypes).
//
// repro_gmm_workspace: f32 elements of scratch repro_gmm needs for these
// arguments (0 for the tiled path); the caller allocates it.
extern "C" long long repro_gmm_workspace(int E, int C, int K, int N, int dtype,
                                         const void* w) {
  const SkinnyPlan p = skinny_plan(E, C, K, N, vec_of(dtype), w);
  return (long long)p.n_split * E * C * N;
}

// Returns cudaGetLastError() after the launches: 0 when they were launched.
extern "C" int repro_gmm(const void* x, const void* w, void* out, void* ws,
                         long long ws_elems, int E, int C, int K, int N,
                         int dtype, void* stream) {
  if (dtype != kReproF32 && dtype != kReproBF16)
    return static_cast<int>(cudaErrorInvalidValue);
  const SkinnyPlan p = skinny_plan(E, C, K, N, vec_of(dtype), w);
  if ((long long)p.n_split * E * C * N > ws_elems)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wsf = static_cast<float*>(ws);
  if (dtype == kReproF32)
    dispatch<float>(x, w, out, wsf, E, C, K, N, p, s);
  else
    dispatch<__nv_bfloat16>(x, w, out, wsf, E, C, K, N, p, s);
  return static_cast<int>(cudaGetLastError());
}
