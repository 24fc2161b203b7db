// GQA flash-decode: one new query token per sequence over its KV cache.
//
// Replaces the TPU kernel repro/kernels/decode_attn.py:decode_attention
// (_decode_attn_kernel): q (B, Hkv, G, hd) attends over k/v (B, Hkv, S, hd)
// with kv index <= pos[b] visible; f32 math, output in q's type.
//
// What bounds it on an H100: every visible K and V row is read once and
// used for G dot products only, about 2*G FLOP per byte, so the kernel is
// bound by device-memory bandwidth: the card needs tens of KB requested on
// every SM to reach it.  At the serve path's short caches (S = 49) it is
// bound by latency instead.
//
// Design:
//   * S is split over blocks: grid (n_split, Hkv * head blocks, B).  A
//     block reads the rows [split * chunk, (split + 1) * chunk) that pos[b]
//     leaves visible; decode_attn.decode_splits picks n_split and chunk
//     from the shapes alone (the host never reads pos) so that the grid
//     fills the SMs several times over.  A block wholly past pos[b] reads
//     no row and writes an empty partial (m = -1e30, l = 0);
//   * tiles of kTR rows of K and of V (16 KB a stage) are copied with
//     16-byte cp.async, neighbouring threads on neighbouring addresses,
//     into a ring of kStages stages, so that a block keeps two tiles
//     (32 KB) requested, about 100 KB an SM.  Rows are addressed through
//     (b, h, s) strides with a contiguous last axis, so the model's
//     (B, S, Hkv, hd) cache is read in place as a transposed view; every
//     row must start 16-byte aligned (hd and the strides times the element
//     size multiples of 16 bytes), which the wrapper checks;
//   * per tile, every (row, query head) score first, then one max and one
//     rescale of the online softmax per head, then P.V; all f32;
//   * query heads: G = 1 takes one head a block (GP = 1), otherwise four
//     (GP = 4), one head block per four heads;
//   * the splits are combined in the same launch.  Each writes (m, l,
//     acc) in f32 to a workspace, fences, and bumps a per-(b, h, head
//     block) counter; the block that bumps it last merges the splits in
//     split order (so the result is bitwise repeatable) and resets the
//     counter to 0.  With one split, the block writes the output itself;
//   * launched as a programmatic dependent: block set-up overlaps the
//     previous kernel; every access to device memory comes after
//     griddepcontrol.wait.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;
constexpr int kStageBytes = 16384;    // a K tile and a V tile
constexpr float kNegInf = -1e30f;

// Thread layout of a (dtype, head-dim bucket HD, heads per block GP).
template <typename T, int HD, int GP>
struct Cfg {
  static constexpr int kE = 16 / sizeof(T);            // elements per 16 B
  static constexpr int kCH = HD / kE;                  // 16 B chunks per row
  static constexpr int kTR = kStageBytes / (2 * 16 * kCH);   // rows per tile
  static constexpr int kTPR = kThreads / kTR;          // scores: threads a row
  static constexpr int kCPT = kCH / kTPR;              // scores: chunks a thread
  static constexpr int kNRG = kThreads / kCH;          // P.V: row groups
  static constexpr int kRPT = kTR / kNRG;              // P.V: rows a thread
  static constexpr int kTileElems = kTR * HD;          // one K (or V) tile
  static constexpr int kRingBytes = kStages * 2 * kTileElems * (int)sizeof(T);
  static constexpr int kRedBytes = kNRG * GP * HD * 4;
  static constexpr int kBig = kRingBytes > kRedBytes ? kRingBytes : kRedBytes;
  static constexpr int kSmem = kBig + (GP * HD + GP * kTR + 3 * GP) * 4;
  static_assert(kTPR * kTR == kThreads && kCPT * kTPR == kCH, "score layout");
  static_assert(kNRG * kCH == kThreads && kRPT * kNRG == kTR, "P.V layout");
  static_assert(kTPR <= 32 && GP <= kWarps, "warp layout");
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* pos;
  void* out;
  float* ws;             // (units, n_split, 2 * GP + GP * hd) partials
  unsigned* counters;    // (units,) zero between launches
  int64_t k_sb, k_sh, k_ss;   // element strides of k over (b, h, s)
  int64_t v_sb, v_sh, v_ss;
  int Hkv, G, S, hd, n_gb, n_split, chunk;
  float scale;
};

// 16 bytes of T at p (shared memory) as f32.
__device__ __forceinline__ void load16(const float* p, float* f) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* f) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 two = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = two.x;
    f[2 * i + 1] = two.y;
  }
}

template <typename T, int HD, int GP>
__global__ void __launch_bounds__(kThreads, 2)
decode_attn_kernel(const Args a) {
  using C = Cfg<T, HD, GP>;
  constexpr int kE = C::kE, kTR = C::kTR;
  extern __shared__ __align__(16) uint8_t smem[];
  T* ring = reinterpret_cast<T*>(smem);             // [kStages][K, V][kTR][HD]
  float* red = reinterpret_cast<float*>(smem);       // after the loop: [kNRG][GP][HD]
  float* q_s = reinterpret_cast<float*>(smem + C::kBig);   // [GP][HD]
  float* p_s = q_s + GP * HD;                        // [GP][kTR] scores, then p
  float* m_s = p_s + GP * kTR;
  float* l_s = m_s + GP;
  float* c_s = l_s + GP;                             // the tile's rescale
  __shared__ bool merge;

  const int split = blockIdx.x;
  const int h = blockIdx.y / a.n_gb, gb = blockIdx.y % a.n_gb;
  const int b = blockIdx.z;
  const int g0 = gb * GP, gn = min(GP, a.G - g0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nch = a.hd / kE;                         // 16-byte chunks of a row
  const int64_t unit = (int64_t)blockIdx.z * gridDim.y + blockIdx.y;
  const int W = 2 * GP + GP * a.hd;                  // floats of one partial

  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  const int last = min(__ldg(a.pos + b), a.S - 1);   // rows past pos: never read
  const int r0 = split * a.chunk;
  const int r1 = min(r0 + a.chunk, last + 1);
  const int n_tiles = r1 > r0 ? (r1 - r0 + kTR - 1) / kTR : 0;
  T* outb = static_cast<T*>(a.out) + ((int64_t)(b * a.Hkv + h) * a.G + g0) * a.hd;
  float* part = a.ws + (unit * a.n_split + split) * W;

  if (n_tiles == 0 && a.n_split == 1) {             // pos < 0: nothing visible
    for (int i = tid; i < gn * a.hd; i += kThreads) outb[i] = from_f32<T>(0.f);
    return;
  }
  if (n_tiles == 0) {                                // an empty partial
    if (tid < GP) {
      part[tid] = kNegInf;
      part[GP + tid] = 0.f;
    }
  } else {
    const T* qb = static_cast<const T*>(a.q) + ((int64_t)(b * a.Hkv + h) * a.G + g0) * a.hd;
    for (int i = tid; i < GP * HD; i += kThreads) {
      const int g = i / HD, d = i % HD;
      q_s[i] = (g < gn && d < a.hd) ? to_f32(qb[g * a.hd + d]) : 0.f;
    }
    if (tid < GP) {
      m_s[tid] = kNegInf;
      l_s[tid] = 0.f;
    }
    const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
    const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;

    auto load_tile = [&](int i) {
      if (i < n_tiles) {
        T* st = ring + (i % kStages) * 2 * C::kTileElems;
        const int row0 = r0 + i * kTR;
        const int rows = min(kTR, r1 - row0);
#pragma unroll
        for (int j = 0; j < 2 * kTR * C::kCH / kThreads; ++j) {
          const int idx = tid + j * kThreads;
          const int kv = idx / (kTR * C::kCH);
          const int r = (idx / C::kCH) % kTR, c = idx % C::kCH;
          if (r < rows && c < nch) {
            const T* src = kv ? vb + (row0 + r) * a.v_ss : kb + (row0 + r) * a.k_ss;
            cp_async16(st + (kv * kTR + r) * HD + c * kE, src + c * kE);
          }
        }
      }
      cp_async_commit();
    };

    float acc[GP][kE];
#pragma unroll
    for (int g = 0; g < GP; ++g)
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[g][e] = 0.f;
    const int sr = tid / C::kTPR, sp = tid % C::kTPR;  // scores: row, part
    const int pc = tid % C::kCH, rg = tid / C::kCH;    // P.V: chunk, row group

    __syncthreads();                                   // q_s, m_s, l_s
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) load_tile(i);
    for (int i = 0; i < n_tiles; ++i) {
      load_tile(i + kStages - 1);
      cp_async_wait<kStages - 1>();
      __syncthreads();                                 // tile i has landed
      const T* kt = ring + (i % kStages) * 2 * C::kTileElems;
      const T* vt = kt + C::kTileElems;
      const int rows = min(kTR, r1 - (r0 + i * kTR));

      // 1. Scores of every (row, head) of the tile.
      float sc[GP];
#pragma unroll
      for (int g = 0; g < GP; ++g) sc[g] = 0.f;
      if (sr < rows) {
#pragma unroll
        for (int j = 0; j < C::kCPT; ++j) {
          const int c = sp + j * C::kTPR;
          if (c < nch) {
            float kf[kE];
            load16(kt + sr * HD + c * kE, kf);
#pragma unroll
            for (int g = 0; g < GP; ++g)
#pragma unroll
              for (int e = 0; e < kE; e += 4) {
                float qf[4];
                load16(q_s + g * HD + c * kE + e, qf);
#pragma unroll
                for (int u = 0; u < 4; ++u) sc[g] = fmaf(qf[u], kf[e + u], sc[g]);
              }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < GP; ++g) {
#pragma unroll
        for (int off = C::kTPR / 2; off > 0; off >>= 1)
          sc[g] += __shfl_xor_sync(0xffffffffu, sc[g], off);
        if (sp == 0 && sr < rows) p_s[g * kTR + sr] = sc[g] * a.scale;
      }
      __syncthreads();

      // 2. One max and one rescale per head for the whole tile.
      for (int g = warp; g < GP; g += kWarps) {
        float mx = kNegInf;
        for (int r = lane; r < rows; r += 32) mx = fmaxf(mx, p_s[g * kTR + r]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_old = m_s[g];
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.f;
        for (int r = lane; r < rows; r += 32) {
          const float p = expf(p_s[g * kTR + r] - m_new);
          p_s[g * kTR + r] = p;
          sum += p;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (lane == 0) {
          const float corr = expf(m_old - m_new);
          l_s[g] = l_s[g] * corr + sum;
          m_s[g] = m_new;
          c_s[g] = corr;
        }
      }
      __syncthreads();

      // 3. acc = acc * corr + P.V over this thread's rows and chunk.
      if (pc < nch) {
#pragma unroll
        for (int g = 0; g < GP; ++g) {
          const float corr = c_s[g];
#pragma unroll
          for (int e = 0; e < kE; ++e) acc[g][e] *= corr;
        }
#pragma unroll
        for (int j = 0; j < C::kRPT; ++j) {
          const int r = rg + j * C::kNRG;
          if (r < rows) {
            float vf[kE];
            load16(vt + r * HD + pc * kE, vf);
#pragma unroll
            for (int g = 0; g < GP; ++g) {
              const float p = p_s[g * kTR + r];
#pragma unroll
              for (int e = 0; e < kE; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
            }
          }
        }
      }
      __syncthreads();                                 // stage i is free again
    }
    cp_async_wait<0>();

    // Sum the row groups (the ring is free now), in row-group order.
    if (pc < nch) {
#pragma unroll
      for (int g = 0; g < GP; ++g)
#pragma unroll
        for (int e = 0; e < kE; ++e) red[(rg * GP + g) * HD + pc * kE + e] = acc[g][e];
    }
    __syncthreads();
    for (int i = tid; i < gn * a.hd; i += kThreads) {
      const int g = i / a.hd, d = i % a.hd;
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < C::kNRG; ++j) s += red[(j * GP + g) * HD + d];
      if (a.n_split == 1)
        outb[g * a.hd + d] = from_f32<T>(s / fmaxf(l_s[g], 1e-30f));
      else
        part[2 * GP + g * a.hd + d] = s;
    }
    if (a.n_split == 1) return;
    if (tid < GP) {
      part[tid] = m_s[tid];
      part[GP + tid] = l_s[tid];
    }
  }

  // The block that finishes last for this unit merges the splits.
  __threadfence();
  __syncthreads();
  if (tid == 0)
    merge = atomicAdd(a.counters + unit, 1u) == (unsigned)(a.n_split - 1);
  __syncthreads();
  if (!merge) return;
  __threadfence();
  const float* parts = a.ws + unit * a.n_split * W;
  for (int i = tid; i < gn * a.hd; i += kThreads) {
    const int g = i / a.hd, d = i % a.hd;
    float m = kNegInf;
    for (int s = 0; s < a.n_split; ++s) m = fmaxf(m, __ldcg(parts + s * W + g));
    float l = 0.f, o = 0.f;
    for (int s = 0; s < a.n_split; ++s) {
      const float ls = __ldcg(parts + s * W + GP + g);
      if (ls > 0.f) {                                  // empty partials hold no acc
        const float w = expf(__ldcg(parts + s * W + g) - m);
        l = fmaf(ls, w, l);
        o = fmaf(__ldcg(parts + s * W + 2 * GP + g * a.hd + d), w, o);
      }
    }
    outb[g * a.hd + d] = from_f32<T>(o / fmaxf(l, 1e-30f));
  }
  if (tid == 0) a.counters[unit] = 0u;
}

template <typename T, int HD, int GP>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  using C = Cfg<T, HD, GP>;
  auto kernel = decode_attn_kernel<T, HD, GP>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.n_split, a.Hkv * a.n_gb, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = C::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, int GP>
cudaError_t by_hd(const Args& a, int B, cudaStream_t s) {
  if (a.hd <= 64) return launch<T, 64, GP>(a, B, s);
  if (a.hd <= 128) return launch<T, 128, GP>(a, B, s);
  if (a.hd <= 256) return launch<T, 256, GP>(a, B, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t by_gp(const Args& a, int B, int gp, cudaStream_t s) {
  if (gp == 1) return by_hd<T, 1>(a, B, s);
  if (gp == 4) return by_hd<T, 4>(a, B, s);
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// Plain C interface (loaded with ctypes).  q and out are contiguous
// (B, Hkv, G, hd); k and v are addressed through their (b, h, s) element
// strides with a contiguous last axis, every row 16-byte aligned (else
// cudaErrorInvalidValue); pos is (B,) int32 on the device.  gp (1 or 4) query heads a block, n_gb = ceil(G / gp) head blocks;
// n_split splits of chunk rows each.  With n_split > 1, ws holds
// B * Hkv * n_gb * n_split * (2 * gp + gp * hd) floats (no initial value)
// and counters B * Hkv * n_gb unsigned zeros, which the launch leaves zero.
// Returns the launch's error: 0 when the kernel was launched.
extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, const void* pos, void* out,
    void* ws, void* counters, int B, int Hkv, int G, int S, int hd, int gp,
    int n_split, int chunk, int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss, int dtype, void* stream) {
  if (B <= 0 || Hkv <= 0 || G <= 0 || hd <= 0 || S <= 0 || n_split <= 0 ||
      chunk <= 0 || (int64_t)n_split * chunk < S ||
      (n_split > 1 && (ws == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t es = dtype == kReproBF16 ? 2 : 4;
  const bool aligned = aligned16(k) && aligned16(v) && (hd * es) % 16 == 0 &&
                       (k_sb * es) % 16 == 0 && (k_sh * es) % 16 == 0 &&
                       (k_ss * es) % 16 == 0 && (v_sb * es) % 16 == 0 &&
                       (v_sh * es) % 16 == 0 && (v_ss * es) % 16 == 0;
  if (!aligned) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, static_cast<const int*>(pos), out,
               static_cast<float*>(ws), static_cast<unsigned*>(counters),
               k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
               Hkv, G, S, hd, (G + gp - 1) / gp, n_split, chunk,
               static_cast<float>(1.0 / sqrt(static_cast<double>(hd)))};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kReproF32)
    err = by_gp<float>(a, B, gp, s);
  else if (dtype == kReproBF16)
    err = by_gp<__nv_bfloat16>(a, B, gp, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
