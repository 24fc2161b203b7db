// GQA flash-decode: one new query token per sequence over its KV cache.
//
// Replaces the TPU kernel repro/kernels/decode_attn.py:decode_attention
// (_decode_attn_kernel): q (B, Hkv, G, hd) attends over k/v (B, Hkv, S, hd)
// with kv index <= pos[b] visible; f32 math, output in q's type.
//
// What bounds it on an H100: every visible K and V row is read once and
// used for G dot products only, about 2*G FLOP per byte, so the kernel is
// bound by device-memory bandwidth (and, at the serve path's short caches,
// by latency: 4 x 32 blocks of 49 rows each).
//
// Design (simple first; a split-S combine pass is later work):
//   * one block per (b, h_kv), 8 warps; pos[b] is read from device memory
//     in the kernel and only rows 0..min(pos, S-1) are read at all;
//   * warps take strided keys (warp w: rows w, w+8, ...); each lane holds
//     hd/32 elements of q, k, v (neighbouring lanes on neighbouring
//     addresses) and a warp-shuffle sum gives the score; the next row's K
//     and V are loaded before the current row is processed;
//   * each warp keeps its own online softmax (m, l, acc) in f32 registers,
//     and the warps are merged in shared memory at the end;
//   * query heads are taken four at a time (G > 4 makes more passes);
//   * K/V are addressed through (b, h, s) strides with a contiguous hd
//     axis, so the model's (B, S, Hkv, hd) cache is read in place.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kGroup = 4;        // query heads per pass
constexpr float kNegInf = -1e30f;

struct KV {
  const void* k;
  const void* v;
  int64_t k_sb, k_sh, k_ss;      // element strides of k over (b, h, s)
  int64_t v_sb, v_sh, v_ss;
};

template <typename T, int DPL>   // DPL: hd elements per lane, hd <= 32*DPL
__global__ void __launch_bounds__(kWarps * 32)
decode_attn_kernel(const T* __restrict__ q, KV kv, const int* __restrict__ pos,
                   T* __restrict__ out, int Hkv, int G, int S, int hd,
                   float scale) {
  constexpr int D = 32 * DPL;
  __shared__ float m_s[kWarps][kGroup];
  __shared__ float l_s[kWarps][kGroup];
  __shared__ float acc_s[kWarps][kGroup][D];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const T* kb = static_cast<const T*>(kv.k) + b * kv.k_sb + h * kv.k_sh;
  const T* vb = static_cast<const T*>(kv.v) + b * kv.v_sb + h * kv.v_sh;
  const int64_t head0 = ((int64_t)b * Hkv + h) * G;
  const int last = min(pos[b], S - 1);   // rows past pos are never read

  for (int g0 = 0; g0 < G; g0 += kGroup) {
    const int gn = min(kGroup, G - g0);
    float qr[kGroup][DPL], acc[kGroup][DPL], m[kGroup], l[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      m[g] = kNegInf;
      l[g] = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        acc[g][i] = 0.f;
        qr[g][i] = (g < gn && d < hd) ? to_f32(q[(head0 + g0 + g) * hd + d]) : 0.f;
      }
    }

    float kr[DPL], vr[DPL];
    auto load = [&](int s, float* kd, float* vd) {
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        kd[i] = d < hd ? to_f32(kb[s * kv.k_ss + d]) : 0.f;
        vd[i] = d < hd ? to_f32(vb[s * kv.v_ss + d]) : 0.f;
      }
    };
    if (warp <= last) load(warp, kr, vr);
    for (int s = warp; s <= last; s += kWarps) {
      float kn[DPL] = {}, vn[DPL] = {};
      if (s + kWarps <= last) load(s + kWarps, kn, vn);
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) part = fmaf(qr[g][i], kr[i], part);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        const float sc = part * scale;
        const float mn = fmaxf(m[g], sc);
        const float corr = expf(m[g] - mn);
        const float p = expf(sc - mn);
        l[g] = l[g] * corr + p;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[g][i] = fmaf(p, vr[i], acc[g][i] * corr);
        m[g] = mn;
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        kr[i] = kn[i];
        vr[i] = vn[i];
      }
    }

    // Merge the warps' partial softmax states.
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      if (lane == 0) {
        m_s[warp][g] = m[g];
        l_s[warp][g] = l[g];
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc_s[warp][g][lane + 32 * i] = acc[g][i];
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < gn * hd; idx += blockDim.x) {
      const int g = idx / hd, d = idx % hd;
      float mx = kNegInf;
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi) mx = fmaxf(mx, m_s[wi][g]);
      float lsum = 0.f, a = 0.f;
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi) {
        const float c = expf(m_s[wi][g] - mx);
        lsum = fmaf(l_s[wi][g], c, lsum);
        a = fmaf(acc_s[wi][g][d], c, a);
      }
      out[(head0 + g0 + g) * hd + d] = from_f32<T>(a / fmaxf(lsum, 1e-30f));
    }
    __syncthreads();
  }
}

template <typename T, int DPL>
void launch(const void* q, const KV& kv, const int* pos, void* out, int B,
            int Hkv, int G, int S, int hd, cudaStream_t stream) {
  dim3 grid(Hkv, B);
  decode_attn_kernel<T, DPL><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), kv, pos, static_cast<T*>(out), Hkv, G, S, hd,
      static_cast<float>(1.0 / sqrt(static_cast<double>(hd))));
}

template <typename T>
bool dispatch(const void* q, const KV& kv, const int* pos, void* out, int B,
              int Hkv, int G, int S, int hd, cudaStream_t stream) {
  if (hd <= 32)
    launch<T, 1>(q, kv, pos, out, B, Hkv, G, S, hd, stream);
  else if (hd <= 64)
    launch<T, 2>(q, kv, pos, out, B, Hkv, G, S, hd, stream);
  else if (hd <= 128)
    launch<T, 4>(q, kv, pos, out, B, Hkv, G, S, hd, stream);
  else if (hd <= 256)
    launch<T, 8>(q, kv, pos, out, B, Hkv, G, S, hd, stream);
  else
    return false;
  return true;
}

}  // namespace

// Plain C interface (loaded with ctypes).  q and out are contiguous
// (B, Hkv, G, hd); k and v are addressed through their (b, h, s) element
// strides with a contiguous last axis; pos is (B,) int32 on the device.
// Returns cudaGetLastError() after the launch: 0 when it was launched.
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const void* pos, void* out, int B, int Hkv,
                                      int G, int S, int hd, int64_t k_sb,
                                      int64_t k_sh, int64_t k_ss, int64_t v_sb,
                                      int64_t v_sh, int64_t v_ss, int dtype,
                                      void* stream) {
  const KV kv{k, v, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss};
  const int* p = static_cast<const int*>(pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok;
  if (dtype == kReproF32)
    ok = dispatch<float>(q, kv, p, out, B, Hkv, G, S, hd, s);
  else if (dtype == kReproBF16)
    ok = dispatch<__nv_bfloat16>(q, kv, p, out, B, Hkv, G, S, hd, s);
  else
    ok = false;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
