// The AIMD / PID admission cell of the fleet's admission controller, stepped
// over the control bins only.
//
// Replaces the controller half of adm_scan in repro/traffic/queueing.py
// (_fleet_fixed_point) and of repro/traffic/admission.py
// admission_queue_scan (a lax.scan over every time bin; not a Pallas
// kernel).  In the port the backlog half of that scan is backlog_scan and
// the window maxima of qhat are admission_window.  What is left is the cell:
// for each (f, p, g), over the n_ctrl control bins k in order, with
// w = win[k, f, p] (ttft0 and tpot0 shared by the entries, or per entry,
// ttft0[f, p, g] and tpot0[f, p]: the joint control plane's schedule row),
//
//   AIMD: over  = (ttft0[p, g] + w > tt[f]) | (tpot0[p] + w > tp[f])
//         admit = over ? max(admit * decrease, admit_min)
//                      : min(admit + increase, 1)
//   PID:  h_t   = isfinite(tt) ? (tt - (ttft0 + w)) / tt : +inf  (same for tp)
//         err   = min(h_t, h_p)
//         integ = min(max(integ + err, -W), W)
//         delta = kp * err + ki * integ + kd * (err - prev);  prev = err
//         admit = min(max(admit + gain[p] * delta, admit_min), 1)
//
// and out[k, f, p, g] = admit after the k-th update.  Each operation is
// written as its IEEE intrinsic (__fadd_rn, __fmul_rn, __fdiv_rn, ...) in
// the reference's order, so nothing is contracted into an FMA; min and max
// are PTX min.NaN / max.NaN (one instruction, NaN when either side is, as
// torch.minimum / maximum).  The result is bit for bit the plain PyTorch
// loop (kernels/admission_ctrl.py), NaN payloads aside.
//
// What bounds it on an H100: neither bytes (under a megabyte on the paper's
// world) nor operations, but the chain: each step needs the previous
// admit (and under PID the previous integral), n_ctrl steps in a row.  The
// chain is split, and the result stays exact:
//   1. every map the chain applies is monotone non-decreasing in its state,
//      as rounded in f32: AIMD's admit (decrease > 0), PID's integral, and
//      PID's admit once delta is known, which needs only err (from w),
//      prev (the previous bin's err, from w) and the integral;
//   2. after one step the state lies in a bracket: AIMD
//      [min(admit0, admit_min), max(admit0, 1)] (0 < decrease < 1,
//      increase > 0), PID integ [-W, W] and admit [admit_min, 1];
//   3. so a chunk of control bins run once from each end of its bracket
//      holds the true trajectory between the two runs; from the first bin
//      where they agree bit for bit they are the true trajectory;
//   4. only the bins before that need the chunk's exact start;
//   5. NaN: a NaN state stays NaN (every step keeps it), and a step makes a
//      NaN (a NaN window, or delta's inf - inf when both targets are
//      infinite) whatever the state was, so both runs meet on it.  A chunk
//      whose runs met on a number, but whose true start is NaN, is NaN.
//
// Design: one warp a cell (f, p, g), each lane a chunk of ctrl_chunk(n_ctrl)
// bins (the wrapper's), so the chain is n_ctrl / 32 steps long.
//   * pass 1: each lane runs its chunk from both ends of the bracket (lane 0
//     from the exact start: admit0, integ 0, prev 0), the two runs side by
//     side, and writes out from the bin where they meet.  Under PID the
//     admit runs start only once the integral runs have met (delta needs
//     the exact integral).  The warp copies a group of 32 bins of every
//     chunk into shared memory at once by cp.async, a group ahead (lane u
//     bin u of each chunk, so each copy instruction reads consecutive
//     control bins: one line when the windows are k-contiguous, as
//     admission_window writes them); what depends on the window alone
//     (over, err with its divides) is taken for a whole group before the
//     chain steps through it; the outputs go back the same way, into the
//     k-contiguous (F, P, G, n_ctrl) out;
//   * the walk: the chunks' exact starts, in order, warp-uniform: a chunk
//     whose runs met ends at the lower run's end (NaN if it starts at NaN);
//     one that never met is run by its lane from its exact start while the
//     others wait (its own copies, one lane at a time).  So a stretch of
//     chunks that never meet is serial, as the plain loop is, and only in
//     the cells concerned;
//   * pass 2: each lane runs its chunk from its exact start up to the bin
//     where its runs met (all of it if they never did, or it starts at
//     NaN), writing out.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kLanes = 32;             // chunks of a cell: one warp, one lane each
constexpr int kGroup = 32;             // window values of one cp.async group
constexpr int kRing = 2 * kGroup + 1;  // a lane's ring: two groups, +1 against bank conflicts
constexpr float kPidWindup = 10.0f;

struct Args {
  const float* win;     // (n_ctrl, F, P), element (k, f, p) at k * sk + f * sf + p * sp
  const float* ttft0;   // (P, G), element (f, p, g) at f * st0 + p * G + g
  const float* tpot0;   // (P,), element (f, p) at f * sp0 + p
  const float* admit0;  // (F, P, G)
  const float* tt;      // (F,) margin-scaled TTFT targets
  const float* tp;      // (F,) margin-scaled TPOT targets
  const float* gain;    // (P,) PID per-plan gain, or null (AIMD)
  float* out;           // (F, P, G, n_ctrl): each cell's control bins contiguous
  int* coal;            // (F * P * G, kLanes) bins to the runs' meeting, -1: never; or null
  int64_t n_ctrl, n_f, n_p, n_g, sk, sf, sp, st0, sp0;
  int chunk;
  float increase, decrease, admit_min, kp, ki, kd;
};

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ bool same(float x, float y) {
  return __float_as_uint(x) == __float_as_uint(y);
}

// One cell's constants and the steps of its law.  What depends on the
// window alone (AIMD's over, PID's err) is `prep`, off the chain.
struct Cell {
  float ttft0, tpot0, tt, tp, gain, inc, dec, amin, kp, ki, kd;
  bool tt_fin, tp_fin;

  __device__ __forceinline__ float over(float w) const {
    return __fadd_rn(ttft0, w) > tt || __fadd_rn(tpot0, w) > tp ? 1.0f : 0.0f;
  }
  __device__ __forceinline__ float aimd(float admit, float over) const {
    return over != 0.0f ? max_nan(__fmul_rn(admit, dec), amin)
                        : min_nan(__fadd_rn(admit, inc), 1.0f);
  }
  __device__ __forceinline__ float err(float w) const {
    const float inf = __int_as_float(0x7f800000);
    const float h_t = tt_fin ? __fdiv_rn(__fsub_rn(tt, __fadd_rn(ttft0, w)), tt) : inf;
    const float h_p = tp_fin ? __fdiv_rn(__fsub_rn(tp, __fadd_rn(tpot0, w)), tp) : inf;
    return min_nan(h_t, h_p);
  }
  __device__ __forceinline__ float integ(float i, float e) const {
    return min_nan(max_nan(__fadd_rn(i, e), -kPidWindup), kPidWindup);
  }
  __device__ __forceinline__ float pid(float admit, float e, float i, float prev) const {
    const float delta = __fadd_rn(__fadd_rn(__fmul_rn(kp, e), __fmul_rn(ki, i)),
                                  __fmul_rn(kd, __fsub_rn(e, prev)));
    return min_nan(max_nan(__fadd_rn(admit, __fmul_rn(gain, delta)), amin), 1.0f);
  }
  template <bool kPid>
  __device__ __forceinline__ float prep(float w) const {
    return kPid ? err(w) : over(w);
  }
};

// Calls body(i, prep(w)) for i = 0 .. n-1 in order with w = src[i * stride],
// this lane's own values, staged through `ring` (this lane's kRing floats)
// by cp.async one group ahead.  prep runs over a whole group first (its
// values do not depend on each other), so only body's chain is serial.
// No lane waits on another.
template <bool kPid, typename Body>
__device__ __forceinline__ void stream(const Cell& c, const float* src, int64_t stride,
                                       int n, float* ring, Body&& body) {
  const int groups = (n + kGroup - 1) / kGroup;
  auto issue = [&](int g) {
    if (g < groups) {
      float* dst = ring + (g & 1) * kGroup;
      const int i0 = g * kGroup;
      const int m = min(kGroup, n - i0);
      const float* s = src + (int64_t)i0 * stride;
      for (int u = 0; u < m; ++u, s += stride) cp_async4_zfill(dst + u, s, true);
    }
    cp_async_commit();
  };
  issue(0);
  for (int g = 0; g < groups; ++g) {
    issue(g + 1);
    cp_async_wait<1>();
    float* cur = ring + (g & 1) * kGroup;
    const int i0 = g * kGroup;
    const int m = min(kGroup, n - i0);
#pragma unroll 8
    for (int u = 0; u < m; ++u) cur[u] = c.prep<kPid>(cur[u]);
#pragma unroll 8
    for (int u = 0; u < m; ++u) body(i0 + u, cur[u]);
  }
  cp_async_wait<0>();
}

// The exact cell from (integ, admit) over this lane's chunk; writes out[i]
// for i < stop when `out` is not null.  prev: the err before the chunk.
template <bool kPid>
__device__ __forceinline__ void run_exact(const Cell& c, const float* src, int64_t stride,
                                          int n, float* ring, float prev, float& integ,
                                          float& admit, float* out, int64_t ostride,
                                          int stop) {
  stream<kPid>(c, src, stride, n, ring, [&](int i, float x) {
    if (kPid) {
      integ = c.integ(integ, x);
      admit = c.pid(admit, x, integ, prev);
      prev = x;
    } else {
      admit = c.aimd(admit, x);
    }
    if (out != nullptr && i < stop) out[i * ostride] = admit;
  });
}

template <bool kPid>
__global__ void __launch_bounds__(kLanes)
admission_ctrl_kernel(const Args a) {
  __shared__ float rings[kLanes * kRing];
  const int lane = threadIdx.x;
  const int64_t cell = blockIdx.x;             // (f * P + p) * G + g
  const int64_t fp = cell / a.n_g;
  const int64_t p = fp % a.n_p, f = fp / a.n_p;
  Cell c;
  c.ttft0 = a.ttft0[f * a.st0 + p * a.n_g + cell % a.n_g];
  c.tpot0 = a.tpot0[f * a.sp0 + p];
  c.tt = a.tt[f];
  c.tp = a.tp[f];
  c.tt_fin = isfinite(c.tt);
  c.tp_fin = isfinite(c.tp);
  c.gain = kPid ? a.gain[p] : 0.0f;
  c.inc = a.increase;
  c.dec = a.decrease;
  c.amin = a.admit_min;
  c.kp = a.kp;
  c.ki = a.ki;
  c.kd = a.kd;
  const float admit0 = a.admit0[cell];
  float* ring = rings + lane * kRing;
  const unsigned full = 0xffffffffu;

  const int64_t k0 = (int64_t)lane * a.chunk;
  const int n = (int)max((int64_t)0, min((int64_t)a.chunk, a.n_ctrl - k0));
  const float* win = a.win + f * a.sf + p * a.sp;        // this cell's windows
  const float* src = win + k0 * a.sk;
  float* out = a.out + cell * a.n_ctrl + k0;
  const float prev0 = (kPid && lane > 0 && n > 0) ? c.err(__ldg(src - a.sk)) : 0.0f;

  // Pass 1: lo and hi side by side, every lane in step over groups of
  // kGroup bins.  The group's windows of all 32 chunks are copied by the
  // warp together (lane u takes bin u of each chunk: runs of consecutive
  // control bins), each lane steps its own chunk through them, leaves its
  // lower run in their place, and the warp stores those the same way.
  // Bins before the runs meet get pass 2's values later.
  const bool first = lane == 0;
  float lo, hi, ilo, ihi;
  if (kPid) {
    lo = first ? admit0 : c.amin;
    hi = first ? admit0 : 1.0f;
    ilo = first ? 0.0f : -kPidWindup;
    ihi = first ? 0.0f : kPidWindup;
  } else {
    lo = first ? admit0 : fminf(admit0, c.amin);
    hi = first ? admit0 : fmaxf(admit0, 1.0f);
    ilo = ihi = 0.0f;
  }
  bool imet = !kPid || first;
  int tc = -1;
  {
    const int groups = (a.chunk + kGroup - 1) / kGroup;
    auto slot = [&](int chunk, int g, int u) {
      return rings + chunk * kRing + (g & 1) * kGroup + u;
    };
    const int64_t step = (int64_t)a.chunk * a.sk;     // from a chunk to the next
    auto issue = [&](int g) {
      const int i = g * kGroup + lane;                 // this lane's bin of each chunk
      if (g < groups && i < a.chunk) {
        const float* w = win + i * a.sk;
        const int live = (int)min((int64_t)kLanes, (a.n_ctrl - i + a.chunk - 1) / a.chunk);
        float* dst = slot(0, g, lane);
        for (int j = 0; j < live; ++j, w += step, dst += kRing) cp_async4_zfill(dst, w, true);
      }
      cp_async_commit();
    };
    float prev = prev0;
    issue(0);
    for (int g = 0; g < groups; ++g) {
      issue(g + 1);
      cp_async_wait<1>();
      __syncwarp();                       // every lane's copies have landed
      float* cur = slot(lane, g, 0);
      const int i0 = g * kGroup;
      const int m = max(0, min(kGroup, n - i0));
#pragma unroll 8
      for (int u = 0; u < m; ++u) cur[u] = c.prep<kPid>(cur[u]);
#pragma unroll 8
      for (int u = 0; u < m; ++u) {
        // Both runs step every bin: once they meet they stay equal.
        const float x = cur[u];
        if (kPid) {
          ilo = c.integ(ilo, x);
          ihi = c.integ(ihi, x);
          imet = imet || same(ilo, ihi);
          // the admit runs move only once the integral is exact
          const float nlo = c.pid(lo, x, ilo, prev), nhi = c.pid(hi, x, ilo, prev);
          lo = imet ? nlo : lo;
          hi = imet ? nhi : hi;
          prev = x;
        } else {
          lo = c.aimd(lo, x);
          hi = c.aimd(hi, x);
        }
        tc = (tc < 0 && imet && same(lo, hi)) ? i0 + u : tc;
        cur[u] = lo;
      }
      __syncwarp();                       // every lane's results are in place
      const int i = i0 + lane;
      if (i < a.chunk) {
        float* o = a.out + cell * a.n_ctrl + i;
        const float* v = slot(0, g, lane);
        const int live = (int)min((int64_t)kLanes, (a.n_ctrl - i + a.chunk - 1) / a.chunk);
        for (int j = 0; j < live; ++j, o += a.chunk, v += kRing) *o = *v;
      }
      __syncwarp();                       // read before the next copies land
    }
    cp_async_wait<0>();
  }
  if (a.coal != nullptr) a.coal[cell * kLanes + lane] = tc;

  // The walk: each chunk's exact start (s_i, s_a), warp-uniform.
  float s_i = 0.0f, s_a = admit0, my_i = 0.0f, my_a = admit0;
  for (int j = 0; j < kLanes; ++j) {
    if ((int64_t)j * a.chunk >= a.n_ctrl) break;       // the rest are empty
    if (lane == j) {
      my_i = s_i;
      my_a = s_a;
    }
    if (__shfl_sync(full, tc, j) >= 0) {
      const float ci = __shfl_sync(full, ilo, j), ca = __shfl_sync(full, lo, j);
      const bool dead = s_a != s_a;
      s_i = dead ? s_a : ci;
      s_a = dead ? s_a : ca;
    } else {
      float ei = s_i, ea = s_a;
      if (lane == j)
        run_exact<kPid>(c, src, a.sk, n, ring, prev0, ei, ea, nullptr, 0, 0);
      s_i = __shfl_sync(full, ei, j);
      s_a = __shfl_sync(full, ea, j);
    }
  }

  // Pass 2: from the exact start up to where the runs met.
  __syncwarp();
  const int stop = (tc >= 0 && my_a == my_a) ? tc : n;
  if (stop > 0)
    run_exact<kPid>(c, src, a.sk, stop, ring, prev0, my_i, my_a, out, 1, stop);
}

}  // namespace

// out (F, P, G, n_ctrl) f32 (contiguous) from win (n_ctrl, F, P), element
// (k, f, p) at k * sk + f * sf + p * sp, and the cell's parameters (f32,
// contiguous; the anchors ttft0 (P, G) and tpot0 (P,) with entry strides
// st0 and sp0: 0 when the entries share them, P * G and P when each entry
// has its own), in chunks of `chunk` control bins,
// chunk * 32 >= n_ctrl.  gain: (P,) for PID, null for AIMD.  coal: null, or
// F * P * G * 32 ints that receive each (cell, chunk)'s bins to the runs'
// meeting (-1: they never met).  Takes 0 < decrease < 1, increase > 0 and
// 0 < admit_min <= 1 (AdmissionConfig's ranges; the wrapper checks).
// Returns the launch's error: 0 when the kernel was launched.
extern "C" int repro_admission_ctrl(const void* win, const void* ttft0,
                                    const void* tpot0, const void* admit0,
                                    const void* tt, const void* tp,
                                    const void* gain, void* out, void* coal,
                                    int64_t n_ctrl, int64_t n_f, int64_t n_p,
                                    int64_t n_g, int64_t sk, int64_t sf,
                                    int64_t sp, int64_t st0, int64_t sp0,
                                    int chunk, float increase,
                                    float decrease, float admit_min, float kp,
                                    float ki, float kd, void* stream) {
  const int64_t n_cells = n_f * n_p * n_g;
  if (n_ctrl <= 0 || n_cells <= 0 || n_cells >= ((int64_t)1 << 31) || chunk <= 0 ||
      (int64_t)chunk * kLanes < n_ctrl)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(win), static_cast<const float*>(ttft0),
               static_cast<const float*>(tpot0), static_cast<const float*>(admit0),
               static_cast<const float*>(tt), static_cast<const float*>(tp),
               static_cast<const float*>(gain), static_cast<float*>(out),
               static_cast<int*>(coal), n_ctrl, n_f, n_p, n_g, sk, sf, sp, st0, sp0,
               chunk,
               increase, decrease, admit_min, kp, ki, kd};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gain != nullptr)
    admission_ctrl_kernel<true><<<(unsigned)n_cells, kLanes, 0, s>>>(a);
  else
    admission_ctrl_kernel<false><<<(unsigned)n_cells, kLanes, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
