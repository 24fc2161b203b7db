// The AIMD / PID admission cell of the fleet's admission controller, stepped
// over the control bins only.
//
// Replaces the controller half of adm_scan in repro/traffic/queueing.py
// (_fleet_fixed_point) and of repro/traffic/admission.py
// admission_queue_scan (a lax.scan over every time bin; not a Pallas
// kernel).  In the port the backlog half of that scan is backlog_scan, the
// per-bin critical-path estimate qhat is a batched gather of its output,
// and the window maxima of qhat are one reduction (traffic/admission.py).
// What is left is serial: for each (f, p, g), over the n_ctrl control bins
// k in order, with w = win[k, f, p], the cell
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
// the reference's order, so nothing is contracted into an FMA and the
// result is bit for bit the plain PyTorch loop (kernels/admission_ctrl.py).
// min/max return NaN when either side is NaN, as torch.minimum/maximum do.
//
// What bounds it on an H100: neither bytes (win is n_ctrl * F * P floats
// and out n_ctrl * F * P * G, under a megabyte on the paper's world) nor
// operations, but the chain: each step's admit (and under PID its integral)
// needs the previous one, a few dependent f32 operations a control bin,
// n_ctrl bins in a row.  Design: one thread a cell (f, p, g); win does not
// depend on the chain, so each thread keeps the next kUnroll window values
// in flight (loaded while it steps through the current kUnroll), and only
// the dependent operations are serial.  Stores of out are coalesced over g.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 32;      // window values a thread keeps in flight
constexpr float kPidWindup = 10.0f;

struct Args {
  const float* win;     // (n_ctrl, F, P)
  const float* ttft0;   // (P, G)
  const float* tpot0;   // (P,)
  const float* admit0;  // (F, P, G)
  const float* tt;      // (F,) margin-scaled TTFT targets
  const float* tp;      // (F,) margin-scaled TPOT targets
  const float* gain;    // (P,) PID per-plan gain, or null (AIMD)
  float* out;           // (n_ctrl, F, P, G)
  int64_t n_ctrl, n_f, n_p, n_g;
  float increase, decrease, admit_min, kp, ki, kd;
};

__device__ __forceinline__ bool either_nan(float a, float b) {
  return a != a || b != b;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return either_nan(a, b) ? __int_as_float(0x7fc00000) : (a > b ? a : b);
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return either_nan(a, b) ? __int_as_float(0x7fc00000) : (a < b ? a : b);
}

__global__ void __launch_bounds__(kThreads)
admission_ctrl_kernel(const Args a) {
  const int64_t n_cells = a.n_f * a.n_p * a.n_g;
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_cells) return;
  const int64_t fp = i / a.n_g;                 // f * P + p
  const int64_t p = fp % a.n_p, f = fp / a.n_p;
  const int64_t n_fp = a.n_f * a.n_p;
  const float ttft0 = a.ttft0[p * a.n_g + i % a.n_g];
  const float tpot0 = a.tpot0[p];
  const float tt = a.tt[f], tp = a.tp[f];
  const bool pid = a.gain != nullptr;
  const float gain = pid ? a.gain[p] : 0.0f;
  const float inf = __int_as_float(0x7f800000);
  const bool tt_fin = isfinite(tt), tp_fin = isfinite(tp);
  const float* win = a.win + fp;
  float* out = a.out + i;
  float admit = a.admit0[i], integ = 0.0f, prev = 0.0f;

  float cur[kUnroll];
#pragma unroll
  for (int j = 0; j < kUnroll; ++j)
    cur[j] = j < a.n_ctrl ? __ldg(win + (int64_t)j * n_fp) : 0.0f;
  for (int64_t k0 = 0; k0 < a.n_ctrl; k0 += kUnroll) {
    float nxt[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int64_t k = k0 + kUnroll + j;
      nxt[j] = k < a.n_ctrl ? __ldg(win + k * n_fp) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int64_t k = k0 + j;
      if (k >= a.n_ctrl) break;
      const float w = cur[j];
      if (!pid) {
        const bool over = __fadd_rn(ttft0, w) > tt || __fadd_rn(tpot0, w) > tp;
        admit = over ? max_nan(__fmul_rn(admit, a.decrease), a.admit_min)
                     : min_nan(__fadd_rn(admit, a.increase), 1.0f);
      } else {
        const float h_t =
            tt_fin ? __fdiv_rn(__fsub_rn(tt, __fadd_rn(ttft0, w)), tt) : inf;
        const float h_p =
            tp_fin ? __fdiv_rn(__fsub_rn(tp, __fadd_rn(tpot0, w)), tp) : inf;
        const float err = min_nan(h_t, h_p);
        integ = min_nan(max_nan(__fadd_rn(integ, err), -kPidWindup), kPidWindup);
        const float delta =
            __fadd_rn(__fadd_rn(__fmul_rn(a.kp, err), __fmul_rn(a.ki, integ)),
                      __fmul_rn(a.kd, __fsub_rn(err, prev)));
        prev = err;
        admit = min_nan(max_nan(__fadd_rn(admit, __fmul_rn(gain, delta)),
                                a.admit_min),
                        1.0f);
      }
      out[k * n_cells] = admit;
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) cur[j] = nxt[j];
  }
}

}  // namespace

extern "C" int repro_admission_ctrl(const void* win, const void* ttft0,
                                    const void* tpot0, const void* admit0,
                                    const void* tt, const void* tp,
                                    const void* gain, void* out, int64_t n_ctrl,
                                    int64_t n_f, int64_t n_p, int64_t n_g,
                                    float increase, float decrease,
                                    float admit_min, float kp, float ki,
                                    float kd, void* stream) {
  const int64_t n_cells = n_f * n_p * n_g;
  if (n_ctrl <= 0 || n_cells <= 0 || n_cells >= ((int64_t)1 << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(win), static_cast<const float*>(ttft0),
               static_cast<const float*>(tpot0), static_cast<const float*>(admit0),
               static_cast<const float*>(tt), static_cast<const float*>(tp),
               static_cast<const float*>(gain), static_cast<float*>(out),
               n_ctrl, n_f, n_p, n_g, increase, decrease, admit_min, kp, ki, kd};
  const unsigned grid = (unsigned)((n_cells + kThreads - 1) / kThreads);
  admission_ctrl_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
