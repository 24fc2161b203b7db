// The admission controller's window maxima of the critical-path estimate
// qhat, from the fleet's wait trace, in one pass over it.
//
// Replaces the qhat/window half of adm_scan in repro/traffic/queueing.py
// (_fleet_fixed_point) and of repro/traffic/admission.py
// admission_queue_scan (a lax.scan over every time bin; not a Pallas
// kernel), which the plain version computes as batched gathers of the wait
// trace (qhat_trace in kernels/admission_window.py, a few hundred launches
// an iteration) and a scatter_reduce.  For every bin t, entry f and plan p:
//
//   after[t]   = wait[t + 1]  (t < T - 1),
//                max(min(wait[T - 1] + work_last, cap) - dt, 0)  (t = T - 1)
//   qhat[t, f, p] = sum_l after[t, f, gw[s, p, l]]
//                 + sum_l max_i after[t, f, ex[s, p, l * I + i]],  s = slot[t]
//
// (each sum over layers in index order, starting from layer 0's term, then
// gateway + expert; the station tables are shared by the entries, n_e = 1,
// or the entry's own, n_e = F: gw[s, f, p, l], the joint control plane's
// schedule row), and win[k, f, p] = the maximum of qhat over the bins of
// window k (seg[t] == k; bins with seg[t] == n_ctrl belong to no window),
// stored k-contiguous: win[f, p, k].
// Every add is __fadd_rn in that order and max is exact, so the result is
// bit for bit the plain composition (kernels/admission_window.py).
//
// Premise: wait and work_last are finite and non-negative (backlog_scan's
// premise, kernels/csrc/backlog_scan.cu), so qhat is too: fmaxf, the plain
// version's amax and an integer max of the f32 bit patterns all agree.
//
// What bounds it on an H100: memory.  It reads the (T, F, C) f32 plane once
// (207.5 MB for FleetSim.run() on the paper's world), 0.062 ms at
// 3.35 TB/s; the gathers (F * P * L * (I + 1) a bin, 864 on that world)
// are random columns of one bin's row.  Design:
//   * a block takes `tile` consecutive bins and stages the rows after them
//     (a contiguous stretch of the plane) in shared memory with cp.async:
//     16 bytes a copy where rows are whole 16-byte words (then padded by
//     4 floats, 2-way bank conflicts at worst below), else 4 bytes a copy
//     into rows padded to an odd stride; the last bin's row is one more
//     step of the recursion, computed there.  The bins' slots and
//     windows and the stations of the tile's first slot are staged too;
//   * phase A, one item a (bin, f, p, layer): the warps split the layers,
//     the lanes the (bin, f, p) tasks, bins fastest, so the lanes of a
//     warp read one column of consecutive rows (distinct banks at an odd
//     stride, pairs at a stride of 4 mod 32): the
//     layer's gateway backlog and the maximum over its experts, into
//     shared memory.  The items do not depend on each other, so their
//     gathers overlap;
//   * phase B, one thread a (bin, f, p): the two sums over layers in index
//     order (__fadd_rn), then gateway + expert;
//   * the window maximum: lanes on the same (window, f, p) reduce theirs
//     (__match_any_sync, __reduce_max_sync on the bit patterns) and one
//     atomicMax per group lands in win, which the launcher zeroes first.
//     The maximum needs no order, so the result does not depend on which
//     block lands first.
//   * about 72 KB of shared memory a block, three blocks an SM: one
//     block's sums run while the others' copies are in flight.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct Args {
  const float* wait;       // (n_bins, n_f * n_c) contiguous
  const float* work_last;  // element (f, c) at f * slf + c * slc
  const int* gw;           // (n_slots, n_e, P, L) columns of the gateway chain
  const int* ex;           // (n_slots, n_e, P, L * I) columns of the experts
  const int* slot;         // (n_bins,) row of gw / ex per bin
  const int* seg;          // (n_bins,) window of each bin; n_ctrl: none
  int* win;                // (F, P, n_ctrl) f32 bit patterns, zero on entry
  int64_t n_bins, slf, slc;
  int n_f, n_c, n_p, n_l, n_i, n_e, n_ctrl, tile, stride;
  float cap, dt;
};

__global__ void __launch_bounds__(kThreads)
admission_window_kernel(const Args a) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int n_fc = a.n_f * a.n_c;
  const int n_fp = a.n_f * a.n_p;
  const int n_li = a.n_l * a.n_i;
  const int64_t t0 = (int64_t)blockIdx.x * a.tile;
  const int rows = (int)min((int64_t)a.tile, a.n_bins - t0);
  float* plane = smem;                                        // tile x stride
  float* s_gsum = plane + (int64_t)a.tile * a.stride;         // (f*P+p, l, b)
  float* s_emax = s_gsum + a.tile * n_fp * a.n_l;             // (f*P+p, l, b)
  int* s_slot = reinterpret_cast<int*>(s_emax + a.tile * n_fp * a.n_l);
  int* s_seg = s_slot + a.tile;
  const int n_epl = a.n_e * a.n_p * a.n_l;                    // a slot's gateways
  int* s_gw = s_seg + a.tile;                                 // n_e x P x L
  int* s_ex = s_gw + n_epl;                                   // n_e x P x L * I

  // The rows after the tile's bins, rows t0 + 1 .. of the plane.
  const int copy_rows = (int)min((int64_t)rows, a.n_bins - 1 - t0);
  {
    const float* src = a.wait + (t0 + 1) * n_fc;
    if ((n_fc & 3) == 0 && (a.stride & 3) == 0 && ((uintptr_t)a.wait & 15) == 0) {
      const int vpr = n_fc >> 2;                   // 16-byte copies a row
      const int total = copy_rows * vpr;
      int r = tid / vpr, c = tid % vpr;
      for (int idx = tid; idx < total; idx += kThreads) {
        cp_async16(plane + r * a.stride + 4 * c, src + 4 * (int64_t)idx);
        c += kThreads;
        while (c >= vpr) {
          c -= vpr;
          ++r;
        }
      }
    } else {
      const int64_t total = (int64_t)copy_rows * n_fc;
      int r = tid / n_fc, c = tid % n_fc;
      for (int64_t idx = tid; idx < total; idx += kThreads) {
        cp_async4_zfill(plane + r * a.stride + c, src + idx, true);
        c += kThreads;
        while (c >= n_fc) {
          c -= n_fc;
          ++r;
        }
      }
    }
    cp_async_commit();
  }
  const int s0 = a.slot[t0];
  for (int i = tid; i < rows; i += kThreads) {
    s_slot[i] = a.slot[t0 + i];
    s_seg[i] = a.seg[t0 + i];
  }
  for (int i = tid; i < n_epl; i += kThreads)
    s_gw[i] = a.gw[(int64_t)s0 * n_epl + i];
  for (int i = tid; i < n_epl * a.n_i; i += kThreads)
    s_ex[i] = a.ex[(int64_t)s0 * n_epl * a.n_i + i];
  if (copy_rows < rows) {      // the tile holds bin T - 1: one more step
    const float* last = a.wait + (a.n_bins - 1) * n_fc;
    float* dst = plane + copy_rows * a.stride;
    for (int i = tid; i < n_fc; i += kThreads) {
      const int f = i / a.n_c, c = i % a.n_c;
      const float w = a.work_last[f * a.slf + c * a.slc];
      dst[i] = fmaxf(__fsub_rn(fminf(__fadd_rn(last[i], w), a.cap), a.dt), 0.0f);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // Phase A: one item a (bin, f, p, layer).  Each thread keeps the same
  // tasks (bin, f, p), bins fastest, for every layer its warp takes, so
  // no index is divided inside the loop.
  const int n_tasks = rows * n_fp;
  const int warp = tid >> 5, lane = tid & 31;
  constexpr int kWarps = kThreads / 32;
  for (int t = lane; t < n_tasks; t += 32) {
    const int b = t % rows, fp = t / rows;
    if (s_seg[b] >= a.n_ctrl) continue;          // after the last window
    const int f = fp / a.n_p, p = fp % a.n_p;
    const int ep = (a.n_e == 1 ? 0 : f) * a.n_p + p;          // row of the tables
    const int s = s_slot[b];
    const int* gw = (s == s0 ? s_gw : a.gw + (int64_t)s * n_epl) + ep * a.n_l;
    const int* ex = (s == s0 ? s_ex : a.ex + (int64_t)s * n_epl * a.n_i) + ep * n_li;
    const float* row = plane + b * a.stride + f * a.n_c;
    float* g_out = s_gsum + fp * a.n_l * rows + b;
    float* e_out = s_emax + fp * a.n_l * rows + b;
    for (int l = warp; l < a.n_l; l += kWarps) {
      // the layer's I gathers are independent: eight in flight at a time
      const int* x = ex + l * a.n_i;
      float m = __int_as_float(0xff800000);     // -inf: max(-inf, v) = v
      for (int i0 = 0; i0 < a.n_i; i0 += 8) {
        float v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) v[u] = i0 + u < a.n_i ? row[x[i0 + u]] : m;
#pragma unroll
        for (int u = 0; u < 8; ++u) m = fmaxf(m, v[u]);
      }
      g_out[l * rows] = row[gw[l]];
      e_out[l * rows] = m;
    }
  }
  __syncthreads();

  // Phase B: one task a (bin, f, p), bins fastest; every lane of a warp
  // takes part in the reduction, live or not.
  for (int base = 0; base < n_tasks; base += kThreads) {
    const int task = base + tid;
    int key = -1, bits = 0;
    if (task < n_tasks) {
      const int b = task % rows, fp = task / rows;
      const int k = s_seg[b];
      if (k < a.n_ctrl) {
        const float* g = s_gsum + fp * a.n_l * rows + b;
        const float* e = s_emax + fp * a.n_l * rows + b;
        float gs = g[0], es = e[0];
#pragma unroll 8
        for (int l = 1; l < a.n_l; ++l) {
          gs = __fadd_rn(gs, g[l * rows]);
          es = __fadd_rn(es, e[l * rows]);
        }
        key = fp * a.n_ctrl + k;
        bits = __float_as_int(__fadd_rn(gs, es));
      }
    }
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    const int top = __reduce_max_sync(peers, bits);
    if (key >= 0 && lane == __ffs(peers) - 1) atomicMax(a.win + key, top);
  }
}

}  // namespace

// win (F, P, n_ctrl) f32 (each (f, p)'s windows contiguous, as
// admission_ctrl reads them) from wait (n_bins, F * C) f32 (contiguous),
// work_last (F, C) f32 with element strides slf, slc, the int32 station
// tables gw (n_slots, n_e, P, L) and ex (n_slots, n_e, P, L * I)
// (contiguous, columns in [0, C); n_e is 1, tables shared by the entries,
// or F, each entry's own), slot (n_bins,) in [0, n_slots) and seg (n_bins,) in
// [0, n_ctrl], `tile` bins a block with rows `stride` floats apart
// (stride >= F * C; window_tile in kernels/admission_window.py).  Zeroes
// win first.  Returns the launch's error: 0 when
// the kernel was launched.
extern "C" int repro_admission_window(const void* wait, const void* work_last,
                                      const void* gw, const void* ex,
                                      const void* slot, const void* seg, void* win,
                                      int64_t n_bins, int64_t slf, int64_t slc,
                                      int n_f, int n_c, int n_p, int n_l, int n_i,
                                      int n_e, int n_ctrl, int tile, int stride, float cap,
                                      float dt, void* stream) {
  if (n_bins <= 0 || n_ctrl <= 0 || n_f <= 0 || n_c <= 0 || n_p <= 0 || n_l <= 0 ||
      n_i <= 0 || (n_e != 1 && n_e != n_f) || tile <= 0 || stride < n_f * n_c ||
      (int64_t)n_ctrl * n_f * n_p >= ((int64_t)1 << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = ((size_t)tile * (stride + 2 * n_f * n_p * n_l + 2) +
                       (size_t)n_e * n_p * n_l * (1 + n_i)) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      admission_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(win, 0, (size_t)n_ctrl * n_f * n_p * 4, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{static_cast<const float*>(wait), static_cast<const float*>(work_last),
               static_cast<const int*>(gw), static_cast<const int*>(ex),
               static_cast<const int*>(slot), static_cast<const int*>(seg),
               static_cast<int*>(win), n_bins, slf, slc, n_f, n_c, n_p, n_l, n_i,
               n_e, n_ctrl, tile, stride, cap, dt};
  const unsigned grid = (unsigned)((n_bins + tile - 1) / tile);
  admission_window_kernel<<<grid, kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
