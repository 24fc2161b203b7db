// Backlog recursion of the fleet queue, time-major, wait trace only.
//
// Replaces the lax.scan of repro/traffic/queueing.py (fleet_scan inside
// _fleet_fixed_point, and _fleet_queue_scan): not a Pallas kernel, but on
// the port's path an eager loop over T time bins would cost ~4 launches a
// bin.  For every column c of the (T, C) f32 work plane:
//
//     wait[t, c] = b;   b = max(min(b + work[t, c], cap) - dt, 0)
//
// from b = 0, in f32 with no contraction (there is no multiply to fuse),
// bit for bit the reference's f32 scan and the port's plain loop.
//
// What bounds it on an H100: memory (read work, write wait: 8 bytes a
// cell) -- the recursion's dependence is through b alone, so the loads
// of later bins do not wait for it.  Design: one thread per column,
// neighbouring threads on neighbouring columns (coalesced at every t);
// kAhead bins are loaded into registers before they are consumed, so
// loads run ahead of the serial chain.
#include <stdint.h>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kAhead = 16;

__global__ void __launch_bounds__(kThreads)
backlog_scan_kernel(const float* __restrict__ work, float* __restrict__ wait,
                    int64_t n_bins, int64_t n_cols, float cap, float dt) {
  const int64_t c = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (c >= n_cols) return;
  float b = 0.0f;
  for (int64_t t0 = 0; t0 < n_bins; t0 += kAhead) {
    float w[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      w[u] = (t0 + u < n_bins) ? work[(t0 + u) * n_cols + c] : 0.0f;
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (t0 + u < n_bins) {
        wait[(t0 + u) * n_cols + c] = b;
        b = fmaxf(__fsub_rn(fminf(__fadd_rn(b, w[u]), cap), dt), 0.0f);
      }
    }
  }
}

}  // namespace

// wait (n_bins, n_cols) f32.  Returns cudaGetLastError().
extern "C" int repro_backlog_scan(const void* work, void* wait, int64_t n_bins,
                                  int64_t n_cols, float cap, float dt,
                                  void* stream) {
  if (n_bins <= 0 || n_cols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = (unsigned)((n_cols + kThreads - 1) / kThreads);
  backlog_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(work), static_cast<float*>(wait), n_bins, n_cols,
      cap, dt);
  return static_cast<int>(cudaGetLastError());
}
