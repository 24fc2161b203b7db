// Scatter-add deposit of COO triples into a dense f64 plane, in table order.
//
// Replaces the TPU kernel repro/kernels/deposit.py:deposit (the one-hot
// matmul _deposit_kernel) on the fleet simulator's f64 path: out[r, c] is
// the sum of the values of every triple (r, c, v), taken one after the
// other in table order starting from 0.0 -- bit for bit the reference's
// scatter-add (repro/kernels/ref.py:deposit_ref, XLA applies updates in
// order) and the port's plain version.  Atomics would add in a racing
// order and are not used.
//
// Input: the triples grouped by row.  Row r owns entries
// [row_ptr[r], row_ptr[r+1]) of cols/vals, in table order; entries at and
// past row_ptr[n_rows] are not read (the fleet's zero-valued padding:
// adding +0.0 to a sum that starts at +0.0 never changes it).
//
// What bounds it on an H100: memory.  Each triple is read (bin and value,
// 16 bytes) and the plane written once (8 bytes a cell), no arithmetic to
// speak of; at the fleet's shapes (5.4 M triples into 864 x ~41,000
// bins) that is ~0.37 GB, ~0.11 ms at 3.35 TB/s.  The order constraint
// makes one warp walk a row's triples serially, so a row with many
// triples is latency-bound.
//
// Design (simple first):
//   * one block of one warp per (row, tile of kTile bins), grid.y wrapping
//     over rows past 65,535; the tile's f64 accumulator lives in shared
//     memory, so every output cell is written exactly once, coalesced, and
//     the output needs no zeroing;
//   * the warp walks its row's triples 32 at a time (kUnroll groups
//     loaded ahead), keeps the ones in its tile, groups lanes on the same
//     bin with __match_any_sync and adds them to the accumulator in lane
//     (= table) order, one rank per step; different bins never collide;
//   * every tile of a row re-reads the row's triples (from L2 after the
//     first); a (row, tile) bucketing pass is later work.
#include <stdint.h>

#include <algorithm>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 2048;      // bins per block: 16 KiB of f64
constexpr int kUnroll = 4;       // 32-triple groups loaded ahead

__global__ void __launch_bounds__(32)
deposit_kernel(const int64_t* __restrict__ row_ptr,
               const int64_t* __restrict__ cols,
               const double* __restrict__ vals, double* __restrict__ out,
               int64_t n_rows, int64_t n_cols) {
  __shared__ double acc[kTile];
  const int lane = threadIdx.x;
  const unsigned below = (1u << lane) - 1u;
  const int64_t tile0 = (int64_t)blockIdx.x * kTile;
  const int width = (int)min((int64_t)kTile, n_cols - tile0);
  for (int64_t row = blockIdx.y; row < n_rows; row += gridDim.y) {
    for (int i = lane; i < width; i += 32) acc[i] = 0.0;
    __syncwarp();
    const int64_t end = row_ptr[row + 1];
    for (int64_t base = row_ptr[row]; base < end; base += 32 * kUnroll) {
      int64_t c[kUnroll];
      double v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t j = base + u * 32 + lane;
        c[u] = j < end ? cols[j] - tile0 : -1;
        v[u] = j < end ? vals[j] : 0.0;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool mine = c[u] >= 0 && c[u] < width;
        if (!__any_sync(0xffffffffu, mine)) continue;
        // Lanes outside the tile get keys no in-tile lane can have.
        const int key = mine ? (int)c[u] : -1 - lane;
        const int rank = __popc(__match_any_sync(0xffffffffu, key) & below);
        for (int r = 0;; ++r) {          // same-bin lanes in lane order
          const bool now = mine && rank == r;
          if (!__any_sync(0xffffffffu, now)) break;
          if (now) acc[c[u]] += v[u];
          __syncwarp();
        }
      }
    }
    __syncwarp();
    double* dst = out + row * n_cols + tile0;
    for (int i = lane; i < width; i += 32) dst[i] = acc[i];
    __syncwarp();
  }
}

}  // namespace

// out (n_rows, n_cols) f64, every cell written.  Returns cudaGetLastError().
extern "C" int repro_deposit(const void* row_ptr, const void* cols,
                             const void* vals, void* out, int64_t n_rows,
                             int64_t n_cols, void* stream) {
  if (n_rows <= 0 || n_cols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  // Rows beyond grid.y's limit are taken by the same blocks in turn.
  const dim3 grid((unsigned)((n_cols + kTile - 1) / kTile),
                  (unsigned)std::min<int64_t>(n_rows, 65535));
  deposit_kernel<<<grid, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(row_ptr), static_cast<const int64_t*>(cols),
      static_cast<const double*>(vals), static_cast<double*>(out), n_rows,
      n_cols);
  return static_cast<int>(cudaGetLastError());
}
