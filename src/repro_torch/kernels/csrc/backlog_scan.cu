// Backlog recursion of the fleet queue over time bins, wait trace only.
//
// Replaces the lax.scan of repro/traffic/queueing.py (fleet_scan inside
// _fleet_fixed_point, and _fleet_queue_scan): not a Pallas kernel, but on
// the port's path an eager loop over T time bins would cost ~4 launches a
// bin.  For every column c of the (T, C) f32 work plane:
//
//     wait[t, c] = b;   b = f_w(b) = max(min(b + w, cap) - dt, 0),  w = work[t, c]
//
// from b = 0, in f32 with no contraction (there is no multiply to fuse),
// bit for bit the reference's f32 scan and the port's plain loop.
//
// Premise: work is finite and non-negative, cap and dt finite, dt >= 0.
//
// What bounds it on an H100: memory, 8 bytes a cell (read work, write
// wait).  A scan that is serial over T would also run a chain of T steps of
// 4 dependent f32 operations, about 4x the byte bound at T = 40,966, so T
// is cut into chunks that run in parallel, and the result stays exact:
//   1. f_w is monotone non-decreasing in b: each of the rounded +, min,
//      the rounded - and max is;
//   2. after any step b lies in [0, U], U = max(cap - dt, 0);
//   3. so a chunk run once from 0 (lo) and once from U (hi) brackets the
//      true trajectory in every bin;
//   4. from the first bin where lo and hi agree bit for bit (the
//      coalescence bin), both are the true trajectory, whatever the
//      chunk's true start was;
//   5. only the bins before it need the previous chunk's exact end.
//
// Design:
//   * one warp a block, owning a tile of 32 columns and a chunk of
//     `chunk` bins.  The plane is read column-major, as the fleet passes it
//     (a transposed view of its (F, rows, T) plane, read in place; the
//     wrapper copies other layouts to it).  Bins are staged through a ring
//     of kRing bins in shared memory with cp.async, each copy instruction
//     reading 32 bins of one column, 128 contiguous bytes.  Each lane reads
//     its column into registers 32 bins at a time, so a warp keeps about
//     100 bins x 128 B requested and the chain of 4 dependent operations a
//     bin is all that is serial;
//   * a block takes its (tile, chunk) from an atomic ticket, chunks in
//     order, so it only ever waits on chunks that are already running;
//   * pass 1 runs lo and hi together and writes wait from the coalescence
//     bin on.  A column whose runs met publishes the chunk's exact end at
//     once: one 64-bit word, this launch's epoch and the f32 end, so that
//     a reader that sees the epoch sees the value;
//   * the fix-up: each column that needs it waits for the previous
//     chunk's end word of its own column, and the warp re-runs those
//     columns from there, writing wait.  First the columns that never met:
//     the whole chunk, then they publish its end; so a stretch of chunks
//     that never coalesce is serial, as a plain scan is, and only through
//     the columns concerned.  Then the columns that met after their first
//     bin: the bins before the coalescence bin, which nothing waits for.
//     Chunk 0 starts exactly from 0 (lo = hi);
//   * per bin the arithmetic is __fadd_rn, fminf, __fsub_rn, fmaxf, in
//     that order, in every run.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kCols = 32;       // columns of a tile: one warp, one lane each
constexpr int kGroup = 32;      // bins a cp.async group: one per lane
constexpr int kRing = 128;      // bins in the ring

struct Args {
  const float* work;         // element strides 1 over t, sc over c
  float* wait;               // (n_bins, n_cols) contiguous
  unsigned long long* ends;  // (n_chunks, n_cols): epoch << 32 | f32 bits of the end
  unsigned* ticket;          // zero between launches
  int* coal;                 // (n_chunks, n_cols) bins to coalescence, -1: never; or null
  int64_t n_bins, n_cols, sc;
  int chunk, n_tiles;
  float cap, dt;
  unsigned epoch;
};

__device__ __forceinline__ float step(float b, float w, float cap, float dt) {
  return fmaxf(__fsub_rn(fminf(__fadd_rn(b, w), cap), dt), 0.0f);
}

__device__ __forceinline__ bool same(float x, float y) {
  return __float_as_uint(x) == __float_as_uint(y);
}

// A chunk's exact end in one column, tagged with this launch's epoch.
__device__ __forceinline__ void publish_end(unsigned long long* p, unsigned epoch,
                                            float v) {
  const unsigned long long w = (unsigned long long)epoch << 32 | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(w) : "memory");
}

__device__ __forceinline__ float await_end(const unsigned long long* p,
                                           unsigned epoch) {
  unsigned long long w;
  for (;;) {
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(w) : "l"(p) : "memory");
    if ((unsigned)(w >> 32) == epoch) return __uint_as_float((unsigned)w);
    __nanosleep(32);
  }
}

// Where bin u of tile column j lies in the ring.  The 32 lanes write one
// bin of 32 columns each: the bins are rotated across the banks
// ((j + u) % 32) so that neither those writes nor each lane's reads of its
// own column collide.
__device__ __forceinline__ float* slot(float (*ring)[kCols], int u, int j) {
  return &ring[u][(j + u) % kCols];
}

// Streams n bins of the tile's columns through the ring, from `tile` (the
// element of the chunk's first bin and the tile's first column; bins are
// contiguous, columns sc elements apart) and calls body(w) with this
// lane's column, bin after bin (0 for a dead lane).  A group is kGroup
// bins: lane l copies bin l of every column, 32 bins of one column per
// instruction.
template <typename Body>
__device__ __forceinline__ void stream(const float* tile, int64_t sc,
                                       int live_cols, float (*ring)[kCols],
                                       int lane, int n, Body&& body) {
  constexpr int NG = kRing / kGroup;                 // groups in the ring
  const int groups = (n + kGroup - 1) / kGroup;
  const float* next = tile + lane;   // this lane's bin of the next group
  auto issue = [&](int g) {
    if (g < groups) {
      const int u0 = (g % NG) * kGroup;
      const bool ok_bin = g * kGroup + lane < n;
      const float* src = next;
#pragma unroll 8
      for (int j = 0; j < kCols; ++j, src += sc) {
        const bool ok = ok_bin && j < live_cols;
        cp_async4_zfill(slot(ring, u0 + lane, j), ok ? src : tile, ok);
      }
      next += kGroup;
    }
    cp_async_commit();
  };
#pragma unroll
  for (int g = 0; g < NG - 1; ++g) issue(g);
  for (int g = 0; g < groups; ++g) {
    __syncwarp();                 // the slots refilled next were read before
    issue(g + NG - 1);
    cp_async_wait<NG - 1>();
    __syncwarp();                 // the other lanes' copies have landed
    const int u0 = (g % NG) * kGroup;
    float w[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) w[u] = *slot(ring, u0 + u, lane);
    if ((g + 1) * kGroup <= n) {
#pragma unroll
      for (int u = 0; u < kGroup; ++u) body(w[u]);
    } else {                      // the last, partial group
#pragma unroll
      for (int u = 0; u < kGroup; ++u)
        if (g * kGroup + u < n) body(w[u]);
    }
  }
  cp_async_wait<0>();
  __syncwarp();
}

__global__ void __launch_bounds__(kCols)
backlog_scan_kernel(const Args a) {
  __shared__ float ring[kRing][kCols];
  const int lane = threadIdx.x;
  unsigned tk = 0;
  if (lane == 0) {
    tk = atomicAdd(a.ticket, 1u);
    if (tk == gridDim.x - 1) atomicExch(a.ticket, 0u);   // every ticket taken
  }
  tk = __shfl_sync(0xffffffffu, tk, 0);
  const int chunk = tk / a.n_tiles, tile = tk % a.n_tiles;
  const int64_t c = (int64_t)tile * kCols + lane;
  const bool live = c < a.n_cols;
  const int live_cols = (int)min((int64_t)kCols, a.n_cols - (int64_t)tile * kCols);
  const int64_t t0 = (int64_t)chunk * a.chunk;
  const int n = (int)(t0 + a.chunk < a.n_bins ? a.chunk : a.n_bins - t0);
  const float cap = a.cap, dt = a.dt;
  const float* src = a.work + t0 + (int64_t)tile * kCols * a.sc;
  const int64_t cell = (int64_t)chunk * a.n_cols + c;     // of ends and coal
  unsigned long long* end = a.ends + cell;

  // Pass 1: lo from 0 and hi from U together; wait from where they meet.
  float lo = 0.0f, hi = chunk == 0 ? 0.0f : fmaxf(__fsub_rn(cap, dt), 0.0f);
  bool met = false;
  int tc = n, i = 0;
  float* out = a.wait + t0 * a.n_cols + c;
  stream(src, a.sc, live_cols, ring, lane, n, [&](float w) {
    if (!met && same(lo, hi)) {
      met = true;
      tc = i;
    }
    if (met && live) *out = lo;
    out += a.n_cols;
    ++i;
    lo = step(lo, w, cap, dt);
    hi = step(hi, w, cap, dt);
  });
  met = met || same(lo, hi);          // met at the chunk's end: tc = n
  if (live && met) publish_end(end, a.epoch, lo);
  if (live && a.coal != nullptr) a.coal[cell] = met ? tc : -1;

  // The fix-up.  Each column that needs it takes the previous chunk's exact
  // end of its own column and the warp re-runs those columns up to their
  // bin `stop`, writing wait; returns the value reached there.
  auto rerun = [&](bool need, int stop) {
    const int todo = (int)__reduce_max_sync(0xffffffffu, need ? (unsigned)stop : 0u);
    float x = need ? await_end(end - a.n_cols, a.epoch) : 0.0f;
    __syncwarp();
    float* o = a.wait + t0 * a.n_cols + c;
    int j = 0;
    stream(src, a.sc, live_cols, ring, lane, todo, [&](float w) {
      if (need && j < stop) {
        *o = x;
        x = step(x, w, cap, dt);
      }
      o += a.n_cols;
      ++j;
    });
    return x;
  };
  // A: columns whose runs never met re-run the whole chunk and publish its
  // end; the next chunk may be waiting for it.
  const bool full = live && !met;
  if (__any_sync(0xffffffffu, full)) {
    const float x = rerun(full, n);
    if (full) publish_end(end, a.epoch, x);
  }
  // B: columns that met after their first bin fill the bins before it;
  // nothing waits for these, so they come last.
  const bool prefix = live && met && tc > 0;
  if (__any_sync(0xffffffffu, prefix)) rerun(prefix, tc);
}

}  // namespace

// wait (n_bins, n_cols) f32, contiguous, from work (n_bins, n_cols) f32
// with element strides st and sc, st == 1 unless n_bins == 1 (the fleet's
// transposed view is read in place), in chunks of `chunk` bins.  ends:
// n_chunks * n_cols 64-bit words none of which holds `epoch` in its high
// half (a number never passed before); ticket: one unsigned zero, left
// zero; coal: null, or n_chunks * n_cols ints that receive each chunk's
// bins to coalescence (-1: the runs never met).  Returns the launch's
// error: 0 when the kernel was launched.
extern "C" int repro_backlog_scan(const void* work, void* wait, void* ends,
                                  void* ticket, void* coal, int64_t n_bins,
                                  int64_t n_cols, int64_t st, int64_t sc,
                                  int chunk, float cap, float dt, unsigned epoch,
                                  void* stream) {
  if (n_bins <= 0 || n_cols <= 0 || chunk <= 0 || (st != 1 && n_bins > 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_tiles = (n_cols + kCols - 1) / kCols;
  const int64_t n_chunks = (n_bins + chunk - 1) / chunk;
  if (n_tiles * n_chunks >= (int64_t)1 << 31)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(work), static_cast<float*>(wait),
               static_cast<unsigned long long*>(ends), static_cast<unsigned*>(ticket),
               static_cast<int*>(coal), n_bins, n_cols, sc, chunk,
               static_cast<int>(n_tiles), cap, dt, epoch};
  const unsigned grid = (unsigned)(n_tiles * n_chunks);
  backlog_scan_kernel<<<grid, kCols, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
