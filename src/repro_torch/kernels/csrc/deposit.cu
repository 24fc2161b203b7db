// Scatter-add deposit of COO triples into a dense f64 plane, in table order.
//
// Replaces the TPU kernel repro/kernels/deposit.py:147 deposit (the
// one-hot matmul _deposit_kernel) on the fleet simulator's f64 path:
// out[r, c] is the sum of the values of every triple (r, c, v), taken one
// after the other in table order starting from +0.0 -- bit for bit the
// reference's scatter-add (repro/kernels/ref.py:deposit_ref, XLA applies
// updates in order) and the port's plain version.  No atomics, no tree
// sums: every add of a cell happens in table order.
//
// Input: the triples grouped by row.  Row r owns entries
// [row_ptr[r], row_ptr[r+1]) of cols/vals, in table order; entries at and
// past row_ptr[n_rows] are not read (the fleet's zero-valued padding).
// Bins outside [0, n_cols) are not deposited.
//
// What bounds it on an H100: memory.  The least traffic is each triple
// read once (bin and value, 16 bytes) and the f64 plane written once (8
// bytes a cell); at the fleet's shapes (5.4 M triples into 864 x ~41,000
// bins) ~0.37 GB, 0.110 ms at 3.35 TB/s, three quarters of it the plane.
// The order constraint makes each cell a chain of dependent f64 adds, one
// after the other whatever the design, and the fleet piles up to 14,066
// triples on one cell, bin T - 1, where every time past the horizon is
// clamped; its rows are skewed too (the longest 14x the median).
//
// Design: two kernel launches a call, after a 16-byte memset, on the
// caller's stream.
//   1. bucket: one block per row sorts the row's triples stably by tile
//      (kTile bins) into scratch, in the row's own index range.  The block
//      has 16 warps (8 for rows of more than 3584 tiles), so that long
//      rows are not left to few warps.  Warp w takes the w-th contiguous
//      stretch of the row (a multiple of 32 entries), kLoad groups of 32
//      a round; a count pass gives counts per (warp, tile) in shared
//      memory, asking L2 for the bins kAhead rounds on; an exclusive scan
//      in (tile, warp) order gives each warp a cursor per tile; a scatter
//      pass writes each group of 32 entries to cursor + rank, the rank
//      among the lanes of the same tile (__match_any_sync, cheap here: a
//      group spans few tiles).  So a bucket keeps table order: lanes in
//      lane order, a warp's groups in order, warps in row order.  An entry
//      is 10 bytes (u16 bin in the tile, f64 value); the row's bucket ends
//      go to `ends` (int32, relative to the row start), and buckets of
//      more than kLong entries onto a list.  Traffic: bins read twice (the
//      second time partly from L2), values once, the entries written once.
//   2. accumulate: persistent warps, kWarps a block and as many blocks as
//      fit the card.  They take the listed long buckets first, one at a
//      time (the fleet's chains on bin T - 1 and its busiest bins, which
//      then start at once), then the other (row, tile) tasks in runs from
//      a second counter, every row's last tile first: a run is a share of
//      what is left (guided scheduling), because one counter serves its
//      atomics one after another.  No warp waits for another.  For a task
//      the warp reads its bucket only, kUnroll steps of 32 entries a
//      round, the next two rounds' loads in flight while one is summed
//      and the round kAhead rounds on asked into L2 (a long bucket is
//      otherwise held up by memory latency, not by its adds); it sums into
//      a tile of kTile f64 in shared memory and writes the tile once,
//      coalesced, 16 bytes a lane where the row starts on 16 bytes, so the
//      plane needs no zeroing.  In a step, lanes on different cells add at
//      once.  Lanes that share a cell are found by claims: each lane
//      writes its id into a byte per bin and reads it back, a lane that
//      reads another's shares its cell, and one ballot per shared cell
//      finds its lanes (__match_any_sync, whose cost grows with the
//      distinct keys of the step, only where more than kBallots lanes
//      lose their claim).  A shared cell's lanes are added by its lowest
//      lane in lane order, the values brought over by shuffles kBatch at a
//      time, the sum kept in a register, so a step takes as long as its
//      largest group.  A step, or a whole round, whose lanes all hit one
//      cell (a pile) goes through shared memory to lane 0, which adds the
//      values in one chain, reading them 8 ahead of the adds, and carries
//      the sum in a register into the next pile on that cell.  Zero-valued
//      entries are skipped: a cell's sum starts at +0.0 and so is never
//      -0.0, and x + (+-0.0) == x for every other x.
// Scratch (from the caller): 16 bytes (task counters, long-bucket count)
// + 10 bytes a table entry (cols' length, padding included) + 8 bytes a
// (row, tile) (bucket end, long-bucket list).
#include <limits.h>
#include <stdint.h>

#include <algorithm>

#include <cuda_runtime.h>

namespace {

constexpr int kTileLog = 9;
constexpr int kTile = 1 << kTileLog;   // bins a bucket and a warp's tile cover
constexpr int kMaxBucketWarps = 16;    // warps a bucket block: 16, or 8 for
                                       // rows of more than 3584 tiles
constexpr int kLoad = 4;               // 32-entry groups a bucket warp loads
                                       // at once (3 blocks of 16 warps fit
                                       // an SM in 40 registers a thread)
constexpr int kWarps = 8;              // warps an accumulate block
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;             // 32-entry steps an accumulate round
constexpr int kAhead = 4;              // rounds ahead asked into L2 (both
                                       // launches)
constexpr int kBatch = 8;              // values a leader shuffles in at once
constexpr int kLong = 2048;            // entries of a long bucket, summed first
constexpr int kMaxRun = 16;            // other tasks a warp takes at once,
constexpr int kGuide = 8;              // at most, and 1 / kGuide of its share
                                       // of what is left
constexpr int kBallots = 8;            // claims a step may lose and still find
                                       // its shared cells by ballots (one
                                       // round trip each); more: one match
constexpr unsigned kFull = 0xffffffffu;
// Tiles a row may have: the bucket block keeps one int32 counter per
// (warp, tile) in shared memory, 8 warps at least, 227 KB at most.
constexpr int kMaxTiles = 7168;
constexpr size_t kMaxSmem = 232448 - sizeof(int) * kMaxBucketWarps;

// L2 prefetch of the 128-byte line at p (no registers, no wait).
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

__global__ void __launch_bounds__(32 * kMaxBucketWarps, 3)
deposit_bucket_kernel(const int64_t* __restrict__ row_ptr,
                      const int64_t* __restrict__ cols,
                      const double* __restrict__ vals,
                      uint16_t* __restrict__ sbin, double* __restrict__ sval,
                      int* __restrict__ ends, int* __restrict__ long_tasks,
                      unsigned* __restrict__ n_long, int64_t n_cols,
                      int n_tiles) {
  extern __shared__ int cur[];     // [warps][n_tiles]: counts, then cursors
  __shared__ int warp_sum[kMaxBucketWarps];
  const int warps = blockDim.x >> 5, threads = blockDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int64_t row = blockIdx.x;
  const int64_t start = row_ptr[row];
  const int n = (int)(row_ptr[row + 1] - start);
  const int span = (n + threads - 1) / threads * 32;
  const int lo = min(n, warp * span), hi = min(n, lo + span);
  const int64_t* c_row = cols + start;
  const double* v_row = vals + start;
  int* mine = cur + warp * n_tiles;

  for (int i = threadIdx.x; i < warps * n_tiles; i += threads) cur[i] = 0;
  __syncthreads();
  // Count pass: entries per (warp, tile); each round asks L2 for the bins
  // kAhead rounds on (the scatter pass has no registers to spare for it).
  for (int j0 = lo; j0 < hi; j0 += 32 * kLoad) {
    if (lane < 2 * kLoad && j0 + kAhead * 32 * kLoad + 16 * lane < hi)
      prefetch_l2(c_row + j0 + kAhead * 32 * kLoad + 16 * lane);
    int64_t c[kLoad];
#pragma unroll
    for (int u = 0; u < kLoad; ++u) {
      const int j = j0 + u * 32 + lane;
      c[u] = j < hi ? c_row[j] : -1;
    }
#pragma unroll
    for (int u = 0; u < kLoad; ++u) {
      const bool ok = c[u] >= 0 && c[u] < n_cols;
      const int key = ok ? (int)(c[u] >> kTileLog) : -1 - lane;
      const unsigned peers = __match_any_sync(kFull, key);
      if (ok && (peers & below) == 0) mine[key] += __popc(peers);
      __syncwarp();
    }
  }
  __syncthreads();

  // Exclusive scan in (tile, warp) order: element i = t * warps + w.
  const int m = warps * n_tiles;
  const int per = (m + threads - 1) / threads;
  const int i0 = min(m, (int)threadIdx.x * per), i1 = min(m, i0 + per);
  int sum = 0;
  for (int i = i0; i < i1; ++i) sum += cur[(i % warps) * n_tiles + i / warps];
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  int run = incl - sum, total = 0;
  for (int w = 0; w < warps; ++w) {
    run += w < warp ? warp_sum[w] : 0;
    total += warp_sum[w];
  }
  for (int i = i0; i < i1; ++i) {
    int& x = cur[(i % warps) * n_tiles + i / warps];
    const int cnt = x;
    x = run;
    run += cnt;
  }
  __syncthreads();
  // Tile t's bucket ends where tile t + 1's (warp 0's part) starts.  A
  // long bucket goes on the list the accumulate launch takes first.
  for (int t = threadIdx.x; t < n_tiles; t += threads) {
    const int end = t + 1 < n_tiles ? cur[t + 1] : total;
    ends[row * n_tiles + t] = end;
    if (end - cur[t] > kLong)
      long_tasks[atomicAdd(n_long, 1u)] = (int)(row * n_tiles + t);
  }
  __syncthreads();

  // Scatter pass: each entry to its warp's cursor for its tile + its rank.
  for (int j0 = lo; j0 < hi; j0 += 32 * kLoad) {
    int64_t c[kLoad];
    double v[kLoad];
#pragma unroll
    for (int u = 0; u < kLoad; ++u) {
      const int j = j0 + u * 32 + lane;
      c[u] = j < hi ? c_row[j] : -1;
      v[u] = j < hi ? v_row[j] : 0.0;
    }
#pragma unroll
    for (int u = 0; u < kLoad; ++u) {
      const bool ok = c[u] >= 0 && c[u] < n_cols;
      const int key = ok ? (int)(c[u] >> kTileLog) : -1 - lane;
      const unsigned peers = __match_any_sync(kFull, key);
      const int leader = __ffs(peers) - 1;
      int base = 0;
      if (ok && lane == leader) {
        base = mine[key];
        mine[key] = base + __popc(peers);
      }
      base = __shfl_sync(kFull, base, leader);
      if (ok) {
        const int64_t d = start + base + __popc(peers & below);
        sbin[d] = (uint16_t)(c[u] & (kTile - 1));
        sval[d] = v[u];
      }
      __syncwarp();
    }
  }
}

// s + x[0] + x[1] + ... + x[2 * N2 - 1], one add after the other, the
// values read from shared memory 8 ahead of their adds.
template <int N2>
__device__ __forceinline__ double chain(double s, const double2* x) {
  double2 w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) w[q] = x[q];
#pragma unroll
  for (int k = 0; k < N2; k += 4) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const double2 y = w[q];
      if (k + 4 + q < N2) w[q] = x[k + 4 + q];
      s += y.x;
      s += y.y;
    }
  }
  return s;
}

// Per warp: its tile, the values of a pile, and a claim byte per bin.
struct WarpScratch {
  double2 acc[kTile / 2];
  double2 pile[16 * kUnroll];
  unsigned char claim[kTile];
};

// Lane 0 adds the `n2` * 2 values staged in w.pile to cell `key`, in
// order, carrying the running sum into the next pile on the same cell.
template <int N2>
__device__ __forceinline__ void add_pile(WarpScratch& w, int key, int lane,
                                         double& carry, int& carry_key) {
  __syncwarp();
  if (lane == 0) {
    double* a = reinterpret_cast<double*>(w.acc);
    const double s = chain<N2>(key == carry_key ? carry : a[key], w.pile);
    a[key] = s;
    carry = s;
  }
  carry_key = key;
  __syncwarp();
}

// One step of 32 bucket entries (bin in the tile, value; bin -1: none)
// into the warp's tile.  carry / carry_key: lane 0's running sum of the
// last pile, while no other step has touched its cell.
__device__ __forceinline__ void accumulate_step(int bin, double v,
                                                WarpScratch& w, int lane,
                                                double& carry,
                                                int& carry_key) {
  const unsigned below = (1u << lane) - 1u;
  double* a = reinterpret_cast<double*>(w.acc);
  const bool ok = bin >= 0 && v != 0.0;
  const int key = ok ? bin : -1 - lane;          // skipped lanes: alone
  if (__all_sync(kFull, key == __shfl_sync(kFull, key, 0))) {
    // A pile: all 32 lanes on one cell, added in one chain by lane 0.
    reinterpret_cast<double*>(w.pile)[lane] = v;
    add_pile<16>(w, key, lane, carry, carry_key);
    return;
  }
  carry_key = -1;
  // Lanes on a shared cell: each lane claims its cell; a lane that reads
  // back another lane's claim shares it.  Each shared cell's lanes are
  // then found with one ballot.
  if (ok) w.claim[key] = (unsigned char)lane;
  __syncwarp();
  unsigned lost = __ballot_sync(kFull, ok && w.claim[key] != lane);
  unsigned peers = 1u << lane;
  if (__popc(lost) > kBallots) {         // many shared cells: one match
    peers = __match_any_sync(kFull, key);
  } else {
    while (lost) {                       // the same bits in every lane
      const int other = __shfl_sync(kFull, key, __ffs(lost) - 1);
      const unsigned m = __ballot_sync(kFull, key == other);
      if (key == other) peers = m;
      lost &= ~m;
    }
  }
  const bool single = peers == (1u << lane);
  if (ok && single) a[key] += v;
  if (__any_sync(kFull, !single)) {      // cells hit by 2..31 lanes
    // Each lowest lane adds its cell's lanes in lane order, kBatch values
    // brought over at a time; the step takes as long as its largest group.
    const bool lead = !single && (peers & below) == 0;
    unsigned m = lead ? peers : 0u;      // lanes the leader has yet to add
    double s = lead ? a[key] : 0.0;
    for (int left = (int)__reduce_max_sync(kFull, __popc(m)); left > 0;
         left -= kBatch) {
      bool have[kBatch];
      double x[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        have[q] = m != 0u;
        x[q] = __shfl_sync(kFull, v, have[q] ? __ffs(m) - 1 : lane);
        m &= m - 1u;
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q)
        if (have[q]) s += x[q];
    }
    if (lead) a[key] = s;
  }
  __syncwarp();
}

// One (row, tile) task: the tile's bucket [b0, b1) summed into the
// warp's shared tile (zero on entry and again on return), then written
// once, coalesced, so the plane needs no zeroing.
__device__ __forceinline__ void accumulate_tile(
    const uint16_t* __restrict__ sbin, const double* __restrict__ sval,
    int64_t b0, int64_t b1, double* __restrict__ dst, int width, bool pairs,
    WarpScratch& w, int lane) {
  double2* a2 = w.acc;
  double* a = reinterpret_cast<double*>(a2);
  // kUnroll steps of entries a round; the next two rounds' loads are in
  // flight while this one is summed, and the round kAhead rounds on is
  // asked into L2, so a long bucket is less held up by memory latency.
  int bin[kUnroll], nbin[kUnroll], mbin[kUnroll];
  double v[kUnroll], nv[kUnroll], mv[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t j = b0 + u * 32 + lane, k = j + 32 * kUnroll;
    nbin[u] = j < b1 ? (int)sbin[j] : -1;
    nv[u] = j < b1 ? sval[j] : 0.0;
    mbin[u] = k < b1 ? (int)sbin[k] : -1;
    mv[u] = k < b1 ? sval[k] : 0.0;
  }
  double carry = 0.0;
  int carry_key = -1;
  for (int64_t j0 = b0; j0 < b1; j0 += 32 * kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      bin[u] = nbin[u];
      v[u] = nv[u];
      nbin[u] = mbin[u];
      nv[u] = mv[u];
      const int64_t j = j0 + (2 * kUnroll + u) * 32 + lane;
      mbin[u] = j < b1 ? (int)sbin[j] : -1;
      mv[u] = j < b1 ? sval[j] : 0.0;
    }
    const int64_t ahead = j0 + kAhead * 32 * kUnroll;
    // 128 entries: 8 lines of values, 2 of bins (lines that start in
    // the bucket).
    if (lane < 8 && ahead + 16 * lane < b1)
      prefetch_l2(sval + ahead + 16 * lane);
    else if (lane >= 8 && lane < 10 && ahead + 64 * (lane - 8) < b1)
      prefetch_l2(sbin + ahead + 64 * (lane - 8));
    // A round all on one cell is one chain of 32 * kUnroll adds.
    const int key0 = __shfl_sync(kFull, bin[0], 0);
    bool one = key0 >= 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      one = one && bin[u] == key0 && v[u] != 0.0;
    if (__all_sync(kFull, one)) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        reinterpret_cast<double*>(w.pile)[32 * u + lane] = v[u];
      add_pile<16 * kUnroll>(w, key0, lane, carry, carry_key);
      continue;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      accumulate_step(bin[u], v[u], w, lane, carry, carry_key);
  }
  // 16 bytes a lane where the tile starts on 16 bytes; the shared tile
  // is zeroed behind the stores.
  if (pairs) {
    for (int i = lane; i < width / 2; i += 32) {
      reinterpret_cast<double2*>(dst)[i] = a2[i];
      a2[i] = make_double2(0.0, 0.0);
    }
    if ((width & 1) && lane == 0) {
      dst[width - 1] = a[width - 1];
      a[width - 1] = 0.0;
    }
  } else {
    for (int i = lane; i < width; i += 32) {
      dst[i] = a[i];
      a[i] = 0.0;
    }
  }
  __syncwarp();
}

// One (row, tile) task of the accumulate launch.
__device__ __forceinline__ void run_task(
    int64_t row, int tile, bool skip_long, const int64_t* __restrict__ row_ptr,
    const uint16_t* __restrict__ sbin, const double* __restrict__ sval,
    const int* __restrict__ ends, double* __restrict__ out, int64_t n_cols,
    int n_tiles, WarpScratch& w, int lane) {
  const int64_t start = row_ptr[row];
  const int* e = ends + row * n_tiles;
  const int b0 = tile == 0 ? 0 : e[tile - 1], b1 = e[tile];
  if (skip_long && b1 - b0 > kLong) return;     // taken already
  const int64_t t0 = (int64_t)tile * kTile;
  // Rows start on 16 bytes when row * n_cols is even (the base is aligned);
  // tiles are an even number of bins.
  accumulate_tile(sbin, sval, start + b0, start + b1, out + row * n_cols + t0,
                  (int)min((int64_t)kTile, n_cols - t0),
                  ((row * n_cols) & 1) == 0, w, lane);
}

// Persistent warps take tasks until none is left: first, one at a time,
// the long buckets the bucket launch listed (the fleet's chains on bin
// T - 1 and its busiest bins, which then start at once); then the rest
// in runs from a second counter: every row's last tile, then the other
// tiles row by row, skipping the long ones.  A run is a share of what is
// left (guided scheduling: long runs while much is left, single tasks at
// the end), because one counter serves its atomics one after another.  A
// warp asks for its next run while it works on one, and no warp waits for
// another.
__global__ void __launch_bounds__(kThreads, 3)
deposit_accumulate_kernel(const int64_t* __restrict__ row_ptr,
                          const uint16_t* __restrict__ sbin,
                          const double* __restrict__ sval,
                          const int* __restrict__ ends,
                          const int* __restrict__ long_tasks,
                          const unsigned* __restrict__ n_long,
                          unsigned* __restrict__ long_ticket,
                          unsigned long long* __restrict__ ticket,
                          double* __restrict__ out, int64_t n_rows,
                          int64_t n_cols, int n_tiles) {
  __shared__ WarpScratch scratch[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  WarpScratch& w = scratch[warp];
  for (int i = lane; i < kTile / 2; i += 32)
    w.acc[i] = make_double2(0.0, 0.0);
  __syncwarp();
  const unsigned listed = *n_long;
  for (;;) {
    unsigned t = 0;
    if (lane == 0) t = atomicAdd(long_ticket, 1u);
    t = __shfl_sync(kFull, t, 0);
    if (t >= listed) break;
    const int id = long_tasks[t];
    run_task(id / n_tiles, id % n_tiles, false, row_ptr, sbin, sval, ends,
             out, n_cols, n_tiles, w, lane);
  }
  const int64_t n_bulk = n_rows * n_tiles;
  const int64_t share = (int64_t)kGuide * gridDim.x * kWarps;
  int64_t len = min((int64_t)kMaxRun, max((int64_t)1, n_bulk / share));
  unsigned long long next = 0;
  if (lane == 0) next = atomicAdd(ticket, (unsigned long long)len);
  for (;;) {
    const int64_t k0 = (int64_t)__shfl_sync(kFull, next, 0);
    if (k0 >= n_bulk) break;
    const int64_t k1 = min(k0 + len, n_bulk);
    len = min((int64_t)kMaxRun, max((int64_t)1, (n_bulk - k1) / share));
    if (lane == 0) next = atomicAdd(ticket, (unsigned long long)len);
    for (int64_t k = k0; k < k1; ++k)
      run_task(k < n_rows ? k : (k - n_rows) / (n_tiles - 1),
               k < n_rows ? n_tiles - 1 : (int)((k - n_rows) % (n_tiles - 1)),
               true, row_ptr, sbin, sval, ends, out, n_cols, n_tiles, w, lane);
  }
}

}  // namespace

extern "C" int repro_deposit_tile() { return kTile; }
extern "C" int repro_deposit_max_tiles() { return kMaxTiles; }

// out (n_rows, n_cols) f64, every cell written.  scratch: 16 + 10 *
// n_entries + 8 * n_rows * ceil(n_cols / kTile) bytes, 8-byte aligned.
// bucket_warps: warps of a bucket block, 8 or 16, with bucket_warps *
// ceil(n_cols / kTile) int32 counters fitting kMaxSmem.  Returns
// cudaGetLastError() after the launch that failed, or the last one.
extern "C" int repro_deposit(const void* row_ptr, const void* cols,
                             const void* vals, void* out, void* scratch,
                             int64_t n_entries, int64_t n_rows,
                             int64_t n_cols, int bucket_warps, void* stream) {
  if (n_rows <= 0 || n_rows > INT_MAX || n_cols <= 0 || n_entries < 0 ||
      n_entries > INT_MAX || (bucket_warps != 8 && bucket_warps != 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_tiles = (n_cols + kTile - 1) / kTile;
  const size_t smem = sizeof(int) * bucket_warps * n_tiles;
  if (n_tiles > kMaxTiles || smem > kMaxSmem || n_rows * n_tiles > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // scratch: the task counter (u64), the long-bucket count and counter
  // (u32 each) in 16 bytes, then the entries' values, the bucket ends,
  // the long-bucket list and the entries' bins.
  unsigned long long* ticket = static_cast<unsigned long long*>(scratch);
  unsigned* n_long = reinterpret_cast<unsigned*>(ticket + 1);
  unsigned* long_ticket = n_long + 1;
  double* sval = static_cast<double*>(scratch) + 2;
  int* ends = reinterpret_cast<int*>(sval + n_entries);
  int* long_tasks = ends + n_rows * n_tiles;
  uint16_t* sbin = reinterpret_cast<uint16_t*>(long_tasks + n_rows * n_tiles);
  cudaError_t err = cudaMemsetAsync(scratch, 0, 16, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(deposit_bucket_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  deposit_bucket_kernel<<<(unsigned)n_rows, 32 * bucket_warps, smem, s>>>(
      static_cast<const int64_t*>(row_ptr), static_cast<const int64_t*>(cols),
      static_cast<const double*>(vals), sbin, sval, ends, long_tasks, n_long,
      n_cols, (int)n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // Persistent blocks, as many as fit the card at once.
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, deposit_accumulate_kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = std::min<int64_t>(
      (int64_t)sms * std::max(per_sm, 1),
      (n_rows * n_tiles + kWarps - 1) / kWarps);
  deposit_accumulate_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const int64_t*>(row_ptr), sbin, sval, ends, long_tasks,
      n_long, long_ticket, ticket, static_cast<double*>(out), n_rows, n_cols,
      (int)n_tiles);
  return static_cast<int>(cudaGetLastError());
}
