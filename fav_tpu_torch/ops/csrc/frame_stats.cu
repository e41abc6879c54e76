// Frame statistics kernel K7 for Hopper (sm_90a), with a plain C interface.
//
// Replaces fav_tpu/ops/signal_pallas.py:_frame_stats_kernel (:51), and the
// histogram that fav_tpu computes outside its kernel as a one-hot nibble
// matmul (fav_tpu/ops/signal.py:histogram_256, :121).
//
// Per int32 gray frame g (with its previous frame p and a has_prev flag):
//   stats[f] = (variance of the 4-neighbour Laplacian under REFLECT_101,
//               mean of g, mean |g - p| or 10.0 without a previous frame)
//   hist[f]  = the 256-bin histogram of g (values outside 0..255 uncounted)
//
// Everything is an integer until the end: gray, the Laplacian and |g - p|
// are integers, so the kernel forms exact sums (Σg, Σlap, Σlap², Σ|g - p|
// in int64), in any order, and one thread derives the statistics once, in
// float64:
//   var  = (n Σlap² - (Σlap)²) / n²,  mean = Σg / n,  diff = Σ|g - p| / n,
// each rounded to float32. fav_tpu_torch/ops/signal.py forms the same sums
// and the same divisions, so the kernel equals its plain version bit for
// bit. The wrapper keeps n <= 2**21 so n Σlap² fits int64.
//
// Bound: bytes. It reads two int32 frames (8 bytes a pixel); the function
// itself needs 17 integer operations a pixel (the Laplacian 5, the four
// int64 sums 9, the histogram's range test and count 3); at the service's
// bucket of 32 frames of 240x320 that is 19.7 MB, 5.9 us at 3.35 TB/s.
//
// Design. A frame is cut into tiles of `rows` x `cols` pixels; a team of
// threads owns one tile. The wrapper (ops/signal_cuda.py:frame_stats_geometry)
// picks the geometry from (B, H, W):
//
// * Large frames: a team is a whole block, a thread for each column of the
//   tile (up to 512), and a frame is split into row strips (and column
//   strips where a row would not fit in shared memory), enough that
//   B x tiles fills the card: at (32, 240, 320) 16 strips of 15 rows, 512
//   blocks of 320 threads on 132 SMs.
// * Small frames: a team is one warp that owns a whole frame, two warps to
//   a block; the reductions are warp shuffles only and the warp's histogram
//   is its own in shared memory. At (6144, 32, 32) 3072 blocks.
//
// A team stages its tile of g with a one-pixel halo (the rows above and
// below and the columns beside it, clipped to the frame: REFLECT_101 folds
// an edge neighbour back inside, onto a staged pixel) and its tile of p in
// shared memory with 16-byte cp.async copies; each staged run of pixels is
// placed at the same 16-byte phase as in device memory, so any width and
// any base address take 16-byte copies, with at most three 4-byte copies at
// each end. A thread then walks its columns down the tile, carrying the
// pixels above and at the current row, so a pixel costs four reads of
// shared memory (the row below, the left and right neighbours, p) and no
// division. The histogram is counted in shared memory by atomics: where a
// warp's 32 pixels of a row have many equal neighbours, one atomicAdd per
// distinct value (__match_any_sync), so flat and smooth frames do not
// serialise on a bin; otherwise one a pixel, which on a textured row costs
// less than the match.
//
// A frame of several tiles is merged in the same launch: each tile writes
// its four sums and its histogram to a slot of the scratch arrays, fences,
// and takes a ticket from the frame's counter; the tile that takes the last
// ticket sums the slots, writes the frame's statistics and histogram and
// sets the counter back to 0, so the counters (zeroed once by the wrapper)
// are zero again for the next launch and no memset is launched.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBins = 256;
constexpr int kMaxWarps = 32;
constexpr int kSharedLimit = 48 * 1024;  // what a block gets without opting in
// A block's shared memory is all dynamic: this header (the warps' four
// partial int64 sums, then the merge's flag, rounded to 16 bytes), then
// each team's tile. The wrapper's HEADER_INTS (ops/signal_cuda.py) is the
// same, so its count of a block's bytes is the whole of them.
constexpr int kHeaderInts = 4 * kMaxWarps * 2 + 4;

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// The shared-memory layout of one team's tile, in ints; the wrapper's
// tile_ints (ops/signal_cuda.py) computes the same. Each array starts at a
// multiple of 16 bytes and leaves three ints for the 16-byte phase.
struct Layout {
  bool full;    // the tile spans whole rows: g's and p's tiles are one run each
  int g_rows;   // rows of g staged (the tile and its halo, within the frame)
  int g_stride; // ints per staged row of g (column tiles only)
  int p_stride; // ints per staged row of p (column tiles only)
  int g_ints, p_ints, unit_ints;
};

__host__ __device__ inline Layout layout(int h, int w, int rows, int cols) {
  Layout l;
  l.full = cols >= w;
  l.g_rows = imin(rows + 2, h);
  const int g_cols = imin(cols + 2, w);
  l.g_stride = round4(g_cols + 3);
  l.p_stride = round4(cols + 3);
  l.g_ints = l.full ? round4(l.g_rows * w + 3) : l.g_rows * l.g_stride;
  l.p_ints = l.full ? round4(rows * w + 3) : rows * l.p_stride;
  l.unit_ints = l.g_ints + l.p_ints + kBins;
  return l;
}

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The 16-byte phase of a device pointer, in ints.
__device__ __forceinline__ int phase(const int* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(shared_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(int* dst, const int* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(shared_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Starts the copy of `len` ints from src to dst + phase(src) (dst 16-byte
// aligned): 4-byte copies up to src's first 16-byte boundary, 16-byte copies
// of the body, 4-byte copies of the rest; shared among the team's threads.
__device__ __forceinline__ void stage_run(int* dst, const int* src, int len, int t, int team) {
  dst += phase(src);
  const int head = imin((4 - phase(src)) & 3, len);
  const int chunks = (len - head) >> 2;
  const int tail = head + 4 * chunks;
  const int items = head + chunks + (len - tail);
  for (int k = t; k < items; k += team) {
    if (k < head) {
      cp_async4(dst + k, src + k);
    } else if (k < head + chunks) {
      const int e = head + 4 * (k - head);
      cp_async16(dst + e, src + e);
    } else {
      const int e = tail + (k - head - chunks);
      cp_async4(dst + e, src + e);
    }
  }
}

__device__ __forceinline__ void team_sync(int team) {
  if (team == 32) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

__device__ __forceinline__ int reflect101(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// The team's four sums, complete in its thread 0: warp shuffles, then for a
// team of several warps (a whole block) one exchange through `partial`.
__device__ __forceinline__ void team_sum(long long (&v)[4], int team, long long (*partial)[kMaxWarps]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = warp_sum(v[k]);
  if (team == 32) return;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) partial[k][warp] = v[k];
  }
  __syncthreads();
  if (warp == 0) {
    const int nwarps = team >> 5;
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = warp_sum(lane < nwarps ? partial[k][lane] : 0LL);
  }
}

// The statistics of a frame of n pixels from its exact sums, in float64.
__device__ __forceinline__ void finish(float* out, long long n, const long long (&v)[4], int has_prev) {
  const long long num = n * v[2] - v[1] * v[1];
  const double dn = static_cast<double>(n);
  out[0] = static_cast<float>(__ddiv_rn(static_cast<double>(num), static_cast<double>(n * n)));
  out[1] = static_cast<float>(__ddiv_rn(static_cast<double>(v[0]), dn));
  out[2] = has_prev ? static_cast<float>(__ddiv_rn(static_cast<double>(v[3]), dn)) : 10.0f;
}

__global__ void frame_stats_kernel(const int* __restrict__ gray, const int* __restrict__ prev,
                                   const int* __restrict__ has_prev, float* __restrict__ stats,
                                   int* __restrict__ hist, long long* __restrict__ part_sums,
                                   int* __restrict__ part_hist, int* __restrict__ tickets, int batch, int h,
                                   int w, int rows, int cols, int team) {
  extern __shared__ __align__(16) int smem[];
  auto* partial = reinterpret_cast<long long (*)[kMaxWarps]>(smem);
  int& last = smem[4 * kMaxWarps * 2];

  const int units = blockDim.x / team;
  const int unit = threadIdx.x / team;
  const int t = threadIdx.x - unit * team;
  const int col_tiles = (w + cols - 1) / cols;
  const int tiles = ((h + rows - 1) / rows) * col_tiles;
  long long frame;
  int tile;
  if (tiles == 1) {
    frame = static_cast<long long>(blockIdx.x) * units + unit;
    tile = 0;
  } else {  // one team of blockDim.x threads a block
    frame = blockIdx.x / tiles;
    tile = blockIdx.x - static_cast<int>(frame) * tiles;
  }
  if (frame >= batch) return;  // only a spare warp of the last block: its syncs are its own

  const Layout l = layout(h, w, rows, cols);
  int* sg = smem + kHeaderInts + unit * l.unit_ints;
  int* sp = sg + l.g_ints;
  int* bins = sp + l.p_ints;
  const long long n = static_cast<long long>(h) * w;
  const int* g = gray + frame * n;
  const int* p = prev + frame * n;
  const int r0 = (tile / col_tiles) * rows;
  const int r1 = imin(r0 + rows, h);
  const int c0 = (tile - (tile / col_tiles) * col_tiles) * cols;
  const int c1 = imin(c0 + cols, w);
  const int glo = r0 > 0 ? r0 - 1 : 0;  // the staged rows and columns of g: the tile and its halo
  const int ghi = imin(r1, h - 1);
  const int gclo = c0 > 0 ? c0 - 1 : 0;
  const int gchi = imin(c1, w - 1);

  for (int i = t; i < kBins; i += team) bins[i] = 0;
  if (l.full) {
    stage_run(sg, g + static_cast<long long>(glo) * w, (ghi - glo + 1) * w, t, team);
    stage_run(sp, p + static_cast<long long>(r0) * w, (r1 - r0) * w, t, team);
  } else {
    for (int r = glo; r <= ghi; ++r)
      stage_run(sg + (r - glo) * l.g_stride, g + static_cast<long long>(r) * w + gclo, gchi - gclo + 1, t, team);
    for (int r = r0; r < r1; ++r)
      stage_run(sp + (r - r0) * l.p_stride, p + static_cast<long long>(r) * w + c0, c1 - c0, t, team);
  }
  cp_async_wait_all();
  team_sync(team);

  // where staged row i (of g from glo, of p from r0) begins: one run at the
  // phase of its first pixel, or a row of its own at that row's phase
  const int g_ph = phase(g + static_cast<long long>(glo) * w + gclo);
  const int p_ph = phase(p + static_cast<long long>(r0) * w + c0);
  const int g_stride = l.full ? w : l.g_stride;
  const int p_stride = l.full ? w : l.p_stride;
  auto g_row = [&](int i) { return sg + i * g_stride + (l.full ? g_ph : (g_ph + i * w) & 3); };
  auto p_row = [&](int i) { return sp + i * p_stride + (l.full ? p_ph : (p_ph + i * w) & 3); };

  // thread t owns tile columns t, t + team, ... and walks each down the
  // tile's rows, carrying the column's pixels above and at the current row:
  // a pixel costs one new read of g for the row below, two for its left and
  // right neighbours and one of p
  const int tw = c1 - c0;
  const int lane = threadIdx.x & 31;
  long long sums[4] = {0, 0, 0, 0};  // Σg, Σlap, Σlap², Σ|g - p|
  // every thread of a team runs the same rounds (team is a multiple of 32),
  // so each warp is whole at its ballots and matches
  for (int cb = 0; cb < tw; cb += team) {
    const int c = cb + t;
    const bool col = c < tw;
    const int gc = c0 + (col ? c : 0);
    const int jc = gc - gclo;
    const int jl = reflect101(gc - 1, w) - gclo;
    const int jr = reflect101(gc + 1, w) - gclo;
    int up = g_row(reflect101(r0 - 1, h) - glo)[jc];
    int mid = g_row(r0 - glo)[jc];
#pragma unroll 4
    for (int r = r0; r < r1; ++r) {
      const int* row = g_row(r - glo);
      const int down = g_row(reflect101(r + 1, h) - glo)[jc];
      const int v = mid;
      if (col) {
        const int lap = up + down + row[jl] + row[jr] - 4 * v;
        sums[0] += v;
        sums[1] += lap;
        sums[2] += static_cast<long long>(lap) * lap;
        sums[3] += abs(v - p_row(r - r0)[c]);
      }
      up = mid;
      mid = down;
      const bool counted = col && v >= 0 && v <= 255;
      // a warp with many equal neighbours (a flat or smooth stretch) adds once
      // per distinct value (__match_any_sync), so it does not serialise on a
      // bin; any other warp adds pixel by pixel
      const int left = __shfl_up_sync(0xffffffffu, v, 1);
      const unsigned same = __ballot_sync(0xffffffffu, counted && lane > 0 && left == v);
      if (__popc(same) >= 8) {
        // lanes that count nothing take keys no gray level has, one per lane
        const unsigned peers = __match_any_sync(0xffffffffu, counted ? v : 256 + lane);
        if (counted && lane == __ffs(peers) - 1) atomicAdd(&bins[v], __popc(peers));
      } else if (counted) {
        atomicAdd(&bins[v], 1);
      }
    }
  }

  team_sum(sums, team, partial);
  team_sync(team);  // publishes bins[]

  if (tiles == 1) {
    int* hf = hist + frame * kBins;
    for (int i = t; i < kBins; i += team) hf[i] = bins[i];
    if (t == 0) finish(stats + frame * 3, n, sums, has_prev[frame]);
    return;
  }

  // several tiles a frame (team == blockDim.x): this tile's slot, a ticket,
  // and the last tile of the frame merges every slot
  const long long slot = frame * tiles + tile;
  for (int i = t; i < kBins; i += team) part_hist[slot * kBins + i] = bins[i];
  if (t == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) part_sums[slot * 4 + k] = sums[k];
  }
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(&tickets[frame], 1) == tiles - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const long long first = frame * tiles;
  for (int i = t; i < kBins; i += team) {
    int count = 0;
    for (int s = 0; s < tiles; ++s) count += __ldcg(&part_hist[(first + s) * kBins + i]);
    hist[frame * kBins + i] = count;
  }
  long long total[4] = {0, 0, 0, 0};
  for (int s = t; s < tiles; s += team) {
#pragma unroll
    for (int k = 0; k < 4; ++k) total[k] += __ldcg(&part_sums[(first + s) * 4 + k]);
  }
  team_sum(total, team, partial);
  if (t == 0) {
    finish(stats + frame * 3, n, total, has_prev[frame]);
    tickets[frame] = 0;
  }
}

}  // namespace

extern "C" {

const char* fav_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// gray, prev: int32 [batch, h, w]; has_prev: int32 [batch]; stats: float32
// [batch, 3]; hist: int32 [batch, 256]. The geometry (tile rows and columns,
// teams a block, threads a team) comes from the wrapper's
// frame_stats_geometry; the shared bytes follow from it (the header and
// `units` tiles of layout()). With several tiles a frame, part_sums (int64
// [batch, tiles, 4]) and part_hist (int32 [batch, tiles, 256]) are scratch
// and tickets (int32 [batch]) must hold zeros, which the launch leaves
// there. The wrapper checks 2 <= h, w and h w <= 2**21; a geometry the
// kernel does not take, or whose shared memory passes 48 KB, returns
// cudaErrorInvalidValue.
int fav_frame_stats(const int* gray, const int* prev, const int* has_prev, float* stats, int* hist,
                    long long* part_sums, int* part_hist, int* tickets, int batch, int h, int w, int rows,
                    int cols, int units, int team, void* stream) {
  if (batch <= 0) return 0;
  const int tiles = ((h + rows - 1) / rows) * ((w + cols - 1) / cols);
  const Layout l = layout(h, w, rows, cols);
  const long long smem = (kHeaderInts + static_cast<long long>(units) * l.unit_ints) * 4;
  const bool ok = rows >= 1 && rows <= h && cols >= 1 && cols <= w && team >= 32 && team % 32 == 0 &&
                  units >= 1 && units * team <= 1024 && (units == 1 || team == 32) &&
                  (tiles == 1 || (units == 1 && part_sums && part_hist && tickets)) && smem <= kSharedLimit;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = tiles == 1 ? (batch + units - 1) / units : static_cast<long long>(batch) * tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  frame_stats_kernel<<<static_cast<unsigned>(blocks), units * team, static_cast<size_t>(smem),
                       static_cast<cudaStream_t>(stream)>>>(gray, prev, has_prev, stats, hist, part_sums, part_hist,
                                                            tickets, batch, h, w, rows, cols, team);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
