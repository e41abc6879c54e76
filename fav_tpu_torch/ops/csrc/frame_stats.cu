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
// are integers, so each block forms exact sums (Σg, Σlap, Σlap², Σ|g - p|
// in int64) and thread 0 derives the statistics once, in float64:
//   var  = (n Σlap² - (Σlap)²) / n²,  mean = Σg / n,  diff = Σ|g - p| / n,
// each rounded to float32. fav_tpu_torch/ops/signal.py forms the same sums
// and the same divisions, so the kernel equals its plain version bit for
// bit. The wrapper keeps n <= 2**21 so n Σlap² fits int64.
//
// Bound: bytes. It reads two int32 frames (8 bytes a pixel) and does about
// 16 integer operations a pixel. Design: one block per frame; each thread
// strides over the frame's pixels, reading its four neighbours by REFLECT_101
// index arithmetic (no padded copy; the neighbours hit L1/L2); the histogram
// is counted in shared memory in the same pass, with warp-aggregated atomics
// (__match_any_sync: one atomicAdd per distinct value in a warp, so a flat
// frame does not serialise 32 ways); the four sums reduce by warp shuffles,
// then across warps through shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 32;

__device__ __forceinline__ int reflect101(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void frame_stats_kernel(const int* __restrict__ gray, const int* __restrict__ prev,
                                   const int* __restrict__ has_prev, float* __restrict__ stats,
                                   int* __restrict__ hist, int h, int w) {
  __shared__ int bins[256];
  __shared__ long long partial[4][kMaxWarps];
  const int n = h * w;
  const long long base = static_cast<long long>(blockIdx.x) * n;
  const int* g = gray + base;
  const int* p = prev + base;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < 256; i += blockDim.x) bins[i] = 0;
  __syncthreads();

  long long s_g = 0, s_lap = 0, s_lap2 = 0, s_diff = 0;
  // Every thread runs the same number of rounds (blockDim.x is a multiple
  // of 32), so each warp is whole at __match_any_sync.
  for (int start = 0; start < n; start += blockDim.x) {
    const int idx = start + threadIdx.x;
    const bool valid = idx < n;
    int v = 0;
    if (valid) {
      const int r = idx / w;
      const int c = idx - r * w;
      v = g[idx];
      const int lap = g[reflect101(r - 1, h) * w + c] + g[reflect101(r + 1, h) * w + c] +
                      g[r * w + reflect101(c - 1, w)] + g[r * w + reflect101(c + 1, w)] - 4 * v;
      s_g += v;
      s_lap += lap;
      s_lap2 += static_cast<long long>(lap) * lap;
      s_diff += abs(v - p[idx]);
    }
    const bool counted = valid && v >= 0 && v <= 255;
    // lanes that count nothing take keys no gray level has, one per lane
    const unsigned peers = __match_any_sync(0xffffffffu, counted ? v : 256 + lane);
    if (counted && lane == __ffs(peers) - 1) atomicAdd(&bins[v], __popc(peers));
  }

  s_g = warp_sum(s_g);
  s_lap = warp_sum(s_lap);
  s_lap2 = warp_sum(s_lap2);
  s_diff = warp_sum(s_diff);
  if (lane == 0) {
    partial[0][warp] = s_g;
    partial[1][warp] = s_lap;
    partial[2][warp] = s_lap2;
    partial[3][warp] = s_diff;
  }
  __syncthreads();  // also publishes bins[]
  int* hf = hist + static_cast<long long>(blockIdx.x) * 256;
  for (int i = threadIdx.x; i < 256; i += blockDim.x) hf[i] = bins[i];
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    s_g = warp_sum(lane < nwarps ? partial[0][lane] : 0LL);
    s_lap = warp_sum(lane < nwarps ? partial[1][lane] : 0LL);
    s_lap2 = warp_sum(lane < nwarps ? partial[2][lane] : 0LL);
    s_diff = warp_sum(lane < nwarps ? partial[3][lane] : 0LL);
    if (lane == 0) {
      const long long nn = static_cast<long long>(n);
      const long long num = nn * s_lap2 - s_lap * s_lap;
      const double dn = static_cast<double>(nn);
      float* out = stats + static_cast<long long>(blockIdx.x) * 3;
      out[0] = static_cast<float>(__ddiv_rn(static_cast<double>(num), static_cast<double>(nn * nn)));
      out[1] = static_cast<float>(__ddiv_rn(static_cast<double>(s_g), dn));
      out[2] = has_prev[blockIdx.x] ? static_cast<float>(__ddiv_rn(static_cast<double>(s_diff), dn)) : 10.0f;
    }
  }
}

}  // namespace

extern "C" {

const char* fav_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// gray, prev: int32 [batch, h, w]; has_prev: int32 [batch]; stats: float32
// [batch, 3]; hist: int32 [batch, 256]. The wrapper checks 2 <= h, w and
// h w <= 2**21.
int fav_frame_stats(const int* gray, const int* prev, const int* has_prev, float* stats, int* hist,
                    int batch, int h, int w, void* stream) {
  if (batch <= 0) return 0;
  const int threads = h * w >= 16384 ? 1024 : 256;
  frame_stats_kernel<<<batch, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      gray, prev, has_prev, stats, hist, h, w);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
