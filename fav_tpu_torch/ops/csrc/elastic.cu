// K6: the elastic transform's warp for Hopper (sm_90a), with a plain C interface.
//
// Replaces fav_tpu/ops/corruptions_pallas.py:_elastic_kernel (:441), which
// elastic_transform_pallas (:518, unpacked branch :579-595) runs after the
// displacement fields are made. Built by fav_tpu_torch/ops/_build.py with
// plain nvcc and bound with ctypes by fav_tpu_torch/ops/corruptions_cuda.py;
// the launcher takes PyTorch's current stream, does not synchronise,
// allocates nothing and returns cudaGetLastError().
//
// What it computes, on an NHWC float32 batch x and the clamped sample
// coordinates ys, xs (B, H, W): with dy = ys - i, dx = xs - j (|dy|, |dx|
// <= m) and tent(t) = max(0, 1 - |t|),
//
//   out[b, i, j, c] = sum over oy in [-m, m+1] of tent(dy - oy) *
//                     (sum over ox in [-m, m+1] of tent(dx - ox) *
//                      x[b, clamp(i + oy), clamp(j + ox), c])
//
// the bilinear warp as a tent-weighted sum of (2m+2)^2 shifted copies. The
// tent of offset o is zero unless |d - o| < 1, and the rounded difference
// keeps that (1 is a float), so only o = floor(d) and floor(d) + 1 can be
// nonzero on each axis: the kernel sums those taps of the 2m+2, skipping one
// that falls outside [-m, m+1] as the full sum leaves it out. The others add
// exact zeros (finite x, a sum that starts at +0), so the result is the full
// sum's bit for bit. The live taps run in the oracle's order
// (corruptions.py:311-321, and the Pallas kernel's :467-475): for each oy the
// inner sum over ox, then acc += wy * inner. Every product and sum is a
// separate __fmul_rn/__fadd_rn (nvcc contracts none into an FMA), so the
// kernel equals its plain version elastic_from_fields
// (fav_tpu_torch/ops/corruptions.py), which sums all the taps, bit for bit.
//
// Bound: bytes. At (6144, 32, 32, 3) it reads 75.5 MB of image and 50.3 MB
// of coordinates and writes 75.5 MB (0.060 ms at 3.35 TB/s); per pixel it
// does two differences and two floors, four tents of 4 operations and, for
// each of C channels, at most four multiply-adds and two weighted adds:
// some 56 operations at C = 3, a tenth of the bytes' time.
//
// Design: one block per image. The image is read once into shared memory
// (12 KB at 32x32x3), and the edge padding of the TPU kernel becomes a
// clamp of the row and column index, so no padded copy is made in device
// memory. A thread owns one output pixel: its two row and two column taps,
// their tents and clamped indices stay in registers and serve every
// channel; a warp covers neighbouring pixels of one row, so its
// shared-memory reads are nearly consecutive pixels (stride C words, no
// bank conflicts for odd C).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float tent(float d, float o) {
  return fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(d, o))), 0.0f);
}

__global__ void elastic_warp_kernel(const float* __restrict__ x, const float* __restrict__ ys,
                                    const float* __restrict__ xs, float* __restrict__ out, int h,
                                    int w, int c, int m) {
  extern __shared__ float img[];
  const int hw = h * w;
  const int d = hw * c;
  const long long b = blockIdx.x;
  const float* xi = x + b * d;
  for (int e = threadIdx.x; e < d; e += blockDim.x) img[e] = xi[e];
  __syncthreads();

  for (int p = threadIdx.x; p < hw; p += blockDim.x) {
    const int i = p / w;
    const int j = p - i * w;
    const float dy = __fsub_rn(ys[b * hw + p], static_cast<float>(i));
    const float dx = __fsub_rn(xs[b * hw + p], static_cast<float>(j));
    const int oy0 = static_cast<int>(floorf(dy));
    const int ox0 = static_cast<int>(floorf(dx));
    float wy[2], wx[2];
    int row[2], col[2];
    bool live_y[2], live_x[2];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int oy = oy0 + t;
      const int ox = ox0 + t;
      live_y[t] = oy >= -m && oy <= m + 1;
      live_x[t] = ox >= -m && ox <= m + 1;
      wy[t] = tent(dy, static_cast<float>(oy));
      wx[t] = tent(dx, static_cast<float>(ox));
      row[t] = min(max(i + oy, 0), h - 1) * w * c;
      col[t] = min(max(j + ox, 0), w - 1) * c;
    }
    float* o = out + (b * hw + p) * c;
    for (int ch = 0; ch < c; ++ch) {
      float acc = 0.0f;
#pragma unroll
      for (int ty = 0; ty < 2; ++ty) {
        if (!live_y[ty]) continue;
        float inner = 0.0f;
#pragma unroll
        for (int tx = 0; tx < 2; ++tx) {
          if (live_x[tx]) inner = __fadd_rn(inner, __fmul_rn(wx[tx], img[row[ty] + col[tx] + ch]));
        }
        acc = __fadd_rn(acc, __fmul_rn(wy[ty], inner));
      }
      o[ch] = acc;
    }
  }
}

}  // namespace

extern "C" {

const char* fav_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// h w c floats of shared memory per block, which the wrapper keeps within
// the 48 KB a block gets without opting in.
int fav_elastic_warp(const float* x, const float* ys, const float* xs, float* out, int batch, int h,
                     int w, int c, int m, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || c <= 0) return 0;
  const size_t smem = static_cast<size_t>(h) * w * c * sizeof(float);
  elastic_warp_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(x, ys, xs, out,
                                                                                     h, w, c, m);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
