// K6 and K6p: the elastic transform's warp for Hopper (sm_90a), with a plain C interface.
// K6 is described first; K6p, its lane-packed form, below it.
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

// The two taps of one axis at displacement d (K6's live-tap argument): tap t
// is offset floor(d) + t, live if it lies in [-m, m + 1], with its tent.
struct Taps {
  float wt[2];
  int off[2];
  bool live[2];
};

__device__ __forceinline__ Taps taps(float d, int m) {
  Taps a;
  const int o0 = static_cast<int>(floorf(d));
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    a.off[t] = o0 + t;
    a.live[t] = a.off[t] >= -m && a.off[t] <= m + 1;
    a.wt[t] = tent(d, static_cast<float>(a.off[t]));
  }
  return a;
}

// Each channel of one output pixel: for each live row tap the inner sum over
// the live column taps, then acc += wy * inner, as the oracle orders them.
// row[a] + col[k] indexes the source of taps (a, k) in `src`.
__device__ __forceinline__ void sum_taps(const float* src, const Taps& ty, const Taps& tx,
                                         const int (&row)[2], const int (&col)[2], int c,
                                         float* o) {
  for (int ch = 0; ch < c; ++ch) {
    float acc = 0.0f;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      if (!ty.live[a]) continue;
      float inner = 0.0f;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (tx.live[k]) inner = __fadd_rn(inner, __fmul_rn(tx.wt[k], src[row[a] + col[k] + ch]));
      }
      acc = __fadd_rn(acc, __fmul_rn(ty.wt[a], inner));
    }
    o[ch] = acc;
  }
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
    const Taps ty = taps(__fsub_rn(ys[b * hw + p], static_cast<float>(i)), m);
    const Taps tx = taps(__fsub_rn(xs[b * hw + p], static_cast<float>(j)), m);
    int row[2], col[2];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      row[t] = min(max(i + ty.off[t], 0), h - 1) * w * c;
      col[t] = min(max(j + tx.off[t], 0), w - 1) * c;
    }
    sum_taps(img, ty, tx, row, col, c, out + (b * hw + p) * c);
  }
}

// K6p: the lane-packed warp.
//
// Replaces fav_tpu/ops/corruptions_pallas.py:_elastic_kernel_packed (:478),
// which elastic_transform_pallas runs when packed=True and G > 1
// (:545-576). There each image is edge-padded by p = m + 1 to
// wp = W + 2p columns and G = max(1, 128 // wp), lowered to a divisor of B
// (packed_group in fav_tpu_torch/ops/corruptions.py), padded images share
// the TPU's 128 lanes; column windows are rolls by jj + 1, which for an
// output column t <= W - 1 reads t + jj + 1 <= wp - 1, inside its own
// segment, and the pad lanes' outputs are sliced off.
//
// What it computes equals K6 bit for bit given the same coordinates: the
// same live taps, tents, order and separate __fmul_rn/__fadd_rn; a tap's
// source is padded row i + oy + p and lane s*wp + j + ox + p of the tile,
// which hold x[clamp(i + oy), clamp(j + ox)] of image s.
//
// Bound: bytes, the same as K6: the images and coordinates read once, the
// output written once; the padded tile never reaches device memory.
//
// Design: one block per group of G consecutive images. The block builds
// their edge-padded segments side by side, an (H + 2p, G*wp, C) tile, in
// shared memory with clamped loads, so no padded copy goes through device
// memory (the TPU route pads and packs in HBM, :545-576). One thread per
// output pixel of the G images, in device order, so a warp's coordinates
// and outputs are coalesced; a pad lane is never computed or written. The
// tile is 45-62 KB at 32x32x3 (63,504 bytes at severity 3, G = 3), above
// the 48 KB a block gets by default at every severity but 4, so the
// launcher opts in. A GPU has no lanes to fill, so the packing buys
// nothing here; it holds the TPU kernel's segment arithmetic to K6.
__global__ void elastic_warp_packed_kernel(const float* __restrict__ x, const float* __restrict__ ys,
                                           const float* __restrict__ xs, float* __restrict__ out,
                                           int g, int h, int w, int c, int m) {
  extern __shared__ float tile[];
  const int p = m + 1;
  const int hp = h + 2 * p;
  const int wp = w + 2 * p;
  const int gwp = g * wp;
  const int hw = h * w;
  const long long first = static_cast<long long>(blockIdx.x) * g * hw;  // the group's first pixel
  const float* xg = x + first * c;

  // tile element (r, lane = s*wp + q, ch) holds x[s, clamp(r - p), clamp(q - p), ch]
  const int n_tile = hp * gwp * c;
  for (int e = threadIdx.x; e < n_tile; e += blockDim.x) {
    const int pix = e / c;
    const int r = pix / gwp;
    const int lane = pix - r * gwp;
    const int s = lane / wp;
    const int i = min(max(r - p, 0), h - 1);
    const int j = min(max(lane - s * wp - p, 0), w - 1);
    tile[e] = xg[((s * h + i) * w + j) * c + (e - pix * c)];
  }
  __syncthreads();

  for (int q = threadIdx.x; q < g * hw; q += blockDim.x) {
    const int s = q / hw;
    const int r = q - s * hw;
    const int i = r / w;
    const int j = r - i * w;
    const long long px = first + q;
    const Taps ty = taps(__fsub_rn(ys[px], static_cast<float>(i)), m);
    const Taps tx = taps(__fsub_rn(xs[px], static_cast<float>(j)), m);
    int row[2], col[2];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      row[t] = (i + ty.off[t] + p) * gwp * c;  // read only where the tap is live
      col[t] = (s * wp + j + tx.off[t] + p) * c;
    }
    sum_taps(tile, ty, tx, row, col, c, out + px * c);
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

// K6p over batch / g groups of g images. Shared memory per block: the padded
// tile, (h + 2m + 2) g (w + 2m + 2) c floats, above 48 KB at most severities:
// the launcher opts the kernel in to that much (the wrapper keeps it within
// the 227 KB a Hopper block can have).
int fav_elastic_warp_packed(const float* x, const float* ys, const float* xs, float* out, int batch,
                            int g, int h, int w, int c, int m, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || c <= 0) return 0;
  if (g <= 0 || batch % g) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(h + 2 * m + 2) * g * (w + 2 * m + 2) * c * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(elastic_warp_packed_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  elastic_warp_packed_kernel<<<batch / g, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, ys, xs, out, g, h, w, c, m);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
