// K9a and K9b: the AugMix affine's shear passes for Hopper (sm_90a), with a
// plain C interface.
//
// K9a replaces fav_tpu/ops/augment_pallas.py:_shear_rows_kernel (:40) and
// K9b replaces _shear_cols_kernel (:54), both reached through _shear_pass
// (:73) from affine_scanline_pallas (:112): a rotation and shear of an
// AugMix chain image as three shear passes (rows, columns, rows). Built by
// fav_tpu_torch/ops/_build.py with plain nvcc and bound with ctypes by
// fav_tpu_torch/ops/augment_cuda.py; each launcher takes PyTorch's current
// stream, does not synchronise, allocates nothing and returns
// cudaGetLastError().
//
// What they compute, on an NHWC float32 batch x (B, H, W, C) and a shift per
// (image, row) for K9a or per (image, column) for K9b: with d the shift
// clipped to [-m, m - 1], lo = floor(d) and f = d - lo,
//
//   K9a: out[b, y, x, c] = (1 - f) * x[b, y, clamp(x + lo), c] + f * x[b, y, clamp(x + lo + 1), c]
//        d = delta[b, y], clamp to [0, W - 1];
//   K9b: out[b, y, x, c] = (1 - f) * x[b, clamp(y + lo), x, c] + f * x[b, clamp(y + lo + 1), x, c]
//        d = delta[b, x], clamp to [0, H - 1].
//
// This is the TPU kernel's function, not its loop: the Pallas kernel sums
// tent(d - o) * xpad[... o + m ...] over the 2m + 1 offsets o of an
// edge-padded copy, and with d in [-m, m - 1] only the tents at o = lo and
// lo + 1 are nonzero, so the sum is these two taps (the others add exact
// zeros). The clamp of the source index replaces the edge-mode pad, so no
// padded or planar copy is made in device memory. Every operation is a
// separate __fsub_rn/__fmul_rn/__fadd_rn, so nvcc contracts none into an FMA
// and each kernel equals its plain version, shift_rows or shift_cols of
// fav_tpu_torch/ops/augment.py ((1 - f) * a + f * b, three roundings), bit
// for bit.
//
// Bound: bytes. At an AugMix view's chain batch, (768, 32, 32, 3), a pass
// reads the image once (9.4 MB) and writes it once (9.4 MB), plus the 98 KB
// of shifts: 0.0057 ms at 3.35 TB/s. Per element it does a clip (2), a floor
// and f (2), two index adds and clamps (6) and the blend (4): some 14
// operations, a tenth of the bytes' time.
//
// Design: one thread per output pixel, all C channels of it; blocks of
// 256 pixels of one image along x of the grid and the images along y
// (looping when there are more than 65535), so every index is a 32-bit
// product within one image and no 64-bit division is made. The shift, its
// floor and fraction and the two source pixels are computed once and serve
// every channel. A warp covers 32 neighbouring pixels of one row: its
// stores are 32 x C consecutive floats, and its taps lie within the same
// 12 KB image, which L1 and L2 hold.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

// ROWS: shift along x by delta[b, y]; else along y by delta[b, x].
template <bool ROWS>
__global__ void shear_kernel(const float* __restrict__ x, const float* __restrict__ delta,
                             float* __restrict__ out, int batch, int h, int w, int c, int m) {
  const int hw = h * w;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= hw) return;
  const int yi = p / w;
  const int xi = p - yi * w;
  for (long long b = blockIdx.y; b < batch; b += gridDim.y) {
    float d = ROWS ? delta[b * h + yi] : delta[b * w + xi];
    d = fminf(fmaxf(d, static_cast<float>(-m)), static_cast<float>(m - 1));
    const float lo_f = floorf(d);
    const float f = __fsub_rn(d, lo_f);
    const float g = __fsub_rn(1.0f, f);
    const int lo = static_cast<int>(lo_f);
    int p0, p1;  // the two source pixels within the image
    if (ROWS) {
      p0 = yi * w + min(max(xi + lo, 0), w - 1);
      p1 = yi * w + min(max(xi + lo + 1, 0), w - 1);
    } else {
      p0 = min(max(yi + lo, 0), h - 1) * w + xi;
      p1 = min(max(yi + lo + 1, 0), h - 1) * w + xi;
    }
    const float* img = x + b * hw * c;
    float* o = out + (b * hw + p) * c;
    for (int ch = 0; ch < c; ++ch) {
      o[ch] = __fadd_rn(__fmul_rn(g, img[p0 * c + ch]), __fmul_rn(f, img[p1 * c + ch]));
    }
  }
}

template <bool ROWS>
int launch(const float* x, const float* delta, float* out, int batch, int h, int w, int c, int m,
           void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || c <= 0) return 0;
  const dim3 grid((h * w + kThreads - 1) / kThreads, batch < kMaxGridY ? batch : kMaxGridY);
  shear_kernel<ROWS><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(x, delta, out, batch, h, w, c, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* fav_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K9a: delta is (B, H) float32.
int fav_shear_rows(const float* x, const float* delta, float* out, int batch, int h, int w, int c, int m,
                   void* stream) {
  return launch<true>(x, delta, out, batch, h, w, c, m, stream);
}

// K9b: delta is (B, W) float32.
int fav_shear_cols(const float* x, const float* delta, float* out, int batch, int h, int w, int c, int m,
                   void* stream) {
  return launch<false>(x, delta, out, batch, h, w, c, m, stream);
}

}  // extern "C"
