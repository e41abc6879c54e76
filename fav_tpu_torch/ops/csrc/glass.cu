// K5: glass blur's random resample cascade for Hopper (sm_90a), with a plain C interface.
//
// Replaces fav_tpu/ops/corruptions_pallas.py:_glass_kernel (:295), which
// glass_resample_pallas (:359, unpacked branch :401-417) runs inside
// glass_blur_pallas (:421). Built by fav_tpu_torch/ops/_build.py with plain
// nvcc and bound with ctypes by fav_tpu_torch/ops/corruptions_cuda.py; the
// launcher takes PyTorch's current stream, does not synchronise, allocates
// nothing and returns cudaGetLastError().
//
// What it computes, on an NHWC float32 batch: `passes` = 2 iters passes,
// rows then columns in each round. Pass p gives pixel (b, i, j) the uniform
// u of element b*H*W + i*W + j of Philox draw p (philox.cuh), the code
// min(floor(u k), k - 1) with k = 2m + 1, and the offset d = code - m. A row
// pass moves the pixel's C channels from row clamp(i + d), a column pass
// from column clamp(j + d). The code is formed with the float32 product and
// floor the plain version uses; after that nothing but selection touches a
// value, so the kernel equals glass_resample_plain
// (fav_tpu_torch/ops/corruptions.py) bit for bit.
//
// Bound: bytes. Each image crosses device memory twice (read once, written
// once: 8 bytes an element). The work is a quarter of a Philox call (25
// operations), the uniform map and the code (about 7) per pixel per pass,
// shared over the channels, and an index clamp and a copy per element per
// pass: some 30 operations a pixel a pass, far under the card's ratio of
// operations to bytes.
//
// Design: one block per image, so each pass's neighbours are in the block.
// The image is read into shared memory as it lies (NHWC, one coalesced
// pass), the codes of all passes are drawn into shared memory (one byte a
// pixel a pass: the uniforms never reach device memory), and the passes
// ping-pong between two shared copies with a block barrier between them;
// the last copy is written back coalesced. The TPU kernel's planar
// (nb, C, H, W) blocks served the TPU's lane layout; here the channels stay
// interleaved, so global traffic is a straight copy and a pass reads C
// neighbouring words a pixel (stride C across a warp: no bank conflicts for
// odd C).

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void glass_resample_kernel(const float* __restrict__ x, float* __restrict__ out, int h,
                                      int w, int c, int m, int passes, uint32_t k0, uint32_t k1) {
  extern __shared__ float smem[];
  const int hw = h * w;
  const int d = hw * c;
  float* src = smem;
  float* dst = smem + d;
  unsigned char* codes = reinterpret_cast<unsigned char*>(smem + 2 * d);
  const long long img = blockIdx.x;
  const float* xi = x + img * d;
  float* oi = out + img * d;

  for (int e = threadIdx.x; e < d; e += blockDim.x) src[e] = xi[e];

  // Pixel p of this image is element first + p of every draw; the groups of
  // four that cover it may reach into the neighbouring images.
  const long long first = img * hw;
  const long long g0 = first / 4;
  const int ngroups = static_cast<int>((first + hw - 1) / 4 - g0 + 1);
  const float k = static_cast<float>(2 * m + 1);
  for (int t = threadIdx.x; t < ngroups * passes; t += blockDim.x) {
    const int pass = t / ngroups;
    const long long g = g0 + (t - pass * ngroups);
    const uint4 words = fav::draw_words(g, static_cast<uint32_t>(pass), k0, k1);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long p = 4 * g + j - first;
      if (p < 0 || p >= hw) continue;
      const float u = fav::bits_to_uniform(fav::word(words, j));
      const float code = fminf(floorf(__fmul_rn(u, k)), __fsub_rn(k, 1.0f));
      codes[pass * hw + static_cast<int>(p)] = static_cast<unsigned char>(code);
    }
  }
  __syncthreads();

  for (int pass = 0; pass < passes; ++pass) {
    const unsigned char* pc = codes + pass * hw;
    const bool rows = (pass & 1) == 0;
    for (int p = threadIdx.x; p < hw; p += blockDim.x) {
      const int i = p / w;
      const int j = p - i * w;
      const int off = static_cast<int>(pc[p]) - m;
      const int s = rows ? min(max(i + off, 0), h - 1) * w + j : i * w + min(max(j + off, 0), w - 1);
      for (int ch = 0; ch < c; ++ch) dst[p * c + ch] = src[s * c + ch];
    }
    __syncthreads();
    float* t = src;
    src = dst;
    dst = t;
  }

  for (int e = threadIdx.x; e < d; e += blockDim.x) oi[e] = src[e];
}

}  // namespace

extern "C" {

const char* fav_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Shared memory per block: 2 h w c floats and passes h w code bytes; the
// wrapper keeps it within the 48 KB a block gets without opting in, and m
// within 0..127 so that each code, 0 .. 2m, fits its byte.
int fav_glass_resample(const float* x, float* out, int batch, int h, int w, int c, int m,
                       int passes, uint32_t seed_lo, uint32_t seed_hi, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || c <= 0 || passes <= 0) return 0;
  const size_t smem = 2 * static_cast<size_t>(h) * w * c * sizeof(float) +
                      static_cast<size_t>(passes) * h * w;
  glass_resample_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, out, h, w, c, m, passes, seed_lo, seed_hi);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
