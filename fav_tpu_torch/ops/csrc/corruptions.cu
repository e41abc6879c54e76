// Corruption kernels K1-K4 and the Philox uniform helper for Hopper (sm_90a), with a plain C interface.
//
// Built by fav_tpu_torch/ops/_build.py with plain nvcc into a shared library
// and bound with ctypes by fav_tpu_torch/ops/corruptions_cuda.py. Every
// launcher takes PyTorch's current stream, launches, does not synchronise,
// allocates nothing, and returns cudaGetLastError() so that a refused launch
// reaches the wrapper.
//
// Arithmetic follows the plain PyTorch versions (fav_tpu_torch/ops/
// corruptions.py) operation by operation. Products and sums go through the
// __f*_rn intrinsics, which nvcc never contracts into FMAs, so each rounds as
// a separate PyTorch op does; logf/expf/cosf/sqrtf are the precise CUDA math
// library calls that PyTorch's own CUDA ops use (no --use_fast_math).
//
// Random numbers: Philox4x32-10 keyed by the 64-bit seed, counter
// (group lo, group hi, draw, 0) with group = element / 4; word element % 4
// feeds the element (philox.cuh). fav_tpu_torch/ops/random.py computes the
// same words.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

using fav::bits_to_uniform;
using fav::draw_words;
using fav::word;

constexpr int kThreads = 256;

__device__ __forceinline__ float clip01(float v) { return fminf(fmaxf(v, 0.0f), 1.0f); }

// Loads and stores one group of four elements: one float4 where the group is
// whole and the pointers are 16-byte aligned, element by element otherwise.
__device__ __forceinline__ int load_group(const float* __restrict__ x, long long n, long long g,
                                          bool vec, float v[4]) {
  const long long e0 = 4 * g;
  if (vec && e0 + 4 <= n) {
    const float4 q = reinterpret_cast<const float4*>(x)[g];
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    return 4;
  }
  const int m = static_cast<int>(n - e0 < 4 ? n - e0 : 4);
  for (int j = 0; j < m; ++j) v[j] = x[e0 + j];
  return m;
}

__device__ __forceinline__ void store_group(float* __restrict__ out, long long g, bool vec, int m,
                                            const float v[4]) {
  if (vec && m == 4) {
    reinterpret_cast<float4*>(out)[g] = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
  for (int j = 0; j < m; ++j) out[4 * g + j] = v[j];
}

// ── K1: gaussian noise ─────────────────────────────────────────────────────
// Replaces fav_tpu/ops/corruptions_pallas.py:_gaussian_kernel (:93).
// Bound: bytes. It reads and writes 4 bytes per element and spends about 95
// scalar operations on it (half a Philox call, log, sqrt, cos, the clip),
// under the H100's ratio of float32 operations to device-memory bytes. The
// design keeps that so: the draws are made in registers from a counter, never
// stored, and each thread moves one float4 per Philox pair.
__global__ void gaussian_kernel(const float* __restrict__ x, float* __restrict__ out, long long n,
                                uint32_t k0, uint32_t k1, float sigma, bool vec) {
  const long long groups = (n + 3) / 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; g < groups;
       g += stride) {
    float v[4];
    const int m = load_group(x, n, g, vec, v);
    const uint4 w1 = draw_words(g, 0u, k0, k1);
    const uint4 w2 = draw_words(g, 1u, k0, k1);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float u1 = bits_to_uniform(word(w1, j));
      const float u2 = bits_to_uniform(word(w2, j));
      const float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
      const float z = __fmul_rn(r, cosf(__fmul_rn(6.2831854820251465f, u2)));
      v[j] = clip01(__fadd_rn(v[j], __fmul_rn(sigma, z)));
    }
    store_group(out, g, vec, m, v);
  }
}

// ── K3: impulse (salt and pepper) noise ───────────────────────────────────
// Replaces corruptions_pallas.py:_impulse_kernel (:100).
// Bound: bytes (about 30 operations per element: a quarter Philox call and
// two compares). Same streaming design as K1, one Philox call per float4.
__global__ void impulse_kernel(const float* __restrict__ x, float* __restrict__ out, long long n,
                               uint32_t k0, uint32_t k1, float salt, float pepper, bool vec) {
  const long long groups = (n + 3) / 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; g < groups;
       g += stride) {
    float v[4];
    const int m = load_group(x, n, g, vec, v);
    const uint4 w = draw_words(g, 0u, k0, k1);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float u = bits_to_uniform(word(w, j));
      v[j] = u < salt ? 1.0f : (u > pepper ? 0.0f : v[j]);
    }
    store_group(out, g, vec, m, v);
  }
}

// ── K2: shot (Poisson) noise ──────────────────────────────────────────────
// Replaces corruptions_pallas.py:_shot_kernel (:107).
// Bound: operations or bytes, by the data. The TPU kernel runs all k_max - 1
// = 53 terms of the log-space CDF for every pixel (at severity 3); the
// partial sums only grow, so once u <= cdf_k no later term can add to the
// count, and this kernel stops there: about lambda + 1 = x c + 1 terms (7 on
// average for uniform x at c = 12), one expf each, instead of 53. The count
// is the same as the full loop's. The log k constants come from the wrapper
// (log_k[k] = float32(log k)) so kernel and plain version subtract the same
// values.
__global__ void shot_kernel(const float* __restrict__ x, float* __restrict__ out, long long n,
                            uint32_t k0, uint32_t k1, float c, int k_max,
                            const float* __restrict__ log_k, bool vec) {
  const long long groups = (n + 3) / 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; g < groups;
       g += stride) {
    float v[4];
    const int m = load_group(x, n, g, vec, v);
    const uint4 w = draw_words(g, 0u, k0, k1);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float u = bits_to_uniform(word(w, j));
      const float lam = __fmul_rn(v[j], c);
      const float log_lam = logf(fmaxf(lam, 1e-30f));
      float log_term = -lam;
      float cdf = expf(log_term);
      float count = 0.0f;
      for (int k = 1; k < k_max && u > cdf; ++k) {
        count = __fadd_rn(count, 1.0f);
        log_term = __fsub_rn(__fadd_rn(log_term, log_lam), log_k[k]);
        cdf = __fadd_rn(cdf, expf(log_term));
      }
      if (u > cdf) count = __fadd_rn(count, 1.0f);
      v[j] = clip01(__fdiv_rn(count, c));
    }
    store_group(out, g, vec, m, v);
  }
}

// ── K4: photometric cell (brightness, contrast) ───────────────────────────
// Replaces corruptions_pallas.py:_photometric_kernel (:143).
// Bound: bytes (a handful of operations per element). One block per image:
// with contrast != 1 the image (d floats) is read once into shared memory
// while each thread sums its share in float32; the block reduces the sums
// (warp shuffles, then one value per warp in shared memory) and writes the
// output from shared memory, so x crosses device memory once. With contrast
// == 1 the mean is skipped and each element is clip(x + b), exactly.
__global__ void photometric_kernel(const float* __restrict__ x, float* __restrict__ out, int d,
                                   float bright, float contrast, bool use_mean) {
  extern __shared__ float tile[];
  __shared__ float warp_sums[kThreads / 32];
  const float* xi = x + static_cast<long long>(blockIdx.x) * d;
  float* oi = out + static_cast<long long>(blockIdx.x) * d;
  if (!use_mean) {
    for (int i = threadIdx.x; i < d; i += blockDim.x) oi[i] = clip01(__fadd_rn(xi[i], bright));
    return;
  }
  float s = 0.0f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float v = xi[i];
    tile[i] = v;
    s = __fadd_rn(s, v);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, off));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = s;
  __syncthreads();  // also publishes tile[]
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    s = lane < nwarps ? warp_sums[lane] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, off));
    if (lane == 0) warp_sums[0] = __fdiv_rn(s, static_cast<float>(d));
  }
  __syncthreads();
  const float mu = warp_sums[0];
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float y = __fadd_rn(__fmul_rn(__fsub_rn(tile[i], mu), contrast), mu);
    oi[i] = clip01(__fadd_rn(y, bright));
  }
}

// ── Philox uniforms (a helper, no TPU counterpart) ────────────────────────
// Writes draw `draw` of the seed as float32 uniforms in (0, 1], in the
// stream layout above: the words ops/random.py's uniform01 computes. The
// torch ops of elastic, snow, fog, frost and motion blur take their fields
// from here on the card. Bound: bytes (4 written per element, about 29
// operations each). One Philox call per thread, one float4 store.
__global__ void philox_uniform_kernel(float* __restrict__ out, long long n, uint32_t draw,
                                      uint32_t k0, uint32_t k1, bool vec) {
  const long long groups = (n + 3) / 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; g < groups;
       g += stride) {
    const uint4 w = draw_words(g, draw, k0, k1);
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = bits_to_uniform(word(w, j));
    const int m = static_cast<int>(n - 4 * g < 4 ? n - 4 * g : 4);
    store_group(out, g, vec, m, v);
  }
}

int elementwise_blocks(long long n) {
  const long long groups = (n + 3) / 4;
  long long blocks = (groups + kThreads - 1) / kThreads;
  const long long cap = 1LL << 20;  // the grid-stride loop covers the rest
  if (blocks > cap) blocks = cap;
  return static_cast<int>(blocks < 1 ? 1 : blocks);
}

bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 15u) == 0;
}

}  // namespace

extern "C" {

const char* fav_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int fav_gaussian_noise(const float* x, float* out, long long n, uint32_t seed_lo,
                       uint32_t seed_hi, float sigma, void* stream) {
  if (n <= 0) return 0;
  gaussian_kernel<<<elementwise_blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, n, seed_lo, seed_hi, sigma, aligned16(x, out));
  return static_cast<int>(cudaGetLastError());
}

int fav_impulse_noise(const float* x, float* out, long long n, uint32_t seed_lo, uint32_t seed_hi,
                      float salt, float pepper, void* stream) {
  if (n <= 0) return 0;
  impulse_kernel<<<elementwise_blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, n, seed_lo, seed_hi, salt, pepper, aligned16(x, out));
  return static_cast<int>(cudaGetLastError());
}

int fav_shot_noise(const float* x, float* out, long long n, uint32_t seed_lo, uint32_t seed_hi,
                   float c, int k_max, const float* log_k, void* stream) {
  if (n <= 0) return 0;
  shot_kernel<<<elementwise_blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, n, seed_lo, seed_hi, c, k_max, log_k, aligned16(x, out));
  return static_cast<int>(cudaGetLastError());
}

// d floats of shared memory per block: the wrapper keeps d <= 12288 (48 KB).
int fav_photometric(const float* x, float* out, int batch, int d, float bright, float contrast,
                    void* stream) {
  if (batch <= 0 || d <= 0) return 0;
  const bool use_mean = contrast != 1.0f;
  const size_t smem = use_mean ? static_cast<size_t>(d) * sizeof(float) : 0;
  photometric_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, out, d, bright, contrast, use_mean);
  return static_cast<int>(cudaGetLastError());
}

int fav_philox_uniform(float* out, long long n, uint32_t draw, uint32_t seed_lo, uint32_t seed_hi,
                       void* stream) {
  if (n <= 0) return 0;
  philox_uniform_kernel<<<elementwise_blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      out, n, draw, seed_lo, seed_hi, aligned16(out, out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
