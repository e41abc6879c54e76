// Corruption kernels K1-K4, K8 and the Philox uniform helper for Hopper (sm_90a), with a plain C interface.
//
// Built by fav_tpu_torch/ops/_build.py with plain nvcc into a shared library
// and bound with ctypes by fav_tpu_torch/ops/corruptions_cuda.py. Every
// launcher takes PyTorch's current stream, launches, does not synchronise,
// allocates nothing, and returns cudaGetLastError() so that a refused launch
// reaches the wrapper.
//
// Arithmetic follows the plain PyTorch versions (fav_tpu_torch/ops/
// corruptions.py) operation by operation, but for K1's cosine (below).
// Products and sums go through the __f*_rn intrinsics, which nvcc never
// contracts into FMAs, so each rounds as a separate PyTorch op does;
// logf/expf/cosf/sqrtf are the precise CUDA math library calls that
// PyTorch's own CUDA ops use (no --use_fast_math). K1 takes cospif(2 u) for
// cos(2 pi u): within 1e-5 of its plain version, not exact (see K1).
//
// Random numbers: Philox4x32-10 keyed by the 64-bit seed, counter
// (group lo, group hi, draw, 0) with group = element / 4; word element % 4
// feeds the element (philox.cuh). fav_tpu_torch/ops/random.py computes the
// same words.
//
// Counter base. K1-K3 and the helper take `base`, the group of the field
// their first element is: element e draws from group base + e / 4. A shard
// of a batch whose first image is image r passes base = r * (elements an
// image takes) / 4 and draws exactly those rows of the whole batch's field
// (the wrapper keeps that a whole number of groups); base 0 is the whole
// batch, as before.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

using fav::bits_to_uniform;
using fav::draw_words;
using fav::word;

constexpr int kThreads = 256;
constexpr int kOptInLimit = 227 * 1024;  // the shared memory a Hopper block can opt in to

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
//
// What it computes: clip(x + sigma z), z = sqrt(-2 log u1) cos(2 pi u2), with
// u1 and u2 draws 0 and 1 of the Philox stream, the uniforms bit-equal to
// bits_to_uniform's. Tolerance class: within 1e-5 of the plain version
// (gaussian_noise_plain), not exact: the cosine is cospif(2 u2) (2 u2 is
// exact; cospif needs no Cody-Waite reduction and has no slow path), where
// the plain version takes torch.cos(fl(2 pi) u2); the two angles differ by
// the rounding of fl(2 pi) u2, under 5e-7 rad, so the outputs differ by
// under 5e-7 at sigma 0.18. logf and sqrtf stay the precise calls: __logf's
// absolute error near u1 = 1, through the square root, would pass 1e-5.
//
// Bound: bytes on paper (4 read and 4 written an element: 0.0451 ms at
// (6144, 32, 32, 3) on an H100 80GB HBM3 at 700 W), but on the card its
// instructions bound it: one float4 group a thread with cosf ran 120 SASS
// instructions an element on its hot path (two Philox calls a group of
// four, logf, sqrtf, cosf's reduction, the clip; tools/sass_count.py on
// the built library); this design runs 96 in about a fifth less time, 64%
// of the bound:
//   * cospif(2 u2) in place of cosf(fl(2 pi) u2): no reduction, no local
//     stack frame for cosf's large-argument path;
//   * each thread of the main loop holds kGaussGroups float4 groups of a
//     tile (neighbouring threads on neighbouring groups), loads them first
//     and runs their 2 kGaussGroups Philox chains side by side, so that
//     the chains hide each other's latency and the loads';
//   * indices within a launch are 32-bit where the group count allows (the
//     counter stays 64-bit: base + group).
// The Philox round keys stay in the kernel: ptxas already makes them once a
// trip on the uniform datapath (UIADD3), shared by the trip's calls; keys
// passed in the constant bank instead made ptxas split each 32x32->64
// product into two instructions and ran slower. The uniforms keep
// bits_to_uniform's I2FP conversion, a full-rate ALU instruction on sm_90.
// Groups past the last whole tile, and every group where x or out is not
// 16-byte aligned, take a grid-stride loop of one group a thread, element
// by element where a group is not whole or not aligned.
constexpr int kGaussGroups = 2;  // float4 groups a thread holds in the main loop
constexpr int kGaussTile = kThreads * kGaussGroups;

__device__ __forceinline__ float gaussian_element(float v, uint32_t bits1, uint32_t bits2, float sigma) {
  const float u1 = bits_to_uniform(bits1);
  const float u2 = bits_to_uniform(bits2);
  const float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  const float z = __fmul_rn(r, cospif(__fmul_rn(2.0f, u2)));
  return clip01(__fadd_rn(v, __fmul_rn(sigma, z)));
}

// Index: uint32_t where every group index of the launch, and the grid-stride
// step past the last, stays below 2**31; unsigned long long otherwise.
template <typename Index>
__global__ void __launch_bounds__(kThreads)
    gaussian_kernel(const float* __restrict__ x, float* __restrict__ out, long long n, Index groups,
                    Index tiles, unsigned long long base, uint32_t k0, uint32_t k1, float sigma, bool vec) {
  for (Index t = blockIdx.x; t < tiles; t += gridDim.x) {
    const Index g0 = t * kGaussTile + threadIdx.x;
    float4 v[kGaussGroups];
    uint4 w1[kGaussGroups], w2[kGaussGroups];
#pragma unroll
    for (int j = 0; j < kGaussGroups; ++j) v[j] = reinterpret_cast<const float4*>(x)[g0 + j * kThreads];
#pragma unroll
    for (int j = 0; j < kGaussGroups; ++j) {
      w1[j] = draw_words(base + g0 + j * kThreads, 0u, k0, k1);
      w2[j] = draw_words(base + g0 + j * kThreads, 1u, k0, k1);
    }
#pragma unroll
    for (int j = 0; j < kGaussGroups; ++j) {
      const float4 o = make_float4(gaussian_element(v[j].x, w1[j].x, w2[j].x, sigma),
                                   gaussian_element(v[j].y, w1[j].y, w2[j].y, sigma),
                                   gaussian_element(v[j].z, w1[j].z, w2[j].z, sigma),
                                   gaussian_element(v[j].w, w1[j].w, w2[j].w, sigma));
      reinterpret_cast<float4*>(out)[g0 + j * kThreads] = o;
    }
  }
  const Index stride = static_cast<Index>(gridDim.x) * kThreads;
  for (Index g = tiles * kGaussTile + blockIdx.x * kThreads + threadIdx.x; g < groups; g += stride) {
    float v[4];
    const int m = load_group(x, n, static_cast<long long>(g), vec, v);
    const uint4 w1 = draw_words(base + g, 0u, k0, k1);
    const uint4 w2 = draw_words(base + g, 1u, k0, k1);
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = gaussian_element(v[j], word(w1, j), word(w2, j), sigma);
    store_group(out, static_cast<long long>(g), vec, m, v);
  }
}

// ── K3: impulse (salt and pepper) noise ───────────────────────────────────
// Replaces corruptions_pallas.py:_impulse_kernel (:100).
// Bound: bytes (about 30 operations per element: a quarter Philox call and
// two compares). Same streaming design as K1, one Philox call per float4.
__global__ void impulse_kernel(const float* __restrict__ x, float* __restrict__ out, long long n,
                               long long base, uint32_t k0, uint32_t k1, float salt, float pepper, bool vec) {
  const long long groups = (n + 3) / 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; g < groups;
       g += stride) {
    float v[4];
    const int m = load_group(x, n, g, vec, v);
    const uint4 w = draw_words(base + g, 0u, k0, k1);
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
//
// What it computes: for each element, lam = x c and the uniform u of draw 0;
// the count is the number of log-space CDF partial sums cdf_k, k < k_max,
// that u exceeds (cdf_0 = exp(-lam); log p_k = (log p_{k-1} + log lam) -
// log k; cdf_k = cdf_{k-1} + exp(log p_k)), and the output clip(count / c).
// The log k constants come from the wrapper (log_k[k] = float32(log k)), so
// kernel and plain version subtract the same values, and every sum rounds
// on its own (__f*_rn, precise expf/logf). The TPU kernel runs all k_max -
// 1 terms (53 at severity 3); the partial sums only grow, so once u <=
// cdf_k no later term adds to the count, and this kernel stops there:
// count + 1 terms, about lambda + 1 (7 on average for uniform x at c = 12),
// the function's own minimum.
//
// Bound: operations or bytes, by the data (4 bytes read and 4 written an
// element; a Philox quarter, logf and expf to start, and an expf and three
// sums a term).
//
// Design: a warp-level work queue, so that a warp's cost is the sum of its
// elements' terms over 32 and not the sum over its elements of the slowest
// of 32 lanes. Each warp takes one chunk of kShotChunk elements (the
// wrapper's shot_geometry launches a block per kShotWarps chunks) and
//   1. stages the chunk in shared memory: its lanes read x as float4 rows,
//      make the chunk's Philox draws four elements a call, and store u, lam
//      and log lam, all coalesced and without divergence;
//   2. runs the queue: each lane holds one element's chain and runs
//      kShotTerms terms of it between hand-outs; a lane whose chain has
//      ended writes its result into the chunk's tile, and __ballot_sync /
//      __popc hand the ended lanes the chunk's next elements in lane order;
//   3. writes the chunk's results back as float4 rows.
// A lane reads the log k of its block's kShotTerms terms from a shared
// table as one vector (its term index is a multiple of kShotTerms at a hand-
// out); past k_max the table holds -inf: term k_max is then +inf, its
// partial sum +inf, and no u exceeds it, so the chain ends there with count
// k_max without a bound test, and the count is the number of terms whose
// sum u exceeded. The results for every count, clip(count / c), are a
// shared table too, made once a block.
constexpr int kShotWarps = 8;                   // warps a block
constexpr int kShotPerLane = 16;                // elements a lane's share of a chunk
constexpr int kShotChunk = 32 * kShotPerLane;   // elements a warp stages at once
constexpr int kShotTerms = 4;                   // terms a lane runs between hand-outs
static_assert(kShotTerms % 4 == 0, "a block of terms reads its log k as float4s");

// Floats of a block's shared memory: the log k table (entry k holds
// log(k + 1), k < k_max + kShotTerms) and the result table (k_max + 1),
// each rounded up to 4 floats; then u, lam and log lam of each warp's
// chunk.
__host__ __device__ constexpr int shot_table_floats(int k_max) {
  return ((k_max + kShotTerms + 3) & ~3) + ((k_max + 1 + 3) & ~3);
}
constexpr int kShotWarpFloats = 3 * kShotChunk;

__global__ void __launch_bounds__(kShotWarps * 32)
    shot_kernel(const float* __restrict__ x, float* __restrict__ out, long long n, long long base, uint32_t k0,
                uint32_t k1, float c, int k_max, const float* __restrict__ log_k, bool vec) {
  extern __shared__ __align__(16) float shot_smem[];
  float* table = shot_smem;  // log(k + 1), k + 1 < k_max; -inf beyond
  float* result = table + ((k_max + kShotTerms + 3) & ~3);  // clip(count / c), count <= k_max
  for (int k = threadIdx.x; k < k_max + kShotTerms; k += blockDim.x)
    table[k] = k + 1 < k_max ? log_k[k + 1] : -__int_as_float(0x7f800000);  // -inf
  for (int k = threadIdx.x; k <= k_max; k += blockDim.x)
    result[k] = clip01(__fdiv_rn(static_cast<float>(k), c));
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;  // the lanes before this one
  float* su = shot_smem + shot_table_floats(k_max) + (threadIdx.x >> 5) * kShotWarpFloats;
  float* slam = su + kShotChunk;  // lam, then each element's result
  float* slog = slam + kShotChunk;
  const long long chunk = static_cast<long long>(blockIdx.x) * kShotWarps + (threadIdx.x >> 5);
  if (chunk * kShotChunk < n) {
    const long long g0 = chunk * (kShotChunk / 4);
    const int m = static_cast<int>(n - 4 * g0 < kShotChunk ? n - 4 * g0 : kShotChunk);

    // 1. stage: lane l takes the chunk's groups l, l + 32, ...
    for (int q = lane; 4 * q < m; q += 32) {
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      load_group(x, n, g0 + q, vec, v);
      const uint4 wd = draw_words(base + g0 + q, 0u, k0, k1);
      float u[4], lam[4], log_lam[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        u[j] = bits_to_uniform(word(wd, j));
        lam[j] = __fmul_rn(v[j], c);
        log_lam[j] = logf(fmaxf(lam[j], 1e-30f));
      }
      reinterpret_cast<float4*>(su)[q] = make_float4(u[0], u[1], u[2], u[3]);
      reinterpret_cast<float4*>(slam)[q] = make_float4(lam[0], lam[1], lam[2], lam[3]);
      reinterpret_cast<float4*>(slog)[q] = make_float4(log_lam[0], log_lam[1], log_lam[2], log_lam[3]);
    }
    __syncwarp();

    // 2. the queue: element e's chain is (log_term, cdf) with term index k
    // next; a fresh chain has log_term = -lam, cdf = 0 (0 + exp(-lam) is
    // exp(-lam) exactly) and k = 0. A chain runs on while u exceeds its
    // last partial sum, so all its terms before the last block counted,
    // and its count is k less the block's terms whose sum u did not exceed.
    int e = lane;
    bool live = e < m;
    float u = 0.0f, log_lam = 0.0f, log_term = 0.0f;
    float cdf[kShotTerms] = {};  // the partial sums of the last block
    int k = 0;
    if (live) {
      u = su[e];
      log_term = -slam[e];
      log_lam = slog[e];
    }
    for (int next = 32; next < m + 32;) {  // next - 32 chains have ended
      if (live) {
        float lk[kShotTerms];  // log k of terms k + 1 .. k + kShotTerms
#pragma unroll
        for (int t = 0; t < kShotTerms; t += 4) {
          const float4 v = *reinterpret_cast<const float4*>(table + k + t);
          lk[t] = v.x;
          lk[t + 1] = v.y;
          lk[t + 2] = v.z;
          lk[t + 3] = v.w;
        }
        float sum = cdf[kShotTerms - 1];
#pragma unroll
        for (int t = 0; t < kShotTerms; ++t) {
          sum = __fadd_rn(sum, expf(log_term));
          cdf[t] = sum;
          log_term = __fsub_rn(__fadd_rn(log_term, log_lam), lk[t]);
        }
        k += kShotTerms;
      }
      const bool ended = live && !(u > cdf[kShotTerms - 1]);
      const unsigned mask = __ballot_sync(0xffffffffu, ended);
      if (ended) {
        int count = k;
#pragma unroll
        for (int t = 0; t < kShotTerms; ++t) count -= !(u > cdf[t]);
        slam[e] = result[count];
        e = next + __popc(mask & lower);
        live = e < m;
        if (live) {
          u = su[e];
          log_term = -slam[e];
          log_lam = slog[e];
          cdf[kShotTerms - 1] = 0.0f;
          k = 0;
        }
      }
      next += __popc(mask);
    }
    __syncwarp();

    // 3. write back
    for (int q = lane; 4 * q < m; q += 32) {
      const float4 r = reinterpret_cast<const float4*>(slam)[q];
      const float v[4] = {r.x, r.y, r.z, r.w};
      store_group(out, g0 + q, vec, m - 4 * q < 4 ? m - 4 * q : 4, v);
    }
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

// ── K8: fused corrupt-normalize ───────────────────────────────────────────
// Replaces corruptions_pallas.py:_corrupt_normalize_kernel (:129).
// out = (clip((x - mu) contrast + mu + bright + sigma z) - mean) scale, mu
// the per-image mean, z K1's normal (Box-Muller on Philox draws 0 and 1 of
// the element's group), one clip. With sigma = 0 no draws are made. The
// operations are the plain version's, in its order.
//
// Bound: bytes (about 100 operations per element with noise, 10 without).
//
// Design: one block per image, the image held in registers. The Philox
// groups of four that cover the image, in the flat tensor's stream, are
// its units: thread t holds groups t, t + T, ... (at most kNormGroups, T
// the block's threads, chosen by the wrapper's corrupt_normalize_geometry
// from d and whether it draws), loaded as float4s where the pointers are
// 16-byte aligned, so a warp's loads and stores cover whole sectors. A
// group that straddles two images, the image's first or last where d is
// not a multiple of 4, is loaded and stored element by element, its
// outside elements skipped; on a misaligned base every group goes element
// by element. Each thread draws its groups' normals before the reduction,
// since they depend only on the counter, so that arithmetic hides the
// loads. The block sums the image with warp shuffles, one value a warp in
// shared memory and a single barrier, after which every thread adds the
// warp sums in the same order; then each thread writes its groups.
constexpr int kNormGroups = 4;  // K8: float4 groups a thread holds at most

template <bool kNoise>
__global__ void __launch_bounds__(1024)
    corrupt_normalize_kernel(const float* __restrict__ x, float* __restrict__ out, int d, uint32_t k0,
                             uint32_t k1, float sigma, float bright, float contrast, float mean, float scale,
                             bool vec) {
  __shared__ float warp_sums[32];
  const long long base = static_cast<long long>(blockIdx.x) * d;
  const long long end = base + d;
  const long long g_first = base / 4;
  const int ng = static_cast<int>((end - 1) / 4 - g_first + 1);
  float v[kNormGroups][4];
  float noise[kNormGroups][4];  // sigma z
  float s = 0.0f;
#pragma unroll
  for (int r = 0; r < kNormGroups; ++r) {
    const int k = threadIdx.x + r * blockDim.x;
    const long long g = g_first + k;
    const long long e0 = 4 * g;
#pragma unroll
    for (int j = 0; j < 4; ++j) v[r][j] = 0.0f;
    if (k < ng) {
      if (vec && e0 >= base && e0 + 4 <= end) {
        const float4 q = reinterpret_cast<const float4*>(x)[g];
        v[r][0] = q.x; v[r][1] = q.y; v[r][2] = q.z; v[r][3] = q.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (e0 + j >= base && e0 + j < end) v[r][j] = x[e0 + j];
      }
      if (kNoise) {
        const uint4 w1 = draw_words(g, 0u, k0, k1);
        const uint4 w2 = draw_words(g, 1u, k0, k1);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float u1 = bits_to_uniform(word(w1, j));
          const float u2 = bits_to_uniform(word(w2, j));
          const float rad = sqrtf(__fmul_rn(-2.0f, logf(u1)));
          noise[r][j] = __fmul_rn(sigma, __fmul_rn(rad, cosf(__fmul_rn(6.2831854820251465f, u2))));
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) s = __fadd_rn(s, v[r][j]);  // outside elements are 0
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = s;
  __syncthreads();
  s = 0.0f;
  for (int wp = 0; wp < static_cast<int>(blockDim.x >> 5); ++wp) s = __fadd_rn(s, warp_sums[wp]);
  const float mu = __fdiv_rn(s, static_cast<float>(d));

#pragma unroll
  for (int r = 0; r < kNormGroups; ++r) {
    const int k = threadIdx.x + r * blockDim.x;
    if (k >= ng) continue;
    const long long g = g_first + k;
    const long long e0 = 4 * g;
    float o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float y = __fadd_rn(__fadd_rn(__fmul_rn(__fsub_rn(v[r][j], mu), contrast), mu), bright);
      if (kNoise) y = __fadd_rn(y, noise[r][j]);
      o[j] = __fmul_rn(__fsub_rn(clip01(y), mean), scale);
    }
    if (vec && e0 >= base && e0 + 4 <= end) {
      reinterpret_cast<float4*>(out)[g] = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (e0 + j >= base && e0 + j < end) out[e0 + j] = o[j];
    }
  }
}

// ── Philox uniforms (a helper, no TPU counterpart) ────────────────────────
// Writes draw `draw` of the seed as float32 uniforms in (0, 1], in the
// stream layout above: the words ops/random.py's uniform01 computes. The
// torch ops of elastic, snow, fog, frost and motion blur take their fields
// from here on the card. Bound: bytes (4 written per element, about 29
// operations each). One Philox call per thread, one float4 store.
__global__ void philox_uniform_kernel(float* __restrict__ out, long long n, long long base, uint32_t draw,
                                      uint32_t k0, uint32_t k1, bool vec) {
  const long long groups = (n + 3) / 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; g < groups;
       g += stride) {
    const uint4 w = draw_words(base + g, draw, k0, k1);
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

// `base` (every launcher of a drawing kernel below): the counter base, in
// groups of four elements; negative returns cudaErrorInvalidValue.
int fav_gaussian_noise(const float* x, float* out, long long n, long long base, uint32_t seed_lo,
                       uint32_t seed_hi, float sigma, void* stream) {
  if (n <= 0) return 0;
  if (base < 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = aligned16(x, out);
  const long long groups = (n + 3) / 4;
  const long long tiles = vec ? n / 4 / kGaussTile : 0;  // tiles of whole groups only
  const long long rest = groups - tiles * kGaussTile;
  const long long cap = 1LL << 20;  // the grid-stride loops cover the rest
  long long blocks = tiles > (rest + kThreads - 1) / kThreads ? tiles : (rest + kThreads - 1) / kThreads;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (groups + blocks * kThreads < (1LL << 31)) {
    gaussian_kernel<uint32_t><<<static_cast<int>(blocks), kThreads, 0, st>>>(
        x, out, n, static_cast<uint32_t>(groups), static_cast<uint32_t>(tiles),
        static_cast<unsigned long long>(base), seed_lo, seed_hi, sigma, vec);
  } else {
    gaussian_kernel<unsigned long long><<<static_cast<int>(blocks), kThreads, 0, st>>>(
        x, out, n, static_cast<unsigned long long>(groups), static_cast<unsigned long long>(tiles),
        static_cast<unsigned long long>(base), seed_lo, seed_hi, sigma, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

int fav_impulse_noise(const float* x, float* out, long long n, long long base, uint32_t seed_lo, uint32_t seed_hi,
                      float salt, float pepper, void* stream) {
  if (n <= 0) return 0;
  if (base < 0) return static_cast<int>(cudaErrorInvalidValue);
  impulse_kernel<<<elementwise_blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, n, base, seed_lo, seed_hi, salt, pepper, aligned16(x, out));
  return static_cast<int>(cudaGetLastError());
}

// K2 on `blocks` blocks of kShotWarps warps, a chunk a warp (the wrapper's
// shot_geometry), each with the block's tables and a chunk's staging area a
// warp in shared memory; above 48 KB the launcher opts the kernel in. Too
// few blocks for n, or shared memory past the 227 KB a Hopper block can
// have, returns cudaErrorInvalidValue.
int fav_shot_noise(const float* x, float* out, long long n, long long base, uint32_t seed_lo, uint32_t seed_hi,
                   float c, int k_max, const float* log_k, int blocks, void* stream) {
  if (n <= 0) return 0;
  if (base < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = 4LL * (shot_table_floats(k_max) + kShotWarps * kShotWarpFloats);
  const long long chunks = (n + kShotChunk - 1) / kShotChunk;
  if (k_max < 1 || static_cast<long long>(blocks) * kShotWarps < chunks || smem > kOptInLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(shot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  shot_kernel<<<blocks, kShotWarps * 32, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      x, out, n, base, seed_lo, seed_hi, c, k_max, log_k, aligned16(x, out));
  return static_cast<int>(cudaGetLastError());
}

// d floats of shared memory per block: the wrapper keeps d <= 11264 (44 KB).
int fav_photometric(const float* x, float* out, int batch, int d, float bright, float contrast,
                    void* stream) {
  if (batch <= 0 || d <= 0) return 0;
  const bool use_mean = contrast != 1.0f;
  const size_t smem = use_mean ? static_cast<size_t>(d) * sizeof(float) : 0;
  photometric_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, out, d, bright, contrast, use_mean);
  return static_cast<int>(cudaGetLastError());
}

// K8 on one block of `threads` threads an image (the wrapper's
// corrupt_normalize_geometry): a multiple of 32, at most 1024, with
// threads * kNormGroups at least the groups an image covers, else
// cudaErrorInvalidValue.
int fav_corrupt_normalize(const float* x, float* out, int batch, int d, int threads, uint32_t seed_lo,
                          uint32_t seed_hi, float sigma, float bright, float contrast, float mean, float scale,
                          void* stream) {
  if (batch <= 0 || d <= 0) return 0;
  const int groups = d % 4 ? (d + 2) / 4 + 1 : d / 4;  // the most an image's span of d elements covers
  if (threads <= 0 || threads > 1024 || threads % 32 || threads * kNormGroups < groups)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sigma > 0.0f) {
    corrupt_normalize_kernel<true><<<batch, threads, 0, st>>>(x, out, d, seed_lo, seed_hi, sigma, bright, contrast,
                                                              mean, scale, aligned16(x, out));
  } else {
    corrupt_normalize_kernel<false><<<batch, threads, 0, st>>>(x, out, d, seed_lo, seed_hi, sigma, bright,
                                                               contrast, mean, scale, aligned16(x, out));
  }
  return static_cast<int>(cudaGetLastError());
}

int fav_philox_uniform(float* out, long long n, long long base, uint32_t draw, uint32_t seed_lo, uint32_t seed_hi,
                       void* stream) {
  if (n <= 0) return 0;
  if (base < 0) return static_cast<int>(cudaErrorInvalidValue);
  philox_uniform_kernel<<<elementwise_blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      out, n, base, draw, seed_lo, seed_hi, aligned16(out, out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
