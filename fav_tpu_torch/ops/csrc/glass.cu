// K5 and K5p: glass blur's random resample cascade for Hopper (sm_90a), with a plain C
// interface. K5 is described first; K5p, its lane-packed form, below it.
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
// Design: the cascade resolved into one gather. Pass p's output at (i, j)
// comes from pass p - 1's output at one position, which depends only on
// pass p's code at (i, j); so the final source of a pixel is found by
// walking the passes backwards through the codes,
//
//   (i, j) = the output pixel
//   for p = passes - 1 down to 0:
//     column pass: j = clamp(j + code_p[i, j] - m)
//     row pass:    i = clamp(i + code_p[i, j] - m)
//   out[b, i0, j0, :] = x[b, i, j, :]
//
// and each channel moves once, not once a pass. Still pure selection, so
// still bit-equal to the plain version. One block per image: thread 0
// starts a 1-D bulk copy (cp.async.bulk, bulk_copy.cuh) of the image into
// shared memory, at its 16-byte phase so any base address works; while it
// flies the block draws the codes of every pass into shared memory, one
// byte a pixel a pass (6 KB at 32x32 and 6 passes), four to a 32-bit store
// where the image's pixels fill whole Philox groups; the block waits once,
// each thread chases its pixels (row and column found once a pixel, no
// division a pass) and gathers them into an output tile, and one bulk copy
// writes the tile back, so the stores cover whole sectors although a pixel
// is 12 bytes. No block barrier between passes and no second copy of the
// image; the shared traffic is the image read once and written once. What
// is left is the Philox work (passes x H W / 4 calls an image).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"
#include "philox.cuh"

namespace {

constexpr int kThreads = 128;  // K5: threads a block (one image)
constexpr int kPackedThreads = 512;  // K5p: threads a block (one group), two blocks an SM
constexpr int kOptInLimit = 227 * 1024;  // the shared memory a Hopper block can opt in to

// The code byte of every pass of pixels first .. first + n - 1 (element
// indices of each draw) into codes[pass * n + q], q = pixel - first. The
// groups of four that cover the range may reach into neighbouring images;
// where they do not (first and n multiples of 4), each group's four codes
// go out as one 32-bit store.
__device__ __forceinline__ void draw_codes(unsigned char* codes, long long first, int n, int m,
                                           int passes, uint32_t k0, uint32_t k1) {
  const long long g0 = first / 4;
  const int ngroups = static_cast<int>((first + n - 1) / 4 - g0 + 1);
  const float k = static_cast<float>(2 * m + 1);
  const bool whole = ((first | n) & 3) == 0;
  for (int pass = 0; pass < passes; ++pass) {
    unsigned char* pc = codes + pass * n;
    for (int t = threadIdx.x; t < ngroups; t += blockDim.x) {
      const long long g = g0 + t;
      const uint4 words = fav::draw_words(g, static_cast<uint32_t>(pass), k0, k1);
      uint32_t packed = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float u = fav::bits_to_uniform(fav::word(words, j));
        const uint32_t code = static_cast<uint32_t>(fminf(floorf(__fmul_rn(u, k)), __fsub_rn(k, 1.0f)));
        packed |= code << (8 * j);
        const long long q = 4 * g + j - first;
        if (!whole && q >= 0 && q < n) pc[q] = static_cast<unsigned char>(code);
      }
      if (whole) reinterpret_cast<uint32_t*>(pc)[t] = packed;
    }
  }
}

// K5: one block per image; shared memory holds the barrier (16 bytes), the
// input and output tiles (tile_floats = round4(h w c + 3) each) and the
// codes (passes h w bytes).
__global__ void __launch_bounds__(kThreads) glass_resample_kernel(const float* __restrict__ x,
                                                                  float* __restrict__ out, int h, int w,
                                                                  int c, int m, int passes,
                                                                  int tile_floats, uint32_t k0,
                                                                  uint32_t k1) {
  extern __shared__ __align__(128) unsigned char chase_smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(chase_smem);
  float* in_tile = reinterpret_cast<float*>(chase_smem + 16);
  float* out_tile = in_tile + tile_floats;
  unsigned char* codes = reinterpret_cast<unsigned char*>(out_tile + tile_floats);
  const int hw = h * w;
  const int d = hw * c;
  const long long img = blockIdx.x;
  const float* xi = x + img * d;
  float* oi = out + img * d;

  if (threadIdx.x == 0) fav::mbar_init(bar);
  __syncthreads();
  const float* src = in_tile + fav::bulk_load(in_tile, bar, xi, d);
  // pixel q of this image is element img * hw + q of every draw
  draw_codes(codes, img * hw, hw, m, passes, k0, k1);
  fav::mbar_wait(bar, 0);
  __syncthreads();  // the codes, and the tile's head and tail

  float* dst = out_tile + fav::phase16(oi);
  for (int q = threadIdx.x; q < hw; q += blockDim.x) {
    int i = q / w;
    int j = q - i * w;
    for (int pass = passes - 1; pass >= 0; --pass) {
      const int off = static_cast<int>(codes[pass * hw + i * w + j]) - m;
      if (pass & 1) {
        j = min(max(j + off, 0), w - 1);
      } else {
        i = min(max(i + off, 0), h - 1);
      }
    }
    const float* from = src + (i * w + j) * c;
    float* to = dst + q * c;
    for (int ch = 0; ch < c; ++ch) to[ch] = from[ch];
  }
  fav::fence_shared_for_bulk();
  __syncthreads();
  fav::bulk_store(out_tile, oi, d);
  if (threadIdx.x == 0) fav::bulk_store_wait_all();
}

// K5p: the lane-packed cascade.
//
// Replaces fav_tpu/ops/corruptions_pallas.py:_glass_kernel_packed (:319),
// which glass_resample_pallas runs when packed=True and G > 1 (:368-399).
// G = max(1, 128 // W) lowered to a divisor of B (packed_group in
// fav_tpu_torch/ops/corruptions.py) puts G images side by side along a row
// of the TPU's 128 lanes: one (H, G*W) row block holds G images. Each row
// pass is unchanged; a column pass clips the offset per lane,
// d_eff = clip(code - m, -j, W - 1 - j) for lane-local column j, so a lane
// reads inside its own image.
//
// What it computes equals K5 bit for bit: pixel (b, i, j) of pass p takes
// element b*H*W + i*W + j of Philox draw p, as in K5, and clip(code - m, -j,
// W - 1 - j) + j is clamp(j + code - m, 0, W - 1). On the TPU the two arms
// draw differently: the hardware PRNG is seeded per grid step
// (corruptions_pallas.py:333) and a packed step covers other pixels than an
// unpacked one. Here the draws follow the pixel, so packing changes no bit.
//
// Bound: bytes, the same as K5 (each image read once and written once).
//
// Design: K5's backward chase in packed coordinates. One block per group
// of G consecutive images. They lie one after another in device memory, so
// one 1-D bulk copy (bulk_copy.cuh, at the group's 16-byte phase) brings
// the group into shared memory as it lies, with no pack loop and no
// division per element; while it flies the block draws the codes of every
// pass of the group's G H W pixels (draw_codes). After one wait each thread
// chases its pixels back through the passes, a row pass clamping i and a
// column pass taking the TPU kernel's clipped step
// j += clip(code - m, -j, W - 1 - j), stepping from pixel to pixel by fixed
// image, row and column increments (no division), and writes each pixel's
// source into a table of 16-bit group pixel indices. After one barrier the
// threads write the group's output in device order as float4s, each
// element gathered from the tile through the table, so a warp's stores
// cover whole sectors. Shared memory holds the tile, the codes and the
// table, no output tile and no ping-pong pair: 80 KB at G = 4, 32x32x3 and
// 6 passes, so two blocks share an SM and one block's copy and draws
// overlap the other's chase. The table costs a third block an SM, but
// without it each float4 would chase its one or two pixels itself, 1.5
// times as many chases at C = 3. The wrapper (glass_packed_shared_bytes)
// keeps a block within the 227 KB a Hopper block can have; the launcher
// opts in above 48 KB.
//
// The source of pixel (i, j) of the image starting at group pixel img: the
// group pixel its value comes from after the 2 rounds passes.
__device__ __forceinline__ int chase_packed(const unsigned char* codes, int n, int img, int i, int j,
                                            int h, int w, int m, int rounds) {
  for (int t = rounds - 1; t >= 0; --t) {
    const int off_col = static_cast<int>(codes[(2 * t + 1) * n + img + i * w + j]) - m;
    j += min(max(off_col, -j), w - 1 - j);  // d_eff: the lane stays in its own image
    const int off_row = static_cast<int>(codes[2 * t * n + img + i * w + j]) - m;
    i = min(max(i + off_row, 0), h - 1);
  }
  return img + i * w + j;
}

// Shared memory of K5p: the barrier (16 bytes), the tile of tile_floats
// floats, the codes (passes n bytes, rounded up to 16) and the table (n
// 16-bit indices).
__host__ __device__ constexpr long long packed_codes_bytes(long long n, int passes) {
  return (passes * n + 15) & ~15LL;
}

__global__ void __launch_bounds__(kPackedThreads, 2)
    glass_resample_packed_kernel(const float* __restrict__ x, float* __restrict__ out, int g, int h, int w,
                                 int c, int m, int rounds, int tile_floats, uint32_t k0, uint32_t k1) {
  extern __shared__ __align__(128) unsigned char packed_smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(packed_smem);
  float* in_tile = reinterpret_cast<float*>(packed_smem + 16);
  unsigned char* codes = reinterpret_cast<unsigned char*>(in_tile + tile_floats);
  const int hw = h * w;
  const int n = g * hw;  // pixels of the group
  const int d = n * c;   // floats of the group
  unsigned short* table = reinterpret_cast<unsigned short*>(codes + packed_codes_bytes(n, 2 * rounds));
  const long long first = static_cast<long long>(blockIdx.x) * n;  // the group's first pixel
  float* og = out + first * c;

  if (threadIdx.x == 0) fav::mbar_init(bar);
  __syncthreads();
  const float* tile = in_tile + fav::bulk_load(in_tile, bar, x + first * c, d);
  draw_codes(codes, first, n, m, 2 * rounds, k0, k1);
  fav::mbar_wait(bar, 0);
  __syncthreads();  // the codes, and the tile's head and tail

  // pixel q = t, t + T, ... (image start img, row i, column j), T = blockDim.x
  const int step = blockDim.x;
  int img = threadIdx.x / hw * hw;
  int i = (threadIdx.x - img) / w;
  int j = threadIdx.x - img - i * w;
  const int dimg = step / hw * hw;
  const int di = (step - dimg) / w;
  const int dj = step - dimg - di * w;
  for (int q = threadIdx.x; q < n; q += step) {
    table[q] = static_cast<unsigned short>(chase_packed(codes, n, img, i, j, h, w, m, rounds));
    img += dimg;
    i += di;
    j += dj;
    if (j >= w) {
      j -= w;
      ++i;
    }
    if (i >= h) {
      i -= h;
      img += hw;
    }
  }
  __syncthreads();

  // the output in device order: head floats up to og's first 16-byte
  // boundary, a body of float4s, a tail of at most three floats
  const int head = min((4 - fav::phase16(og)) & 3, d);
  const int quads = (d - head) >> 2;
  for (int f = threadIdx.x; f < quads; f += step) {
    const int e = head + 4 * f;
    int q = e / c;
    int ch = e - q * c;
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k > 0 && ++ch == c) {
        ch = 0;
        ++q;
      }
      v[k] = tile[static_cast<int>(table[q]) * c + ch];
    }
    reinterpret_cast<float4*>(og + e)[0] = make_float4(v[0], v[1], v[2], v[3]);
  }
  const int rest = d - 4 * quads;  // head and tail
  for (int r = threadIdx.x; r < rest; r += step) {
    const int e = r < head ? r : 4 * quads + r;
    const int q = e / c;
    og[e] = tile[static_cast<int>(table[q]) * c + (e - q * c)];
  }
}

}  // namespace

extern "C" {

const char* fav_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K5, one block per image. Shared memory per block: 16 bytes of barrier,
// two tiles of round4(h w c + 3) floats and passes h w code bytes, which
// the wrapper (glass_shared_bytes) keeps within the 48 KB a block gets
// without opting in; m within 0..127 so that each code, 0 .. 2m, fits its
// byte.
int fav_glass_resample(const float* x, float* out, int batch, int h, int w, int c, int m,
                       int passes, uint32_t seed_lo, uint32_t seed_hi, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || c <= 0 || passes <= 0) return 0;
  const long long tile_floats = (static_cast<long long>(h) * w * c + 3 + 3) & ~3LL;
  const long long smem = 16 + 2 * tile_floats * 4 + static_cast<long long>(passes) * h * w;
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  glass_resample_kernel<<<batch, kThreads, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      x, out, h, w, c, m, passes, static_cast<int>(tile_floats), seed_lo, seed_hi);
  return static_cast<int>(cudaGetLastError());
}

// K5p over batch / g groups of g images, one block a group. Shared memory
// per block: 16 bytes of barrier, the group's tile of round4(g h w c + 3)
// floats, passes g h w code bytes rounded up to 16 and g h w 16-bit table
// entries (the wrapper's glass_packed_shared_bytes), opted in to above the
// 48 KB a block gets by default; m within 0..127 as for K5, and at most
// 65536 pixels a group for the table.
int fav_glass_resample_packed(const float* x, float* out, int batch, int g, int h, int w, int c,
                              int m, int passes, uint32_t seed_lo, uint32_t seed_hi, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || c <= 0 || passes <= 0) return 0;
  if (g <= 0 || batch % g || passes % 2) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(g) * h * w;
  const long long tile_floats = (n * c + 3 + 3) & ~3LL;
  const long long smem = 16 + tile_floats * 4 + packed_codes_bytes(n, passes) + 2 * n;
  if (smem > kOptInLimit || n > 65536) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(glass_resample_packed_kernel,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  glass_resample_packed_kernel<<<batch / g, kPackedThreads, static_cast<size_t>(smem),
                                 static_cast<cudaStream_t>(stream)>>>(
      x, out, g, h, w, c, m, passes / 2, static_cast<int>(tile_floats), seed_lo, seed_hi);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
