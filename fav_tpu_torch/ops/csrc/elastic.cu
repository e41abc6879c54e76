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

#include "bulk_copy.cuh"

namespace {

using fav::bulk_load;
using fav::bulk_store;
using fav::mbar_init;
using fav::mbar_wait;

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
// same live taps, tents, order and separate __fmul_rn/__fadd_rn, and a
// tap's source x[s, clamp(i + oy), clamp(j + ox)] of image s of the group,
// which is what the TPU kernel's padded lane s*wp + j + ox + p holds.
//
// Bound: bytes, the same as K6: the images and coordinates read once, the
// output written once (0.060 ms at (6144, 32, 32, 3) at 3.35 TB/s).
//
// Design. A GPU has no lanes to fill, so the padding and the packing buy
// nothing: the G images of a group lie contiguous in device memory, and the
// kernel holds them so in shared memory, G H W C floats (36,864 bytes at
// G = 3), the edge padding being K6's clamp of the row and column index
// inside image s. The grid is persistent: up to two blocks an SM (the
// wrapper's elastic_packed_geometry), each walking over groups blockIdx.x,
// blockIdx.x + gridDim.x, ... with a ring of two input tiles and one output
// tile. One thread fills an input tile with a single 1-D bulk copy
// (cp.async.bulk, the TMA engine) that completes on the stage's mbarrier,
// so group k + 1's copy is in flight while group k's warp is computed, and
// no thread spends an instruction per element on it. One thread per output
// pixel, in device order, so a warp's coordinates are coalesced; a thread
// loads the coordinates of up to kChunk of its pixels before it computes
// any, so it waits on device memory once a chunk and not once a pixel, and
// steps over its pixels by fixed image, row and column increments, with no
// division. The outputs go to the output tile, and one bulk copy writes the
// group back while the next group is computed, where stores straight from
// the threads would each cover a third of their sectors (a warp's C-float
// pixels lie 12 bytes apart). Each tile sits at its group's 16-byte phase
// in device memory, so the bulk copies' ends line up at any base address;
// the at most three floats before and after a 16-byte-aligned body are
// copied by plain loads and stores (bulk_copy.cuh, shared with K5).
constexpr int kChunk = 8;  // K6p: pixels a thread loads the coordinates of at once
constexpr int kPackedThreads = 512;  // K6p: threads a block
constexpr int kOptInLimit = 227 * 1024;  // the shared memory a Hopper block can opt in to

__global__ void elastic_warp_packed_kernel(const float* __restrict__ x, const float* __restrict__ ys,
                                           const float* __restrict__ xs, float* __restrict__ out,
                                           int groups, int g, int h, int w, int c, int m,
                                           int stage_floats) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // one barrier an input stage
  float* stages = reinterpret_cast<float*>(smem + 16);  // two input stages, then the output stage
  float* out_stage = stages + 2 * stage_floats;
  const int hw = h * w;
  const int n_group = g * hw;   // pixels a group
  const int len = n_group * c;  // floats a group

  if (threadIdx.x == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
  }
  __syncthreads();

  int k = blockIdx.x;  // the wrapper launches at most one block a group
  int ph = bulk_load(stages, &bars[0], x + static_cast<long long>(k) * len, len);
  __syncthreads();  // the first group's head and tail

  // thread t's first pixel of a group (image s0, row i0, column j0) and the
  // step to its next, blockDim.x pixels on
  const int t = threadIdx.x;
  const int s0 = t / hw;
  const int i0 = (t - s0 * hw) / w;
  const int j0 = t - s0 * hw - i0 * w;
  const int step = blockDim.x;
  const int ds = step / hw;
  const int di = (step - ds * hw) / w;
  const int dj = step - ds * hw - di * w;
  const int row_stride = w * c;

  for (int it = 0; k < groups; ++it, k += gridDim.x) {
    const int stage = it & 1;
    const int next = k + gridDim.x;
    int ph_next = 0;
    if (next < groups)
      ph_next = bulk_load(stages + (stage ^ 1) * stage_floats, &bars[stage ^ 1],
                           x + static_cast<long long>(next) * len, len);
    mbar_wait(&bars[stage], (it >> 1) & 1);
    if (it > 0) {
      // the previous group's bulk write has read the output stage
      if (t == 0) fav::bulk_store_wait_read();
      __syncthreads();
    }
    const float* tile = stages + stage * stage_floats + ph;
    float* dst = out + static_cast<long long>(k) * len;
    float* o = out_stage + static_cast<int>((reinterpret_cast<uintptr_t>(dst) >> 2) & 3);

    const long long first = static_cast<long long>(k) * n_group;  // the group's first pixel
    int s = s0, i = i0, j = j0;
    // the coordinates of up to kChunk of this thread's pixels are loaded
    // together, so their latency is paid once a chunk and not once a pixel
    for (int q0 = t; q0 < n_group; q0 += kChunk * step) {
      float cy[kChunk], cx[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int q = q0 + u * step;
        cy[u] = q < n_group ? ys[first + q] : 0.0f;
        cx[u] = q < n_group ? xs[first + q] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int q = q0 + u * step;
        if (q >= n_group) break;
        const Taps ty = taps(__fsub_rn(cy[u], static_cast<float>(i)), m);
        const Taps tx = taps(__fsub_rn(cx[u], static_cast<float>(j)), m);
        int row[2], col[2];
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          row[a] = (s * h + min(max(i + ty.off[a], 0), h - 1)) * row_stride;
          col[a] = min(max(j + tx.off[a], 0), w - 1) * c;
        }
        sum_taps(tile, ty, tx, row, col, c, o + q * c);
        j += dj;
        i += di;
        s += ds;
        if (j >= w) {
          j -= w;
          ++i;
        }
        if (i >= h) {
          i -= h;
          ++s;
        }
      }
    }
    // this thread's writes to the output stage, before the async proxy reads them
    fav::fence_shared_for_bulk();
    __syncthreads();  // every thread is done with this input stage and the output stage
    bulk_store(out_stage, dst, len);
    ph = ph_next;
  }
  // the last bulk write has finished before the block's shared memory goes
  if (threadIdx.x == 0) fav::bulk_store_wait_all();
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

// K6p over batch / g groups of g images: a persistent grid of `blocks`
// blocks (the wrapper's elastic_packed_geometry) of kPackedThreads threads,
// each with two barriers (16 bytes) and the kernel's fixed ring of two
// input stages and an output stage of round4(g h w c + 3) floats each in
// shared memory. Above 48 KB the launcher opts the kernel in; a geometry
// whose ring passes the 227 KB a Hopper block can have, or that the kernel
// does not take, returns cudaErrorInvalidValue.
int fav_elastic_warp_packed(const float* x, const float* ys, const float* xs, float* out, int batch,
                            int g, int h, int w, int c, int m, int blocks, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || c <= 0) return 0;
  if (g <= 0 || batch % g) return static_cast<int>(cudaErrorInvalidValue);
  const int groups = batch / g;
  const long long stage_floats = (static_cast<long long>(g) * h * w * c + 3 + 3) & ~3LL;
  const long long smem = 16 + 3 * stage_floats * 4;
  if (blocks < 1 || blocks > groups || smem > kOptInLimit) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(elastic_warp_packed_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  elastic_warp_packed_kernel<<<blocks, kPackedThreads, static_cast<size_t>(smem),
                               static_cast<cudaStream_t>(stream)>>>(
      x, ys, xs, out, groups, g, h, w, c, m, static_cast<int>(stage_floats));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
