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
// What they compute, on an NHWC batch x (B, H, W, C) and a shift per
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
// Each comes in float32 (fav_shear_rows, fav_shear_cols) and bfloat16
// (fav_shear_rows_bf16, fav_shear_cols_bf16: the chain of
// augmix(..., bf16=True), which fav_tpu keeps in bfloat16 end to end,
// augment.py:80-82). The shift, its clip, floor and d - lo stay float32 in
// both. In bfloat16 every value the plain version rounds is rounded here as
// PyTorch rounds an elementwise bfloat16 op (computed in float32, rounded
// once to nearest even): f = bf16(d - lo), g = bf16(1 - f), each product
// bf16(g * a) and bf16(f * b), and their sum. Each of those is a
// __fmul_rn/__fsub_rn/__fadd_rn followed by __float2bfloat16_rn, so nothing
// is contracted and the kernel equals the plain version on a bfloat16 tensor
// bit for bit. The float32 kernels and bf16 K9b read and write elements as
// scalars, so any element-aligned base works (a bf16 pixel of three
// channels is 6 bytes); bf16 K9a moves 16 bytes a thread (below).
//
// Bound: bytes. At an AugMix view's chain batch, (768, 32, 32, 3), a pass
// reads the image once (9.4 MB) and writes it once (9.4 MB), plus the 98 KB
// of shifts: 0.0057 ms at 3.35 TB/s (bfloat16: 4.7 MB each way, 0.0028
// ms). Per element it does a clip (2), a floor and f (2), two index adds
// and clamps (6) and the blend (4): some 14 operations, a tenth of the
// bytes' time.
//
// Design of shear_kernel (float32 K9a and K9b, bf16 K9b): one thread per
// output pixel, all C channels of it; blocks of 256 pixels of one image
// along x of the grid and the images along y (looping when there are more
// than 65535), so every index is a 32-bit product within one image and no
// 64-bit division is made. The shift, its floor and fraction and the two
// source pixels are computed once and serve every channel. A warp covers
// 32 neighbouring pixels of one row: its stores are 32 x C consecutive
// elements, and its taps lie within the same image, which L1 and L2 hold.
//
// Design of shear_rows_bf16_kernel (bf16 K9a): at 4.7 MB each way the
// one-pixel-a-thread kernel is bound by latency, not bytes: two dependent
// round trips to memory a thread, scalar 2-byte loads and stores, three
// waves. This one copies a block's rows into shared memory with 16-byte
// cp.async copies, makes each row's shift once, blends a pixel a thread
// from shared memory into an output stage and writes that with 16-byte
// stores: one round trip in and one out, one wave of a few blocks an SM
// (augment_cuda.shear_rows_bf16_geometry). It stays just under half of the
// bound on an H100 80GB HBM3: all blocks start together, so the copies in,
// the blend and the writes out hardly overlap, and Tensor.copy_ of the
// same bytes is faster still. A second wave of smaller blocks, a persistent grid with the next
// unit's copies in flight, two parts a block and bf16x2 arithmetic (whose
// results differ from the plain version's float32 products) were each
// slower or not equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ float bf16_round(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// The blend of two taps a, b at the float32 fraction frac, with the plain
// version's roundings in the element type (inlined, so the weights are
// computed once for all channels).
__device__ __forceinline__ float blend(float frac, float a, float b) {
  const float g = __fsub_rn(1.0f, frac);
  return __fadd_rn(__fmul_rn(g, a), __fmul_rn(frac, b));
}

__device__ __forceinline__ __nv_bfloat16 blend(float frac, __nv_bfloat16 a, __nv_bfloat16 b) {
  const float f = bf16_round(frac);
  const float g = bf16_round(__fsub_rn(1.0f, f));
  const float pa = bf16_round(__fmul_rn(g, __bfloat162float(a)));
  const float pb = bf16_round(__fmul_rn(f, __bfloat162float(b)));
  return __float2bfloat16_rn(__fadd_rn(pa, pb));
}

// ROWS: shift along x by delta[b, y]; else along y by delta[b, x].
template <typename T, bool ROWS>
__global__ void shear_kernel(const T* __restrict__ x, const float* __restrict__ delta,
                             T* __restrict__ out, int batch, int h, int w, int c, int m) {
  const int hw = h * w;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= hw) return;
  const int yi = p / w;
  const int xi = p - yi * w;
  for (long long b = blockIdx.y; b < batch; b += gridDim.y) {
    float d = ROWS ? delta[b * h + yi] : delta[b * w + xi];
    d = fminf(fmaxf(d, static_cast<float>(-m)), static_cast<float>(m - 1));
    const float lo_f = floorf(d);
    const float frac = __fsub_rn(d, lo_f);
    const int lo = static_cast<int>(lo_f);
    int p0, p1;  // the two source pixels within the image
    if (ROWS) {
      p0 = yi * w + min(max(xi + lo, 0), w - 1);
      p1 = yi * w + min(max(xi + lo + 1, 0), w - 1);
    } else {
      p0 = min(max(yi + lo, 0), h - 1) * w + xi;
      p1 = min(max(yi + lo + 1, 0), h - 1) * w + xi;
    }
    const T* img = x + b * hw * c;
    T* o = out + (b * hw + p) * c;
    for (int ch = 0; ch < c; ++ch) {
      o[ch] = blend(frac, img[p0 * c + ch], img[p1 * c + ch]);
    }
  }
}

template <typename T, bool ROWS>
int launch(const T* x, const float* delta, T* out, int batch, int h, int w, int c, int m, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || c <= 0) return 0;
  const dim3 grid((h * w + kThreads - 1) / kThreads, batch < kMaxGridY ? batch : kMaxGridY);
  shear_kernel<T, ROWS><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(x, delta, out, batch, h, w, c, m);
  return static_cast<int>(cudaGetLastError());
}

// ── bf16 K9a: the rows pass over bfloat16 images ──────────────────────────
// The rows of the image batch, (B H) of them, W C values each, are cut into
// units: a block takes rows_per_block whole rows (units of consecutive rows
// are one contiguous span of memory), or, where a row is longer than a
// stage, one window of `window` output pixels of one row. A block
//   1. copies its span of x into shared memory with 16-byte cp.async copies
//      (a scalar head and tail where the span does not start or end on a
//      16-byte boundary: the stage keeps the span's 16-byte phase), and
//      meanwhile makes each row's shift once: the clip, floor, lo and the
//      blend weights f = bf16(d - lo), g = bf16(1 - f);
//   2. blends a pixel a thread, all C channels from the two staged taps,
//      into an output stage at the output span's 16-byte phase;
//   3. writes the output span with 16-byte stores, 8 outputs a thread (a
//      scalar head and tail off a 16-byte boundary).
// A window's sources are the contiguous pixels [x0 + lo, x0 + T + lo]
// clamped to the row, so a window stages at most T + 1 pixels; it reads its
// shift before its copy (two round trips; whole rows take one).
constexpr int kRowsThreads = 256;
constexpr int kRowsStage = 8192;  // bf16 values a stage holds at most (16 KB)
constexpr int kRowsMax = 512;     // rows a block takes at most

struct RowShift {
  int lo;
  float f;  // bf16(d - lo)
  float g;  // bf16(1 - f)
  int unused;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// The 16-byte phase of a bf16 pointer, in values.
__device__ __forceinline__ int phase8(const void* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 1) & 7);
}

// The plain version's blend of taps a, b (bf16 bits) with a row's weights:
// bf16(bf16(g a) + bf16(f b)), each product and the sum a float32 operation
// rounded to bf16 once; the two products round in one pair conversion.
__device__ __forceinline__ uint16_t blend_bf16(float f, float g, uint16_t a, uint16_t b) {
  const float fa = __uint_as_float(static_cast<uint32_t>(a) << 16);
  const float fb = __uint_as_float(static_cast<uint32_t>(b) << 16);
  const __nv_bfloat162 p = __floats2bfloat162_rn(__fmul_rn(g, fa), __fmul_rn(f, fb));
  return __bfloat16_as_ushort(__float2bfloat16_rn(__fadd_rn(__low2float(p), __high2float(p))));
}

__device__ __forceinline__ RowShift row_shift(float d, int m) {
  d = fminf(fmaxf(d, static_cast<float>(-m)), static_cast<float>(m - 1));
  const float lo = floorf(d);
  const float f = bf16_round(__fsub_rn(d, lo));
  return RowShift{static_cast<int>(lo), f, bf16_round(__fsub_rn(1.0f, f)), 0};
}

// CH > 0: C known at compile time (3, RGB); 0: C from `c`. window 0: units
// of rows_per_block whole rows; else units of one window of one row,
// windows_per_row a row. in_stage: the input stage's values (a multiple of 8).
template <int CH>
__global__ void __launch_bounds__(kRowsThreads)
    shear_rows_bf16_kernel(const uint16_t* __restrict__ x, const float* __restrict__ delta,
                           uint16_t* __restrict__ out, long long rows, int w, int c, int m, int rows_per_block,
                           int window, int windows_per_row, int in_stage) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ch_n = CH > 0 ? CH : c;
  const int len = w * ch_n;
  RowShift* shifts = reinterpret_cast<RowShift*>(smem);
  uint16_t* sin = reinterpret_cast<uint16_t*>(smem + sizeof(RowShift) * rows_per_block);
  uint16_t* sout = sin + in_stage;

  long long r0;
  int nr, x0, npx;
  if (window == 0) {
    r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
    nr = static_cast<int>(rows - r0 < rows_per_block ? rows - r0 : rows_per_block);
    x0 = 0;
    npx = w;
  } else {
    r0 = blockIdx.x / windows_per_row;
    x0 = (blockIdx.x - static_cast<int>(r0) * windows_per_row) * window;
    nr = 1;
    npx = min(window, w - x0);
  }
  const uint16_t* src_row = x + r0 * len;

  // 1. the stage and the shifts
  int a, in_len;  // the staged span: values [a, a + in_len) from the unit's first row on
  if (window == 0) {
    a = 0;
    in_len = nr * len;
  } else {
    if (threadIdx.x == 0) shifts[0] = row_shift(delta[r0], m);
    __syncthreads();
    const int lo = shifts[0].lo;
    const int s0 = min(max(x0 + lo, 0), w - 1);
    const int s1 = min(max(x0 + npx + lo, 0), w - 1);
    a = s0 * ch_n;
    in_len = (s1 - s0 + 1) * ch_n;
  }
  const uint16_t* src = src_row + a;
  const int pad = phase8(src);
  const int head = min((8 - pad) & 7, in_len);
  const int body = (in_len - head) >> 3;
  for (int k = threadIdx.x; k < body; k += kRowsThreads) cp_async16(sin + pad + head + 8 * k, src + head + 8 * k);
  if (window == 0) {
    for (int t = threadIdx.x; t < nr; t += kRowsThreads) shifts[t] = row_shift(delta[r0 + t], m);
  }
  for (int i = threadIdx.x; i < head; i += kRowsThreads) sin[pad + i] = src[i];
  for (int i = head + 8 * body + threadIdx.x; i < in_len; i += kRowsThreads) sin[pad + i] = src[i];
  cp_async_wait_all();
  __syncthreads();

  // 2. a pixel a thread: pixel q of the unit is pixel x0 + xq of row rl
  uint16_t* dst = out + r0 * len + x0 * ch_n;
  const int opad = phase8(dst);
  const int np = nr * npx;
  const int step_r = kRowsThreads / npx, step_x = kRowsThreads - step_r * npx;
  int rl = threadIdx.x / npx, xq = threadIdx.x - rl * npx;
  for (int q = threadIdx.x; q < np; q += kRowsThreads) {
    const RowShift s = shifts[rl];
    const int xp = x0 + xq;
    const int row = pad - a + rl * len;  // the stage index of the row's first value
    const uint16_t* t0 = sin + row + min(max(xp + s.lo, 0), w - 1) * ch_n;
    const uint16_t* t1 = sin + row + min(max(xp + s.lo + 1, 0), w - 1) * ch_n;
    uint16_t* o = sout + opad + q * ch_n;
#pragma unroll
    for (int ch = 0; ch < ch_n; ++ch) o[ch] = blend_bf16(s.f, s.g, t0[ch], t1[ch]);
    rl += step_r;
    xq += step_x;
    if (xq >= npx) {
      xq -= npx;
      ++rl;
    }
  }
  __syncthreads();

  // 3. the output span, 16 bytes a thread
  const int out_len = np * ch_n;
  const int ohead = min((8 - opad) & 7, out_len);
  const int obody = (out_len - ohead) >> 3;
  for (int k = threadIdx.x; k < obody; k += kRowsThreads)
    reinterpret_cast<uint4*>(dst + ohead)[k] = reinterpret_cast<const uint4*>(sout + opad + ohead)[k];
  for (int i = threadIdx.x; i < ohead; i += kRowsThreads) dst[i] = sout[opad + i];
  for (int i = ohead + 8 * obody + threadIdx.x; i < out_len; i += kRowsThreads) dst[i] = sout[opad + i];
}

}  // namespace

extern "C" {

const char* fav_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K9a: delta is (B, H) float32.
int fav_shear_rows(const float* x, const float* delta, float* out, int batch, int h, int w, int c, int m,
                   void* stream) {
  return launch<float, true>(x, delta, out, batch, h, w, c, m, stream);
}

// K9b: delta is (B, W) float32.
int fav_shear_cols(const float* x, const float* delta, float* out, int batch, int h, int w, int c, int m,
                   void* stream) {
  return launch<float, false>(x, delta, out, batch, h, w, c, m, stream);
}

// K9a over bfloat16 images; delta is (B, H) float32. The unit (the wrapper's
// shear_rows_bf16_geometry): window 0 and rows_per_block whole rows a
// block, at most kRowsMax; or rows_per_block 1 and windows of `window`
// pixels, fewer than w. The shared bytes follow from them: the shifts, then
// two stages (the span and its 16-byte phase, rounded up to 8 values), at
// most 48 KB; anything else returns cudaErrorInvalidValue.
int fav_shear_rows_bf16(const __nv_bfloat16* x, const float* delta, __nv_bfloat16* out, int batch, int h, int w,
                        int c, int m, int rows_per_block, int window, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || c <= 0) return 0;
  const long long rows = static_cast<long long>(batch) * h;
  const long long len = static_cast<long long>(w) * c;
  long long units, in_values, out_values;
  int windows = 0;
  if (window == 0) {
    if (rows_per_block < 1 || rows_per_block > kRowsMax) return static_cast<int>(cudaErrorInvalidValue);
    units = (rows + rows_per_block - 1) / rows_per_block;
    in_values = out_values = rows_per_block * len;
  } else {
    if (rows_per_block != 1 || window < 1 || window >= w) return static_cast<int>(cudaErrorInvalidValue);
    windows = (w + window - 1) / window;
    units = rows * windows;
    in_values = static_cast<long long>(window + 1) * c;
    out_values = static_cast<long long>(window) * c;
  }
  const long long in_stage = (in_values + 7 + 7) / 8 * 8;
  const long long out_stage = (out_values + 7 + 7) / 8 * 8;
  const long long smem = static_cast<long long>(sizeof(RowShift)) * rows_per_block + 2 * (in_stage + out_stage);
  if (in_stage > kRowsStage || out_stage > kRowsStage || smem > 48 * 1024 || units > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xs = reinterpret_cast<const uint16_t*>(x);
  auto* os = reinterpret_cast<uint16_t*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c == 3) {
    shear_rows_bf16_kernel<3><<<static_cast<int>(units), kRowsThreads, static_cast<size_t>(smem), st>>>(
        xs, delta, os, rows, w, c, m, rows_per_block, window, windows, static_cast<int>(in_stage));
  } else {
    shear_rows_bf16_kernel<0><<<static_cast<int>(units), kRowsThreads, static_cast<size_t>(smem), st>>>(
        xs, delta, os, rows, w, c, m, rows_per_block, window, windows, static_cast<int>(in_stage));
  }
  return static_cast<int>(cudaGetLastError());
}

// K9b over bfloat16 images; delta is (B, W) float32.
int fav_shear_cols_bf16(const __nv_bfloat16* x, const float* delta, __nv_bfloat16* out, int batch, int h, int w,
                        int c, int m, void* stream) {
  return launch<__nv_bfloat16, false>(x, delta, out, batch, h, w, c, m, stream);
}

}  // extern "C"
