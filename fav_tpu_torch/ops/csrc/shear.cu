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
// bit for bit. The direct kernel reads and writes elements as scalars; the
// staged kernels (bf16 K9a and K9b) copy 16 bytes a thread into shared
// memory, each span at its own 16-byte phase, and bf16 K9a writes 16 bytes
// a thread. Any element-aligned base works either way (a bf16 pixel of
// three channels is 6 bytes).
//
// Bound: bytes. At an AugMix view's chain batch, (768, 32, 32, 3), a pass
// reads the image once (9.4 MB) and writes it once (9.4 MB), plus the 98 KB
// of shifts: 0.0057 ms at 3.35 TB/s (bfloat16: 4.7 MB each way, 0.0028
// ms). Per element it does a clip (2), a floor and f (2), two index adds
// and clamps (6) and the blend (4): some 14 operations, a tenth of the
// bytes' time.
//
// Design of shear_kernel (float32 K9a and K9b; bf16 K9b where an image
// does not fit a stage): one thread per output pixel, all C
// channels of it; blocks of 256 pixels of one image along x of the grid and the images along y (looping when there are more
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
// same bytes is faster still. A second wave of smaller blocks, a persistent
// grid with the next unit's copies in flight, two parts a block and bf16x2
// arithmetic (whose results differ from the plain version's float32
// products) were each slower or not equal.
//
// Design of shear_cols_staged_kernel (bf16 K9b): the staging of bf16 K9a
// over whole images (two a block at (768, 32, 32, 3): 384 blocks, one
// wave; augment_cuda.shear_cols_geometry). A column's
// shift holds down the whole column, so a thread walks a run of rows of one
// column with its shift in registers, and each row's upper tap is the next
// row's lower one: a pixel loads one staged pixel, not two (some 14 SASS
// instructions an element against 21 for a pixel a thread). Each blended
// pixel is stored at once, so the writes overlap the blends: on an H100
// 80GB HBM3 this beat an output stage written by 16-byte stores, and two
// cp.async parts a block, a value (not a pixel) a thread, and 512- or
// 192-thread blocks were slower. An image that does not fit a stage goes
// to shear_kernel: windows of adjacent columns over all rows of a wide
// image, staged as H segments, were slower than shear_kernel at (4, 16,
// 5000, 3). float32 K9b stays on shear_kernel, which reached half of its
// bound.

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

// ── The staged kernels: bf16 K9a and bf16 K9b ────────────────────────────
// Each block copies a span of x into shared memory (the stage) with 16-byte
// cp.async copies, makes the shifts of its rows or columns once and blends
// a pixel a thread from the staged taps: one round trip in, in one wave of
// a few blocks an SM. bf16 K9a blends into an output stage that it writes
// with 16-byte stores; bf16 K9b stores each pixel as it is blended. A stage
// keeps its span's 16-byte phase, so every 16-byte copy is aligned on both
// sides and any element-aligned base works. Values are bfloat16 bits
// (uint16_t).

constexpr int kVec = 8;  // bf16 values in 16 bytes

// A row's or a column's shift: the lower tap's offset and the blend weights.
struct Shift {
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

// The 16-byte phase of p, in values.
__device__ __forceinline__ int phase16(const uint16_t* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 1) & (kVec - 1));
}

// A span of len values at p: pad values of its 16-byte phase, head values
// before its first 16-byte boundary, body 16-byte chunks, then the tail.
struct Span {
  int pad, head, body, len;
};

__device__ __forceinline__ Span span_at(const uint16_t* p, int len) {
  const int pad = phase16(p);
  const int head = min((kVec - pad) & (kVec - 1), len);
  return Span{pad, head, (len - head) >> 3, len};
}

// Stages src's span at stage[s.pad, s.pad + s.len): the body by 16-byte
// cp.async copies (stage_body), the head and tail by scalar copies
// (stage_ends), threads tid of nt sharing each.
__device__ __forceinline__ void stage_body(uint16_t* stage, const uint16_t* src, const Span& s, int tid, int nt) {
  for (int k = tid; k < s.body; k += nt) cp_async16(stage + s.pad + s.head + kVec * k, src + s.head + kVec * k);
}

__device__ __forceinline__ void stage_ends(uint16_t* stage, const uint16_t* src, const Span& s, int tid, int nt) {
  for (int i = tid; i < s.head; i += nt) stage[s.pad + i] = src[i];
  for (int i = s.head + kVec * s.body + tid; i < s.len; i += nt) stage[s.pad + i] = src[i];
}

// Writes dst[0, len) from stage[phase16(dst) + i]: 16 bytes a thread over
// the body, scalar stores for the head and tail.
__device__ __forceinline__ void store_span(uint16_t* dst, const uint16_t* stage, int len, int tid, int nt) {
  const Span s = span_at(dst, len);
  for (int k = tid; k < s.body; k += nt)
    reinterpret_cast<uint4*>(dst + s.head)[k] = reinterpret_cast<const uint4*>(stage + s.pad + s.head)[k];
  for (int i = tid; i < s.head; i += nt) dst[i] = stage[s.pad + i];
  for (int i = s.head + kVec * s.body + tid; i < len; i += nt) dst[i] = stage[s.pad + i];
}

// The plain version's blend of taps a, b (bf16 bits) with a row's weights:
// bf16(bf16(g a) + bf16(f b)), each product and the sum a float32 operation
// rounded to bf16 once; the two products round in one pair conversion.
__device__ __forceinline__ float widen(uint16_t v) { return __uint_as_float(static_cast<uint32_t>(v) << 16); }

__device__ __forceinline__ uint16_t blend_bf16(float f, float g, float fa, float fb) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(__fmul_rn(g, fa), __fmul_rn(f, fb));
  return __bfloat16_as_ushort(__float2bfloat16_rn(__fadd_rn(__low2float(p), __high2float(p))));
}

__device__ __forceinline__ uint16_t blend_bf16(float f, float g, uint16_t a, uint16_t b) {
  return blend_bf16(f, g, widen(a), widen(b));
}

__device__ __forceinline__ Shift make_shift(float d, int m) {
  d = fminf(fmaxf(d, static_cast<float>(-m)), static_cast<float>(m - 1));
  const float lo = floorf(d);
  const float f = bf16_round(__fsub_rn(d, lo));
  return Shift{static_cast<int>(lo), f, bf16_round(__fsub_rn(1.0f, f)), 0};
}

// ── bf16 K9a: the rows pass over bfloat16 images ──────────────────────────
// The rows of the image batch, (B H) of them, W C values each, are cut into
// units: a block takes rows_per_block whole rows (units of consecutive rows
// are one contiguous span of memory), or, where a row is longer than a
// stage, one window of `window` output pixels of one row. A block
//   1. copies its span of x into shared memory (stage_body, stage_ends),
//      and meanwhile makes each row's shift once;
//   2. blends a pixel a thread, all C channels from the two staged taps,
//      into an output stage at the output span's 16-byte phase;
//   3. writes the output span with 16-byte stores (store_span).
// A window's sources are the contiguous pixels [x0 + lo, x0 + T + lo]
// clamped to the row, so a window stages at most T + 1 pixels; it reads its
// shift before its copy (two round trips; whole rows take one).
constexpr int kRowsThreads = 256;
constexpr int kRowsStage = 8192;  // bf16 values a stage holds at most (16 KB)
constexpr int kRowsMax = 512;     // rows a block takes at most

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
  Shift* shifts = reinterpret_cast<Shift*>(smem);
  uint16_t* sin = reinterpret_cast<uint16_t*>(smem + sizeof(Shift) * rows_per_block);
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
    if (threadIdx.x == 0) shifts[0] = make_shift(delta[r0], m);
    __syncthreads();
    const int lo = shifts[0].lo;
    const int s0 = min(max(x0 + lo, 0), w - 1);
    const int s1 = min(max(x0 + npx + lo, 0), w - 1);
    a = s0 * ch_n;
    in_len = (s1 - s0 + 1) * ch_n;
  }
  const uint16_t* src = src_row + a;
  const Span span = span_at(src, in_len);
  stage_body(sin, src, span, threadIdx.x, kRowsThreads);
  if (window == 0) {
    for (int t = threadIdx.x; t < nr; t += kRowsThreads) shifts[t] = make_shift(delta[r0 + t], m);
  }
  stage_ends(sin, src, span, threadIdx.x, kRowsThreads);
  cp_async_wait_all();
  __syncthreads();

  // 2. a pixel a thread: pixel q of the unit is pixel x0 + xq of row rl
  uint16_t* dst = out + r0 * len + x0 * ch_n;
  const int pad = span.pad;
  const int opad = phase16(dst);
  const int np = nr * npx;
  const int step_r = kRowsThreads / npx, step_x = kRowsThreads - step_r * npx;
  int rl = threadIdx.x / npx, xq = threadIdx.x - rl * npx;
  for (int q = threadIdx.x; q < np; q += kRowsThreads) {
    const Shift s = shifts[rl];
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
  store_span(dst, sout, np * ch_n, threadIdx.x, kRowsThreads);
}

// ── bf16 K9b: the columns pass, staged ────────────────────────────────────
// A column's taps lie in its own column, so a unit needs no halo: it is
// images_per_block whole images (consecutive images are one contiguous
// span of memory, H W C values each), their images_per_block W shifts at
// most kColsMax. An image that does not fit a stage goes to shear_kernel.
// A block
//   1. copies its span into the stage (stage_body, stage_ends), and
//      meanwhile makes the shift of each of its columns once;
//   2. walks the unit's columns, a run of rows of one column a thread: the
//      shift stays in registers, and each row's upper tap (row
//      clamp(y + lo + 1)) is the next row's lower one, so a pixel loads one
//      staged pixel; each blended pixel goes straight to memory, C
//      elements at a time: a warp's stores cover one row of 32 adjacent
//      pixels, contiguous, and the writes of one warp overlap the blends
//      of the others.
constexpr int kColsThreads = 256;
constexpr int kColsStage = 8192;  // bf16 values a stage holds at most (16 KB)
constexpr int kColsMax = 1024;    // columns (shifts) a block takes at most

template <int CH>
__global__ void __launch_bounds__(kColsThreads)
    shear_cols_staged_kernel(const uint16_t* __restrict__ x, const float* __restrict__ delta,
                             uint16_t* __restrict__ out, int batch, int h, int w, int c, int m,
                             int images_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ch_n = CH > 0 ? CH : c;
  const int wc = w * ch_n;
  const int hwc = h * wc;
  Shift* shifts = reinterpret_cast<Shift*>(smem);
  uint16_t* sin = reinterpret_cast<uint16_t*>(smem + sizeof(Shift) * images_per_block * w);

  const long long b0 = static_cast<long long>(blockIdx.x) * images_per_block;
  const int ni = static_cast<int>(batch - b0 < images_per_block ? batch - b0 : images_per_block);
  const uint16_t* src = x + b0 * hwc;
  uint16_t* dst = out + b0 * hwc;
  const float* dl = delta + b0 * w;

  // 1. the stage and the shifts
  const Span span = span_at(src, ni * hwc);
  stage_body(sin, src, span, threadIdx.x, kColsThreads);
  for (int t = threadIdx.x; t < ni * w; t += kColsThreads) shifts[t] = make_shift(dl[t], m);
  stage_ends(sin, src, span, threadIdx.x, kColsThreads);
  cp_async_wait_all();
  __syncthreads();

  // 2. a run of rows of one column a thread: the unit's ni W columns
  // (image col / W, column col % W), each cut into `groups` runs of `run`
  // rows. Along a run the shift stays in registers and each row's upper
  // tap is the next row's lower one (clamp(y + 1 + lo) = clamp(y + lo +
  // 1)), so a pixel loads one tap (C = 3: the other carried widened in
  // registers).
  const int ncols = ni * w;
  const int groups = max(1, kColsThreads / ncols);
  const int run = (h + groups - 1) / groups;
  for (int k = threadIdx.x; k < groups * ncols; k += kColsThreads) {
    const int grp = k / ncols, col = k - grp * ncols;
    const int i = col / w, xq = col - i * w;
    const int y_end = min(h, (grp + 1) * run);
    const Shift s = shifts[col];
    // row r of this column: its first value in the stage, and in dst
    const uint16_t* in0 = sin + span.pad + i * hwc + xq * ch_n;
    uint16_t* out0 = dst + i * hwc + xq * ch_n;
    int y = grp * run;
    if constexpr (CH > 0) {
      float a[CH];
      const uint16_t* t0 = in0 + min(max(y + s.lo, 0), h - 1) * wc;
#pragma unroll
      for (int ch = 0; ch < CH; ++ch) a[ch] = widen(t0[ch]);
      for (; y < y_end; ++y) {
        const uint16_t* t1 = in0 + min(max(y + s.lo + 1, 0), h - 1) * wc;
        uint16_t* o = out0 + y * wc;
#pragma unroll
        for (int ch = 0; ch < CH; ++ch) {
          const float b = widen(t1[ch]);
          o[ch] = blend_bf16(s.f, s.g, a[ch], b);
          a[ch] = b;
        }
      }
    } else {
      for (; y < y_end; ++y) {
        const uint16_t* t0 = in0 + min(max(y + s.lo, 0), h - 1) * wc;
        const uint16_t* t1 = in0 + min(max(y + s.lo + 1, 0), h - 1) * wc;
        uint16_t* o = out0 + y * wc;
        for (int ch = 0; ch < ch_n; ++ch) o[ch] = blend_bf16(s.f, s.g, t0[ch], t1[ch]);
      }
    }
  }
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
  const long long smem = static_cast<long long>(sizeof(Shift)) * rows_per_block + 2 * (in_stage + out_stage);
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

// K9b over bfloat16 images; delta is (B, W) float32. The unit (the
// wrapper's augment_cuda.shear_cols_geometry): images_per_block whole
// images a block, their W shifts at most kColsMax, their span and its
// 16-byte phase within kColsStage values; or 0: the direct shear_kernel
// (an image that does not fit a stage). Anything else returns
// cudaErrorInvalidValue.
int fav_shear_cols_bf16(const __nv_bfloat16* x, const float* delta, __nv_bfloat16* out, int batch, int h, int w,
                        int c, int m, int images_per_block, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || c <= 0) return 0;
  const long long hwc = static_cast<long long>(h) * w * c;
  if (hwc > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (images_per_block == 0) return launch<__nv_bfloat16, false>(x, delta, out, batch, h, w, c, m, stream);
  const long long shifts = static_cast<long long>(images_per_block) * w;
  const long long stage = (images_per_block * hwc + 7 + 7) / 8 * 8;
  const long long units = (batch + images_per_block - 1) / images_per_block;
  const long long smem = static_cast<long long>(sizeof(Shift)) * shifts + 2 * stage;
  if (images_per_block < 1 || shifts > kColsMax || stage > kColsStage || smem > 48 * 1024 || units > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xs = reinterpret_cast<const uint16_t*>(x);
  auto* os = reinterpret_cast<uint16_t*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c == 3) {
    shear_cols_staged_kernel<3><<<static_cast<int>(units), kColsThreads, static_cast<size_t>(smem), st>>>(
        xs, delta, os, batch, h, w, c, m, images_per_block);
  } else {
    shear_cols_staged_kernel<0><<<static_cast<int>(units), kColsThreads, static_cast<size_t>(smem), st>>>(
        xs, delta, os, batch, h, w, c, m, images_per_block);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
